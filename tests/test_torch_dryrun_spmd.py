"""Port parity: the dry-run over positions that own their shards
(``launch/dryrun.build_cell`` / ``run_cell(..., own_shards=True)``,
``--own-shards``): the port's counterpart of the reference's partitioned
program, whose collectives XLA's partitioner inserts.

The reference's collectives come from its compiled HLO on a (2, 4)
``jax.sharding.Mesh``: ``tests/test_torch_dryrun.py`` run as a script (its
``costs`` part, ``XLA_FLAGS=--xla_force_host_platform_device_count=8``) in
a subprocess this module starts.  The port counts on meta positions, and
on CPU positions where values are needed.

  * olmo-1b's ``train_4k`` / ``prefill_32k`` / ``decode_32k`` at full
    width on (data 2, model 4): status ok, ``own_shards`` in the record,
    the bytes a position by kind pinned beside the reference's (the kinds
    differ: the port reduce-scatters the row-parallel partials that XLA
    all-reduces), the argument bytes a position the held-once count's;
  * reduced olmo: each kind's bytes equal to a count by hand from the
    specs, forward, backward and the gradients' sums;
  * every family at ``reduced()`` on (2, 4), train, prefill and decode:
    the count on CPU and on meta equal op for op, the collective records
    included, and on CPU ``moved_bytes`` equal to what the records say
    the moves take (``collectives.received_bytes``); EP's uneven blocks at
    B = 1 raise the ``ValueError`` the reference raises;
  * the count with the host work cut (``sharding.group`` kept, the op
    trees walked by hand, live storages dropped by weak-reference
    callbacks, meta results kept by signature) equal to one with the
    plain versions of the four, at reduced and at full width;
  * the CLIs' ``--own-shards`` and ``--mesh``.

The peak of live bytes is compared with Python's cyclic collector off:
a storage held in a reference cycle goes when the collector runs, whose
timing follows the host's own allocations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._pytree import tree_flatten

from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.launch import dryrun as PD
from repro_torch.launch import hillclimb as PH
from repro_torch.launch import hlo_cost as HC
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT_S = 300
MESH = (2, 4)
POSITIONS = MESH[0] * MESH[1]
OLMO_CELLS = ["train_4k", "prefill_32k", "decode_32k"]
#: the bytes a position by kind (the reference's operand convention) that
#: the port's own-shards olmo-1b cells record on (2, 4)
OLMO_BYTES = {
    "train_4k": {"all-gather": 69_954_437_120.0,
                 "reduce-scatter": 277_948_923_904.0,
                 "all-to-all": 503_316_480.0, "all-reduce": 20.0},
    "prefill_32k": {"all-gather": 17_603_248_128.0,
                    "reduce-scatter": 137_438_953_472.0,
                    "all-to-all": 167_772_160.0},
    "decode_32k": {"all-gather": 423_428_096.0,
                   "all-to-all": 167_772_160.0,
                   "all-reduce": 16_777_216.0},
}
#: port / reference, a position's bytes: each kind both record, the
#: operand total and the ring-wire total
OLMO_RATIOS = {
    "train_4k": {"all-gather": 0.238494, "all-reduce": 2.07498e-11,
                 "total": 0.277126, "wire": 0.179614},
    "prefill_32k": {"all-gather": 0.145665, "all-reduce": 0.0,
                    "total": 1.28284, "wire": 0.429284},
    "decode_32k": {"all-gather": 0.758688, "all-reduce": 1.27279,
                   "total": 1.06422, "wire": 1.02393},
}
RATIO_RTOL = 1e-3
FAMILIES = ["olmo-1b", "llama4-scout-17b-a16e", "mamba2-2.7b",
            "zamba2-2.7b", "seamless-m4t-large-v2"]
SMALL = {"train": ShapeConfig("t", 64, 4, "train"),
         "prefill": ShapeConfig("p", 64, 4, "prefill"),
         "decode": ShapeConfig("d", 64, 4, "decode")}
KEYS = ("flops", "bytes", "ops", "by_op", "peak_live_bytes",
        "collective_bytes", "collective_wire_bytes", "collective_counts",
        "collective_bytes_by_kind", "collective_wire_bytes_by_kind")


# -- the reference's half ------------------------------------------------------


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``tests/test_torch_dryrun.py``'s ``costs`` part, started with the
    module and awaited by the first test that reads it."""
    out = tmp_path_factory.mktemp("dryrun-spmd-reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    with open(out / "costs.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "test_torch_dryrun.py"),
             str(out / "costs.json"), "costs"], env=env, cwd=str(ROOT),
            stdout=subprocess.DEVNULL, stderr=err)
    yield out, proc
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the counts on CPU positions
    are many small ops, which one thread runs faster than several, and
    parallel test workers then do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref(reference) -> dict:
    out, proc = reference
    try:
        proc.wait(timeout=REF_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the reference's costs ran past {REF_TIMEOUT_S} s")
    if proc.returncode != 0:
        pytest.fail("the reference's costs failed:\n"
                    + (out / "costs.err").read_text()[-4000:])
    return json.loads((out / "costs.json").read_text())


# -- helpers -------------------------------------------------------------------


def _reduced(arch: str) -> dict:
    """``configs.reduced`` as ``build_cell`` overrides."""
    full = configs.get_config(arch)
    red = configs.reduced(full)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


def _mesh(device: str):
    return make_local_mesh(*MESH, devices=[device] * POSITIONS)


@contextlib.contextmanager
def _no_cyclic_gc():
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _count(fn, args, mode_cls=HC.CostMode, memo=True):
    """(summary, records, bytes moved across positions) of ``fn(*args)``."""
    with _no_cyclic_gc():
        moved = C.moved_bytes()
        with mode_cls(held=args, memo=memo) as mode:
            fn(*args)
        moved = C.moved_bytes() - moved
    return mode.summary(), mode.records, moved


def _cell(arch, kind, device, **kw):
    return PD.build_cell(arch, SMALL[kind], _mesh(device),
                         overrides=_reduced(arch), own_shards=True, **kw)


# -- olmo-1b at full width beside the reference -----------------------------------


@pytest.mark.parametrize("shape", OLMO_CELLS)
def test_olmo_collectives_by_kind_beside_the_reference(reference, shape):
    """``run_cell`` over own shards on (2, 4) meta positions: status ok,
    ``own_shards`` true, the bytes a position by kind the pinned
    counts, and each ratio to the reference's HLO pinned (a kind one side
    lacks is 0 there); the argument bytes a position equal to the
    held-once cell's (a position's shards by the specs)."""
    rec = PD.run_cell("olmo-1b", shape, own_shards=True,
                      mesh=PD.meta_mesh("2x4"))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["own_shards"] is True and rec["mesh"] == "2x4"
    assert rec["devices"] == ["meta"] and rec["n_chips"] == POSITIONS
    got = rec["collective_bytes_by_kind"]
    assert got == OLMO_BYTES[shape]
    assert rec["collective_bytes_per_chip"] == sum(got.values())
    assert rec["collective_s"] > 0
    want = _ref(reference)[f"olmo-1b/{shape}"]
    ratios = {k: got.get(k, 0.0) / want["collective_bytes_by_kind"][k]
              for k in ("all-gather", "all-reduce")}
    ratios["total"] = (rec["collective_bytes_per_chip"]
                       / want["collective_bytes"])
    ratios["wire"] = (rec["collective_wire_bytes_per_chip"]
                      / want["collective_wire_bytes"])
    for k, r in OLMO_RATIOS[shape].items():
        assert ratios[k] == pytest.approx(r, rel=RATIO_RTOL, abs=1e-14), \
            (k, ratios[k])
    # the reference's kinds: XLA all-reduces, the port reduce-scatters
    assert "reduce-scatter" not in want["collective_bytes_by_kind"]
    mesh = PD.meta_mesh("2x4")
    _, args, *_, specs = PD.build_cell("olmo-1b", shape, mesh)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == sum(
        PD.position_bytes(a, s, mesh) for a, s in zip(args, specs))


# -- reduced olmo by hand --------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_olmo_kinds_by_hand(kind):
    """Reduced olmo (2 layers, d_model 64, 4 heads: ``tp``) on (2, 4) meta
    positions, 4 x 64 tokens: every parameter is under the size floor,
    so held whole at every position, and each data position holds b = 2
    rows.  The hidden spec splits d_model over ``model`` (a piece [b, S,
    D/4]); a norm needs d_model whole, so each layer all-gathers its
    input twice (attention, MLP) and the loss once more; the attention's
    output projection is row-parallel (each position its own heads) and
    reduce-scatters its f32 partials onto the d_model split; the MLP's
    weights are whole, so it runs whole on each position's rows.  The
    loss all-gathers each position's (max, sumexp, target) triple of its
    vocabulary block over ``model`` and sums its (nll, count) pair over
    ``data``.  Backward runs the transposes, and the step sums every
    gradient over all 8 positions and the global norm's square.  Bytes a
    position: all-gather r / g, reduce-scatter r g, all-reduce r."""
    fn, args, cfg, shape, splan, specs = _cell("olmo-1b", kind, "meta")
    assert splan.attn_mode == "tp"
    params = args[0]["params"] if kind == "train" else args[0]
    assert all(x.spec == SH.P(*([None] * x.ndim))
               for x in tree_leaves(params))
    cost, _, _ = _count(fn, args)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    b, S, g = SMALL[kind].global_batch // MESH[0], SMALL[kind].seq_len, 4
    bf16, f32 = 2, 4
    if kind == "decode":
        # d_model whole at decode: the output projection's partials summed
        # over model each layer, the last rows gathered for the head
        want = {"all-reduce": L * b * D * f32,
                "all-gather": b * D * bf16 // g}
    elif kind == "prefill":
        want = {"all-gather": 2 * L * b * S * D * bf16 // g
                + b * D * bf16 // g,                      # the last rows
                "reduce-scatter": L * b * S * (D // g) * f32 * g}
    else:
        whole, tri = b * S * D * bf16, g * 3 * b * S * f32
        grads = sum(x.first.numel() * x.first.element_size()
                    for x in tree_leaves(params))
        want = {
            # forward: 2L + 1 whole-d gathers and the triples; backward:
            # the transposes of the 2L reduce-scatters (f32)
            "all-gather": (2 * L + 1) * whole // g + tri // g
            + L * b * S * D * f32 // g,
            # forward: the L out-projections; backward: the transposes of
            # the 2L + 1 gathers and of the triples' gather
            "reduce-scatter": L * b * S * (D // g) * f32 * g
            + (2 * L + 1) * b * S * (D // g) * bf16 * g + tri // g * g,
            # the (nll, count) pair and its transpose, every gradient, the
            # global norm's square
            "all-reduce": 2 * 2 * f32 + grads + f32,
        }
        assert V % g == 0
    got = {k: v / POSITIONS for k, v in
           cost["collective_bytes_by_kind"].items()}
    assert got == want


# -- every family: CPU against meta, moved against recorded ------------------------


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_count_cpu_and_meta_equal_and_moves_as_recorded(arch, kind):
    """Each family at ``reduced()`` on (2, 4), over own shards (Adafactor
    for llama4-scout, as ``ADAFACTOR_ARCHS`` says): the count on CPU
    positions (seeded values) and on meta positions equal op for op,
    FLOPs, bytes, the peak of live bytes and the collective records
    included; on CPU the bytes the moves copied across positions equal
    the sum over the records of ``received_bytes``."""
    cpu, recs, moved = _count(*_cell(arch, kind, "cpu")[:2])
    meta, meta_recs, _ = _count(*_cell(arch, kind, "meta")[:2])
    assert (cpu["devices"], meta["devices"]) == (["cpu"], ["meta"])
    for k in KEYS:
        assert cpu[k] == meta[k], k
    assert recs == meta_recs and recs
    assert moved == sum(C.received_bytes(*r) for r in recs)
    assert cpu["flops"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_ep_uneven_blocks_raise_as_the_reference_does(kind):
    """B = 1 over data 2: EP's blocks raise ``ValueError`` over own
    shards too, as the reference's ``shard_map`` does (pinned against the
    reference in ``tests/test_torch_lm_mesh.py::
    test_uneven_blocks_raise_in_both_packages``); ``run_cell`` records
    it as a failed cell."""
    arch = "llama4-scout-17b-a16e"
    shape = dataclasses.replace(SMALL[kind], global_batch=1)
    fn, args, *_ = PD.build_cell(arch, shape, _mesh("meta"),
                                 overrides=_reduced(arch), own_shards=True)
    with pytest.raises(ValueError, match="evenly"):
        HC.analyze(fn, *args)
    rec = PD.run_cell(arch, shape, overrides=_reduced(arch),
                      own_shards=True, mesh=_mesh("meta"))
    assert rec["status"] == "failed" and rec["shape"] == shape.name
    assert rec["error"].startswith("ValueError: expert parallelism")


def test_received_bytes_rule():
    """A member's bytes from the others, from a record: (g - 1) / g of the
    result for all-gather and all-to-all, g - 1 slices for reduce-scatter
    and a psum's fold, the result at every member but the source for a
    broadcast."""
    r, g, m = 1024, 4, 8
    assert C.received_bytes("all-gather", r, g, m) == m * 768
    assert C.received_bytes("all-to-all", r, g, m) == m * 768
    assert C.received_bytes("reduce-scatter", r, g, m) == m * 3072
    assert C.received_bytes("all-reduce", r, g, m) == m * 3072
    assert C.received_bytes("collective-permute", r, g, m) == 2 * 3 * r
    with pytest.raises(ValueError):
        C.received_bytes("broadcast", r, g, m)
    # a broadcast on CPU positions: each group's 3 other members copy it
    x = SH.shard_tensor(torch.arange(16.0).reshape(4, 4), _mesh("cpu"),
                        SH.P("data", None))
    moved = C.moved_bytes()
    C.broadcast(x, ("model",))
    assert C.moved_bytes() - moved == C.received_bytes(
        "collective-permute", 2 * 4 * 4, 4, POSITIONS)


# -- the host work cut ----------------------------------------------------------------


def _plain_tensors(tree):
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, SH.Sharded):
            out.extend(t.pieces.values())
    return out


class _PlainMode(HC.CostMode):
    """The live storages as the counter first kept them: each storage a
    ``StorageWeakRef``, and every live one swept for expiry whenever the
    total might set a new peak."""

    def _made(self, outs):
        for t in outs:
            s = t.untyped_storage()
            k = s._cdata
            if k in self._held:
                continue
            entry = self._live.get(k)
            if entry is not None:
                if not entry[0].expired():
                    continue
                self._live_bytes -= entry[1]
            self._live[k] = (StorageWeakRef(s), s.nbytes())
            self._live_bytes += s.nbytes()
        if self._held_bytes + self._live_bytes > self.peak_live_bytes:
            for k in [k for k, (ref, _) in self._live.items()
                      if ref.expired()]:
                self._live_bytes -= self._live.pop(k)[1]
            self.peak_live_bytes = max(self.peak_live_bytes,
                                       self._held_bytes + self._live_bytes)


@pytest.mark.parametrize("arch,kind", [("olmo-1b", "train"),
                                       ("llama4-scout-17b-a16e", "prefill"),
                                       ("zamba2-2.7b", "decode"),
                                       ("olmo-1b", "decode_32k")])
def test_count_with_host_work_cut_equals_the_plain_count(monkeypatch, arch,
                                                         kind):
    """The four cuts (``sharding.group`` kept per position and axes,
    ``hlo_cost._tensors``' own walk, live storages dropped by callbacks,
    meta results kept by signature) change nothing: every key of the
    count and every record equal to the count with ``np.ndindex`` at
    every call, ``torch.utils._pytree``, a sweep of the live storages and
    every meta kernel run."""
    def cell():
        if kind in SMALL:
            return _cell(arch, kind, "meta")[:2]
        return PD.build_cell(arch, kind, _mesh("meta"),
                             own_shards=True)[:2]     # full width

    cut = _count(*cell())
    monkeypatch.setattr(SH, "_group", SH._group.__wrapped__)
    monkeypatch.setattr(HC, "_tensors", _plain_tensors)
    plain = _count(*cell(), mode_cls=_PlainMode, memo=False)
    for k in KEYS + ("devices", "ops_by_device"):
        assert cut[0][k] == plain[0][k], k
    assert cut[1] == plain[1]


def test_group_is_the_enumeration():
    """``group`` against a plain enumeration on (2, 4) and (2, 2, 2): for
    every position and set of axes, the positions that differ only along
    those axes, in the order of their index over them."""
    import itertools

    import numpy as np
    for mesh in (_mesh("meta"), PD.meta_mesh("2x2x2")):
        names = mesh.axis_names
        every = [tuple(int(i) for i in q)
                 for q in np.ndindex(*mesh.devices.shape)]
        for pos in every:
            for n in range(len(names) + 1):
                for axes in itertools.combinations(names, n):
                    keep = [i for i, a in enumerate(names) if a not in axes]
                    want = sorted((q for q in every
                                   if all(q[i] == pos[i] for i in keep)),
                                  key=lambda q: SH.coord(mesh, q, axes))
                    assert list(SH.group(mesh, pos, axes)) == want


# -- the CLIs ----------------------------------------------------------------------


def test_dryrun_cli_own_shards_and_mesh(tmp_path, capsys):
    """``--own-shards --mesh 2x4``: the record says so and holds the
    moves; the default on the same mesh records none (held once)."""
    out = tmp_path / "d.jsonl"
    for extra in (["--own-shards"], []):
        assert PD.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                        "--mesh", "2x4", "--out", str(out)] + extra) == 0
    own, held = [json.loads(x) for x in out.read_text().splitlines()]
    assert (own["own_shards"], held["own_shards"]) == (True, False)
    assert own["mesh"] == held["mesh"] == "2x4"
    assert own["collective_bytes_by_kind"] == OLMO_BYTES["decode_32k"]
    assert held["collective_bytes_per_chip"] == 0.0
    assert own["flops_per_chip"] == held["flops_per_chip"]
    assert own["memory_analysis"]["argument_size_in_bytes"] == \
        held["memory_analysis"]["argument_size_in_bytes"]
    capsys.readouterr()
    mesh = PD.meta_mesh("2x2x2")
    assert mesh.axis_names == ("pod", "data", "model")
    for bad in ("8", "2x0", "1x2x3x4"):
        with pytest.raises(ValueError):
            PD.meta_mesh(bad)


def test_hillclimb_cli_own_shards_shows_the_collective_term(capsys):
    assert PH.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                    "--own-shards", "--mesh", "2x4", "--tag", "own"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert '"own_shards": true' in out[0]
    last = out[-1]
    assert last.startswith("[own] compute=") and "collective=" in last
    assert float(last.split("collective=")[1].split("s")[0]) > 0
