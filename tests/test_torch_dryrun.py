"""Port parity: the dry-run tools (``repro_torch.launch.{dryrun,hillclimb,
hlo_cost}``, ``roofline.model_flops`` / ``CollectiveStats``,
``registry.input_specs``, ``trainer.state_shapes``, ``mesh.H100``).

The reference lowers and compiles each cell on forced host devices and
counts its HLO; the port runs the cell's step once on meta tensors under a
dispatch counter.  The reference's compiled cells need eight host devices,
so they run in a subprocess (this file run as a script with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``), on a
``jax.sharding.Mesh`` (Auto axes): its own production mesh fails (pinned
below, in a second subprocess, with the 512 devices its dry-run forces).

  * model FLOPs, the skip rules, ``input_specs`` and ``state_shapes``
    against the reference's, exactly (int64 token ids aside);
  * counted FLOPs within 1e-3 of the reference's HLO count x 8 on a
    (data 2, model 4) mesh for olmo-1b's decode / prefill / train cells
    and llama4-scout's decode cell, and the argument bytes a position
    equal to the reference's compiled ones plus the int64 tokens' share;
  * the collective record: EP prefill's all_to_all (forward and its
    backward transpose), EP decode's psum, the compressed step's cross-pod
    all-reduce, each against a count by hand; the partitioner's
    collectives have no counterpart (pinned);
  * the count the same on CPU and meta tensors op for op;
  * the mode changes no result; the CLIs' records and side effects.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT_S = 300
SCOUT = "llama4-scout-17b-a16e"
ARCHS = ["yi-34b", "olmo-1b", "qwen2-7b", "minitron-4b", "mamba2-2.7b",
         SCOUT, "llama4-maverick-400b-a17b", "seamless-m4t-large-v2",
         "zamba2-2.7b", "chameleon-34b"]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: the cells counted against the reference's compiled HLO on (2, 4)
COST_CELLS = [("olmo-1b", "decode_32k"), ("olmo-1b", "prefill_32k"),
              ("olmo-1b", "train_4k"), (SCOUT, "decode_32k")]
FLOPS_RTOL = 1e-3


# -- the reference's half (run as a script) -------------------------------------


def _reference_costs(out_path: str) -> None:
    """The reference's COST_CELLS lowered and compiled on a (2, 4)
    ``jax.sharding.Mesh``: ``hlo_cost.analyze`` of the compiled HLO and
    the compiled argument bytes."""
    import jax
    from jax.sharding import Mesh as JMesh

    assert len(jax.devices()) >= 8        # before the import below sets 512
    from repro.launch import dryrun as D
    from repro.launch import hlo_cost as H

    mesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4),
                 ("data", "model"))
    out = {}
    for arch, shape in COST_CELLS:
        fn, args, *_ = D.build_lowerable(arch, shape, mesh)
        with mesh:
            compiled = jax.jit(fn).lower(*args).compile()
        cost = H.analyze(compiled.as_text())
        out[f"{arch}/{shape}"] = {
            "flops": cost["flops"],
            "collective_bytes": cost["collective_bytes"],
            "argument_size_in_bytes":
                compiled.memory_analysis().argument_size_in_bytes}
    Path(out_path).write_text(json.dumps(out))


def _reference_own_mesh(out_path: str) -> None:
    """The reference's own ``run_cell`` on its production mesh (512 forced
    host devices, as its dry-run sets them before jax starts)."""
    from repro.launch import dryrun as D
    rec = D.run_cell("olmo-1b", "decode_32k")
    Path(out_path).write_text(json.dumps(
        {k: rec.get(k) for k in ("status", "error")}))


if __name__ == "__main__":
    {"costs": _reference_costs,
     "own-mesh": _reference_own_mesh}[sys.argv[2]](sys.argv[1])
    sys.exit(0)


# -- the port's half ----------------------------------------------------------

import jax  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.dist import collectives as COLL  # noqa: E402
from repro_torch.dist.sharding import (NamedSharding, make_plan,  # noqa: E402
                                       param_specs)
from repro_torch.launch import dryrun as PD  # noqa: E402
from repro_torch.launch import hillclimb as PH  # noqa: E402
from repro_torch.launch import hlo_cost as HC  # noqa: E402
from repro_torch.launch import roofline as PR  # noqa: E402
from repro_torch.launch.mesh import (H100, make_local_mesh,  # noqa: E402
                                     make_position_mesh)
from repro_torch.models import get_bundle  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import input_specs  # noqa: E402
from repro_torch.train.data import batch_for  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         make_optimizer)
from repro_torch.train.trainer import (jit_train_step,  # noqa: E402
                                       make_train_step, state_shapes)
from repro_torch.train.tree import (tree_flatten_with_path,  # noqa: E402
                                    tree_leaves, tree_map, tree_unflatten)

PARTS = ("costs", "own-mesh")


@pytest.fixture(scope="module", autouse=True)
def _reference_procs(tmp_path_factory):
    """The reference's two parts, started as the module's tests start."""
    out = tmp_path_factory.mktemp("dryrun-reference")
    base = dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join(
                    [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    base.pop("XLA_FLAGS", None)
    envs = {"costs": dict(
        base, XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        "own-mesh": base}
    procs = {}
    for part in PARTS:
        with open(out / f"{part}.err", "w") as err:
            procs[part] = subprocess.Popen(
                [sys.executable, __file__, str(out / f"{part}.json"), part],
                env=envs[part], cwd=str(ROOT), stdout=subprocess.DEVNULL,
                stderr=err)
    yield out, procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _ref(_reference_procs, part: str) -> dict:
    """One part's results; a failure or timeout fails the test."""
    out, procs = _reference_procs
    try:
        procs[part].wait(timeout=REF_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the reference's {part} ran past {REF_TIMEOUT_S} s")
    if procs[part].returncode != 0:
        pytest.fail(f"the reference's {part} failed:\n"
                    + (out / f"{part}.err").read_text()[-4000:])
    return json.loads((out / f"{part}.json").read_text())


@contextlib.contextmanager
def _xla_flags_kept():
    """Importing ``repro.launch.dryrun`` prepends a 512-device override to
    ``XLA_FLAGS``; keep this process's (and its children's) flags."""
    was = os.environ.get("XLA_FLAGS")
    try:
        yield
    finally:
        if was is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = was


def _jdryrun():
    with _xla_flags_kept():
        from repro.launch import dryrun
    return dryrun


# -- model FLOPs, skip rules, specs, state shapes --------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    from repro import configs as jconfigs
    from repro.launch import roofline as JR
    for name in SHAPE_NAMES:
        got = PR.model_flops(configs.get_config(arch), configs.SHAPES[name])
        want = JR.model_flops(jconfigs.get_config(arch),
                              jconfigs.SHAPES[name])
        assert got == want and isinstance(got, float), (name, got, want)


def test_skip_rules_equal_reference():
    jd = _jdryrun()
    assert PD.LONG_OK == jd.LONG_OK
    assert PD.ADAFACTOR_ARCHS == jd.ADAFACTOR_ARCHS
    for arch in ARCHS:
        for name in SHAPE_NAMES:
            assert PD.cell_skip_reason(arch, name) == \
                jd.cell_skip_reason(arch, name)


def _shape_tree(tree) -> dict:
    """path -> (shape, dtype name) of a torch tree."""
    return {"/".join(p): (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in tree_flatten_with_path(tree)}


def _jshape_tree(tree) -> dict:
    """path -> (shape, dtype name) of a jax ShapeDtypeStruct tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(s.shape), str(s.dtype)) for path, s in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Every shape's inputs: the reference's shapes, on meta; dtypes equal
    but for the token ids (int64 in the port, int32 there)."""
    from repro import configs as jconfigs
    from repro.models.registry import input_specs as jinput_specs
    for name in SHAPE_NAMES:
        got = input_specs(configs.get_config(arch), configs.SHAPES[name])
        want = _jshape_tree(jinput_specs(jconfigs.get_config(arch),
                                         jconfigs.SHAPES[name]))
        assert all(t.device.type == "meta" for t in tree_leaves(got))
        got = _shape_tree(got)
        assert got.keys() == want.keys()
        for k, (shape, dt) in got.items():
            ids = k in ("tokens", "labels", "token")
            assert (shape, dt) == (want[k][0], "int64" if ids
                                   else want[k][1]), (name, k)
            assert not ids or want[k][1] == "int32"


@pytest.mark.parametrize("arch", ["olmo-1b", SCOUT])
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_state_shapes_match_reference(arch, opt_name):
    from repro import configs as jconfigs
    from repro.train import optimizer as JO
    from repro.train.trainer import state_shapes as jstate_shapes
    got = state_shapes(configs.get_config(arch),
                       make_optimizer(OptimizerConfig(name=opt_name)))
    want = jstate_shapes(jconfigs.get_config(arch),
                         JO.make_optimizer(JO.OptimizerConfig(name=opt_name)))
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert _shape_tree(got) == _jshape_tree(want)


def test_h100_table():
    assert H100 == {"peak_flops_bf16": 989.4e12, "hbm_bandwidth": 3.35e12,
                    "ici_bandwidth": 450e9, "hbm_bytes": 80e9}
    terms = PR.roofline_terms(flops_per_chip=989.4e12, bytes_per_chip=0.0,
                              coll_bytes_per_chip=0.0, peak=H100)
    assert terms["compute_s"] == 1.0 and terms["dominant"] == "compute_s"


# -- counted costs against the reference's HLO ---------------------------------------


def _port_cell(arch: str, shape: str):
    mesh = make_local_mesh(2, 4, devices=["meta"] * 8)
    fn, args, cfg, sh, splan, specs = PD.build_cell(arch, shape, mesh)
    return HC.analyze(fn, *args), args, specs, mesh


@pytest.mark.parametrize("arch,shape", COST_CELLS)
def test_counted_flops_and_argument_bytes_match_reference(
        _reference_procs, arch, shape):
    """FLOPs within 1e-3 of the reference's per-chip HLO count x 8 (the
    EP decode's masked sum is a product there, an elementwise sum here:
    1.3e-4 off), and a position's argument bytes the reference's compiled
    ones plus the int64 token ids' extra 4 bytes each."""
    want = _ref(_reference_procs, "costs")[f"{arch}/{shape}"]
    cost, args, specs, mesh = _port_cell(arch, shape)
    assert cost["devices"] == ["meta"]
    assert cost["flops"] == pytest.approx(8 * want["flops"], rel=FLOPS_RTOL)
    # the last argument is the token ids: the decode token, or the batch
    assert all(t.dtype == torch.int64 for t in tree_leaves(args[-1]))
    ids_pos = PD.position_bytes(args[-1], specs[-1], mesh)
    got = sum(PD.position_bytes(a, s, mesh) for a, s in zip(args, specs))
    assert got == want["argument_size_in_bytes"] + ids_pos // 2
    if (arch, shape) == ("olmo-1b", "decode_32k"):
        assert got - want["argument_size_in_bytes"] == 256


def test_partitioner_collectives_have_no_counterpart(_reference_procs):
    """The reference's olmo-1b train_4k moves ~1.26e12 collective bytes a
    chip on (2, 4), all inserted by XLA's partitioner; the port performs
    none of them (only EP and cross-pod exchanges are recorded)."""
    want = _ref(_reference_procs, "costs")["olmo-1b/train_4k"]
    assert want["collective_bytes"] > 1e12
    cost, *_ = _port_cell("olmo-1b", "train_4k")
    assert cost["collective_bytes"] == 0.0 and not cost["collective_counts"]


def test_reference_run_cell_fails_on_its_own_mesh_and_the_port_runs(
        _reference_procs):
    """Pinned: the reference's ``run_cell`` on its own production mesh
    (``jax.make_mesh``: Explicit axes under this jax) fails at the
    embedding gather; the port's counts the same cell on meta."""
    want = _ref(_reference_procs, "own-mesh")
    assert want["status"] == "failed"
    assert "ShardingTypeError" in want["error"]
    rec = PD.run_cell("olmo-1b", "decode_32k")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == ["meta"] and rec["n_chips"] == 256
    for k in ("compute_s", "memory_s", "collective_s", "dominant",
              "step_s_lower_bound", "roofline_fraction", "trace_s"):
        assert k in rec


# -- the counter ------------------------------------------------------------------


def test_analyze_counts_products_bytes_backward_and_live_bytes():
    """One product and its backward, by hand: FLOPs 2 m n k forward and
    twice that backward; bytes operands + results of every non-view op;
    the peak of live bytes at least the arguments and the result."""
    m, k, n = 8, 16, 4
    a = torch.randn(m, k, requires_grad=True)
    b = torch.randn(k, n)

    def step(a, b):
        y = a @ b
        torch.autograd.grad(y.sum(), a)

    cost = HC.analyze(step, a, b)
    assert cost["flops"] == 2 * m * n * k * 2      # y = ab and dA = dY bT
    assert cost["by_op"]["mm"] == {"count": 2, "bytes": 4 * (
        m * k + k * n + m * n + m * n + k * n + m * k), "flops": cost["flops"]}
    args = 4 * (m * k + k * n)
    assert cost["peak_live_bytes"] >= args + 4 * m * n
    assert cost["bytes"] >= cost["by_op"]["mm"]["bytes"]
    views = [op for op in cost["by_op"] if op in ("t", "view", "expand")]
    assert views and all(cost["by_op"][op]["bytes"] == 0 for op in views)
    assert cost["devices"] == ["cpu"]


def test_a_gather_reads_only_what_it_gathers():
    """A gather by 8 indices: its bytes are the indices, the smaller of
    its source and its result (read), and its result (written)."""
    idx = torch.tensor([3, 1, 4, 1, 5, 9, 2, 6])
    for rows, read in ((1000, 8 * 64 * 4), (4, 4 * 64 * 4)):
        table = torch.randn(rows, 64)
        for fn in (lambda t, i: t[i],
                   lambda t, i: torch.index_select(t, 0, i),
                   lambda t, i: torch.nn.functional.embedding(i, t)):
            cost = HC.analyze(fn, table, idx % rows)
            assert cost["bytes"] == 8 * 8 + read + 8 * 64 * 4
    table = torch.randn(1000, 64)
    # a scatter into the table counts it whole (read and written)
    cost = HC.analyze(lambda t, i: t.index_put_((i,), torch.ones(8, 64)),
                      table.clone(), idx)
    assert cost["by_op"]["index_put_"]["bytes"] == 2 * 1000 * 64 * 4 + \
        8 * 8 + 8 * 64 * 4


def test_collective_kinds_follow_the_reference_conventions():
    mode = HC.CostMode()
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        mode.collective(kind, 1024, 4, 8)
    c = mode.collectives
    assert c.bytes_by_kind == {"all-gather": 8 * 256, "all-reduce": 8 * 1024,
                               "reduce-scatter": 8 * 4096,
                               "all-to-all": 8 * 1024,
                               "collective-permute": 8 * 1024}
    assert c.wire_bytes_by_kind == {"all-gather": 8 * 768,
                                    "all-reduce": 8 * 1536,
                                    "reduce-scatter": 8 * 3072,
                                    "all-to-all": 8 * 768,
                                    "collective-permute": 8 * 1024}
    assert c.total_count == 40
    with pytest.raises(ValueError):
        mode.collective("broadcast", 1, 1, 1)
    # outside analyze the recorder does nothing; inside, the mode records
    assert not COLL.recording()
    COLL.record_collective("all-reduce", 1, group=1, members=1)
    with HC.CostMode() as mode:
        assert COLL.recording()
        COLL.record_collective("all-reduce", 1024, group=4, members=8)
    assert not COLL.recording()
    assert mode.collectives.bytes_by_kind == {"all-reduce": 8 * 1024}


def _scout_moe():
    cfg = configs.reduced(configs.get_config(SCOUT))
    params = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.float32, device="cpu")
    return cfg, tree_map(lambda t: t[0], params["blocks"]["p0"]["moe"])


def test_ep_prefill_records_its_all_to_alls():
    """(2, 4) CPU positions, 2 x 16 tokens: 8 blocks of 4, ``cap_src`` 1.
    Each exchange moves every block's [E, cap_src, D] f32 buffer; the
    layer runs two (there and back), and its backward their two
    transposes."""
    cfg, moe = _scout_moe()
    splan = make_plan(cfg, make_position_mesh((("data", 2), ("model", 4)),
                                              "cpu"))
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    cap = L.ep_capacity(cfg, splan, x)
    per_block = cfg.num_experts * cap * cfg.d_model * 4
    cost = HC.analyze(L.apply_moe, cfg, moe, x, splan=splan)
    assert cap == 1
    assert cost["collective_counts"] == {"all-to-all": 2 * 8}
    assert cost["collective_bytes_by_kind"] == {"all-to-all":
                                                2 * 8 * per_block}
    assert cost["collective_wire_bytes"] == 2 * 8 * per_block * 3 // 4

    def with_backward(x):
        y = L.apply_moe(cfg, moe, x, splan=splan)
        torch.autograd.grad(y.sum(), x)

    cost = HC.analyze(with_backward, x.clone().requires_grad_())
    assert cost["collective_bytes_by_kind"] == {"all-to-all":
                                                4 * 8 * per_block}
    # one block (no mesh): no exchange
    assert HC.analyze(L.apply_moe, cfg, moe, x)["collective_counts"] == {}


def test_ep_decode_records_its_psum():
    """Every position's [tokens on its data block, D] output summed over
    the 4 model positions: B = 2 over data 2, one token each."""
    cfg, moe = _scout_moe()
    assert cfg.moe_decode_ep
    splan = make_plan(cfg, make_position_mesh((("data", 2), ("model", 4)),
                                              "cpu"), decode_batch=2)
    x = torch.randn(2, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    cost = HC.analyze(L.moe_decode, cfg, moe, x, splan=splan)
    r = 1 * cfg.d_model * 4
    assert cost["collective_counts"] == {"all-reduce": 8}
    assert cost["collective_bytes"] == 8 * r
    assert cost["collective_wire_bytes"] == 8 * (2 * r * 3 // 4)
    # a batch replicated over data (decode_batch 1 < 2): every position
    # sums all tokens
    splan1 = make_plan(cfg, splan.mesh, decode_batch=1)
    cost1 = HC.analyze(L.moe_decode, cfg, moe, x[:1], splan=splan1)
    assert cost1["collective_bytes"] == 8 * r
    assert HC.analyze(L.moe_decode, cfg, moe, x)["collective_counts"] == {}


def test_compressed_step_records_the_crosspod_all_reduce():
    """One compressed step on (pod 2, data 2, model 2): an all-reduce over
    ``pod`` of every floating gradient, each position its shard of the
    int8 levels (sized from the placement's index slices) and a 4-byte
    scale; the uncompressed step records none."""
    cfg = configs.reduced(configs.get_config("olmo-1b"))
    mesh = make_position_mesh((("pod", 2), ("data", 2), ("model", 2)),
                              "cpu")
    opt = make_optimizer(OptimizerConfig())
    state = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(3),
                                 dtype=torch.float32, device="cpu")
    state = {"params": state, "opt": opt.init(state),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = batch_for(cfg, configs.ShapeConfig("t", 16, 4, "train"), 0,
                      seed=0)
    step = make_train_step(cfg, opt, make_plan(cfg, mesh),
                           grad_compress=True)
    cost = HC.analyze(step, state, batch)
    want_bytes = 0
    leaves = tree_leaves(state["params"])
    for t, spec in zip(leaves, tree_leaves(tree_map(
            lambda s: (s,), param_specs(state["params"], mesh)))):
        idx = NamedSharding(mesh, spec[0]).devices_indices_map(t.shape)
        for sl in idx.values():
            want_bytes += t[sl].numel() + 4
    assert cost["collective_counts"] == {"all-reduce": 8 * len(leaves)}
    assert cost["collective_bytes"] == want_bytes
    plain = make_train_step(cfg, opt, make_plan(cfg, mesh))
    assert HC.analyze(plain, state, batch)["collective_counts"] == {}


def test_the_mode_changes_no_result():
    """EP prefill with its backward and a compressed train step, each run
    with and without the counter: bit for bit."""
    cfg, moe = _scout_moe()
    splan = make_plan(cfg, make_position_mesh((("data", 2), ("model", 4)),
                                              "cpu"))
    x0 = torch.randn(2, 16, cfg.d_model,
                     generator=torch.Generator().manual_seed(4))

    def run():
        x = x0.clone().requires_grad_()
        y = L.apply_moe(cfg, moe, x, splan=splan)
        return y.detach(), torch.autograd.grad((y * y).sum(), x)[0]

    plain = run()
    with HC.CostMode():
        counted = run()
    assert all(torch.equal(a, b) for a, b in zip(plain, counted))

    ocfg = configs.reduced(configs.get_config("olmo-1b"))
    mesh = make_position_mesh((("pod", 2), ("data", 2), ("model", 2)),
                              "cpu")
    opt = make_optimizer(OptimizerConfig(lr=1e-2, warmup_steps=1))
    params = get_bundle(ocfg).init(ocfg, torch.Generator().manual_seed(5),
                                   dtype=torch.float32, device="cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = batch_for(ocfg, configs.ShapeConfig("t", 16, 4, "train"), 0,
                      seed=1)
    step = jit_train_step(ocfg, opt, mesh, grad_compress=True)[0]
    a, am = step(state, batch)
    with HC.CostMode():
        b, bm = step(state, batch)
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves({**a, "m": am}), tree_leaves({**b, "m": bm})))


# -- the count on CPU and on meta --------------------------------------------------


def _reduced_step_args(arch: str, device: str):
    cfg = configs.reduced(configs.get_config(arch))
    params = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(6),
                                  dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(7)
    S = 64
    Sd = S // cfg.dec_len_ratio if cfg.encoder_layers else S
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, Sd), generator=g)}
    batch["labels"] = batch["tokens"].roll(1, 1)
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(2, S, cfg.d_model, generator=g)
    to = (lambda t: t.to(device))
    return cfg, tree_map(to, params), {k: to(v) for k, v in batch.items()}


def _loss_and_grads(cfg, params, batch):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = get_bundle(cfg).loss(cfg, tree_unflatten(params, leaves), batch,
                                None)
    torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_is_the_same_on_cpu_and_meta(arch):
    """Loss and backward at reduced size: FLOPs, collectives, bytes, ops,
    the peak of live bytes and every op's count equal on CPU and meta
    tensors (the MoE's one-hot is a comparison, so no op dispatches by
    device on this path)."""
    cpu = HC.analyze(_loss_and_grads, *_reduced_step_args(arch, "cpu"))
    meta = HC.analyze(_loss_and_grads, *_reduced_step_args(arch, "meta"))
    assert cpu["devices"] == ["cpu"] and meta["devices"] == ["meta"]
    for k in ("flops", "bytes", "ops", "peak_live_bytes", "by_op",
              "collective_bytes", "collective_counts"):
        assert cpu[k] == meta[k], k
    assert cpu["flops"] > 0


def test_the_lm_and_dist_do_not_import_the_counter():
    """The model and dist layers record through ``dist/collectives``; the
    counter (``launch/hlo_cost`` and the torch modules it needs) is loaded
    only by the dry-run."""
    code = ("import sys; import repro_torch.models.layers, "
            "repro_torch.dist.compression, repro_torch.train.trainer; "
            "bad = [m for m in ('repro_torch.launch.hlo_cost', "
            "'torch.utils.flop_counter') if m in sys.modules]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


# -- the CLIs ------------------------------------------------------------------------


def test_hillclimb_import_has_no_side_effects_and_parse_override_matches():
    code = ("import os, sys; before = dict(os.environ); "
            "import repro_torch.launch.hillclimb; "
            "assert dict(os.environ) == before; "
            "assert 'repro_torch.launch.dryrun' not in sys.modules; "
            "assert 'jax' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    from repro.launch import hillclimb as JH
    for kv in ("moe_decode_ep=true", "moe_decode_ep=False", "x=3", "x=-2",
               "lr=1e-3", "f=0.5", "name=adamw", "a=b=c", "v=", "t=TRUE",
               "n=1_000"):
        assert PH.parse_override(kv) == JH.parse_override(kv), kv


def test_dryrun_cli_writes_gen_tables_records(tmp_path, monkeypatch,
                                              capsys):
    """One record per cell and mesh, with the keys
    ``experiments/gen_tables.py`` reads, which builds its table from them;
    a skipped cell is recorded; nothing lies off meta."""
    out = tmp_path / "dryrun.jsonl"
    assert PD.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                    "--both-meshes", "--out", str(out)]) == 0
    assert PD.main(["--arch", "olmo-1b", "--shape", "long_500k",
                    "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["status"]) for r in recs] == [
        ("16x16", "ok"), ("2x16x16", "ok"), ("16x16", "skipped")]
    for r in recs[:2]:
        assert r["devices"] == ["meta"]
        assert r["flops_per_chip"] > 0 and r["memory_analysis"][
            "argument_size_in_bytes"] > 0
    assert recs[1]["flops_per_chip"] == recs[0]["flops_per_chip"] / 2
    sys.path.insert(0, str(ROOT / "experiments"))
    try:
        import gen_tables
    finally:
        sys.path.remove(str(ROOT / "experiments"))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "EXPERIMENTS.md").write_text("<!-- ROOFLINE_TABLE -->\n")
    gen_tables.main(str(out))
    table = (tmp_path / "EXPERIMENTS.md").read_text()
    assert "| olmo-1b | decode_32k | tp |" in table and "skipped" in table
    capsys.readouterr()


def test_hillclimb_cli_prints_the_terms(capsys):
    assert PH.main(["--arch", "mamba2-2.7b", "--shape", "decode_32k",
                    "--set", "remat=false", "--tag", "t"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("[t] compute=") and "dominant=" in last \
        and "roofline_fraction=" in last
