"""Port parity: LM serving over positions that own their shards
(``dist/sharding``'s ``Sharded`` and placements, ``dist/collectives``'
moves, ``models/positions.py``, ``ServeEngine`` on such a plan).

The reference's half is ``tests/test_torch_lm_mesh.py`` run as a script
with its ``spmd`` and ``spmd-families`` parts, two processes on 8 forced
host devices each (~25 s), started at once when the module starts; the
port runs on a (data 2, model 4) grid of eight ``"cpu"`` positions with
``make_plan(..., own_shards=True)``, each position holding its own
pieces.  It checks:

  * own-shards prefill and one decode step of olmo (tp), qwen2 (cp) and
    llama4-scout (EP) within 1e-5 of the reference (caches gathered from
    their pieces); prefill and two decode steps of mamba2 (tp at
    ``reduced()``, and ``cp`` with no attention heads, as at full width),
    zamba2 and seamless, logits and every cache leaf;
  * the EP MoE layer with capacity drops (the kept set equal to the
    reference's) and the EP decode;
  * the port alone: the collectives against plain tensors (the fold in
    ascending position), a wider olmo / qwen2 / minitron / llama4-maverick
    whose weights are sharded (FSDP, the tp MLP, flash-decoding) and the
    three families with every leaf split, on (1, 4) and (2, 2, 2), against
    the held-once path, each piece's slice equal to
    ``devices_indices_map`` with no position holding a whole sharded leaf
    (the families' caches too), the SSD gate's sum of squares folded in
    ascending position, the EP collective records equal to the held-once
    path's and every byte moved across positions recorded (an SSD, a
    hybrid and an enc-dec prefill and tick too), the engine token for
    token the held-once engine and the single-request loop (mamba2 and
    zamba2 too), and the loss of both bundles, once refused (13h), now
    running.  Training over own shards is
    ``tests/test_torch_lm_spmd_train.py``.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_lm_mesh import (B, CTX, ED_FRAMES, ED_TOKENS, FAMILY_CTX,
                                FAMILY_S, FAMILY_STEPS, REF_TIMEOUT_S,
                                RUN_MESH, S, SCOUT, SPMD_ARCHS,
                                SPMD_FAMILIES, TRAIN_MESH, _close,
                                _close_to_scale, _tree, family_config)

from repro_torch import configs
from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import (Mesh, NamedSharding, P, Sharded,
                                       cache_specs, make_plan, own_spec,
                                       param_specs, shard_caches,
                                       shard_params, shard_tensor)
from repro_torch.launch.mesh import make_position_mesh
from repro_torch.models import encdec as ED
from repro_torch.models import get_bundle
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import positions as PS
from repro_torch.train.tree import (tree_flatten_with_path, tree_leaves,
                                    tree_map)

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "tests" / "test_torch_lm_mesh.py"
#: a wider reduced model: its large leaves pass param_specs' size floor,
#: so they are sharded (FSDP over data, the last dim over model)
WIDE = dict(d_model=256, vocab=2048)
#: the reference's parts this module reads, run as processes at once
PARTS = ("spmd", "spmd-families")
#: the held-once comparisons of the families with every leaf split
SPLIT_MESHES = ((("data", 1), ("model", 4)), TRAIN_MESH)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: the own-shards path runs many
    small ops a step, which one thread runs faster than several, and
    parallel test workers then do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _reference_proc(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm-spmd-reference")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for part in PARTS:
        with open(out / f"{part}.err", "w") as err:
            procs[part] = subprocess.Popen(
                [sys.executable, str(SCRIPT), str(out / f"{part}.npz"),
                 part], env=env, cwd=str(ROOT), stdout=subprocess.DEVNULL,
                stderr=err)
    yield out, procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(_reference_proc):
    out, procs = _reference_proc
    got: dict = {}
    for part, proc in procs.items():
        try:
            proc.wait(timeout=REF_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pytest.fail(f"the reference's {part} part ran past "
                        f"{REF_TIMEOUT_S} s")
        if proc.returncode != 0:
            pytest.fail(f"the reference's {part} part failed:\n"
                        + (out / f"{part}.err").read_text()[-4000:])
        with np.load(out / f"{part}.npz") as z:
            got.update(z)
    return got


def _mesh(pairs=RUN_MESH):
    return make_position_mesh(pairs, "cpu")


def _own(cfg, pairs=RUN_MESH, decode_batch=B):
    return make_plan(cfg, _mesh(pairs), decode_batch=decode_batch,
                     own_shards=True)


def _gather(tree):
    return tree_map(lambda x: C.gather_to(x, "cpu")
                    if isinstance(x, Sharded) else x, tree)


def _close_tree(got, want, **tol) -> None:
    """Every leaf of ``got`` (pieces gathered) within tolerance of
    ``want``'s, path for path."""
    got = tree_flatten_with_path(_gather(got))
    want = tree_flatten_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        _close(g, w, **tol)


def _family_run(cfg, p, splan, toks, frames=None, *, ctx=FAMILY_CTX):
    """Prefill then ``FAMILY_STEPS`` teacher-forced decode steps of a
    family config under ``splan``: [(logits, caches)] after each, the
    caches gathered from their pieces (an enc-dec prefill reads
    ``ED_TOKENS`` tokens of ``toks`` after ``frames``, a decoder-only one
    all but the last ``FAMILY_STEPS``)."""
    if cfg.encoder_layers:
        n = ED_TOKENS
        logits, caches = ED.encdec_prefill(cfg, p, frames, toks[:, :n],
                                           splan=splan)
        step = lambda c, t: ED.encdec_decode(cfg, p, c, t,  # noqa: E731
                                             splan=splan)
    else:
        n = toks.shape[1] - FAMILY_STEPS
        logits, caches = LM.lm_prefill(cfg, p, toks[:, :n], splan=splan,
                                       ctx=ctx)
        step = lambda c, t: LM.lm_decode(cfg, p, c, t,  # noqa: E731
                                         splan=splan)
    out = [(logits, _snapshot(caches))]
    for i in range(FAMILY_STEPS):
        logits, caches = step(caches, toks[:, n + i:n + i + 1])
        out.append((logits, _snapshot(caches)))
    return out


def _snapshot(tree):
    """A copy of a cache tree (pieces gathered): the next decode writes
    the caches in place."""
    return tree_map(lambda x: (C.gather_to(x, "cpu")
                               if isinstance(x, Sharded) else x).clone(),
                    tree)


# -- against the reference ----------------------------------------------------------


@pytest.mark.parametrize("arch", SPMD_ARCHS)
def test_own_shards_prefill_and_decode_match_reference(reference, arch):
    """Logits and caches within 1e-5 after prefill and one decode step on
    (2, 4): olmo's heads over model (tp), qwen2's sequence (cp), and
    llama4-scout's EP prefill with drops and EP decode."""
    cfg = configs.reduced(configs.get_config(arch))
    splan = _own(cfg)
    assert splan.own_shards and splan.attn_mode == (
        "tp" if arch == "olmo-1b" else "cp")
    p = shard_params(LM.params_from_arrays(_tree(reference, f"w/{arch}"),
                                           device="cpu"), splan)
    toks = torch.from_numpy(reference[f"in/{arch}/tokens"]).long()
    logits, caches = LM.lm_prefill(cfg, p, toks[:, :S], splan=splan,
                                   ctx=CTX)
    _close(logits, reference[f"out/{arch}/prefill"])
    tol = dict(rtol=3e-5, atol=3e-5) if cfg.num_experts else {}
    want = _tree(reference, f"out/{arch}/caches")
    for (path, g), (_, w) in zip(tree_flatten_with_path(_gather(caches)),
                                 tree_flatten_with_path(want)):
        _close(g, w, **tol)
    logits, caches = LM.lm_decode(cfg, p, caches, toks[:, S:S + 1],
                                  splan=splan)
    _close(logits, reference[f"out/{arch}/decode"])
    want = _tree(reference, f"out/{arch}/decode_caches")
    for (path, g), (_, w) in zip(tree_flatten_with_path(_gather(caches)),
                                 tree_flatten_with_path(want)):
        _close(g, w, **tol)


@pytest.mark.parametrize("name", SPMD_FAMILIES)
def test_own_shards_families_match_reference(reference, name):
    """mamba2 (``tp`` on ``reduced()``'s 4 heads; ``:cp`` with none, as at
    full width, so its sequence is split over ``model`` and each SSD
    layer gathers it), zamba2 (the shared block, LoRA) and seamless (the
    encoder, cross-attention, the memory) on (2, 4): prefill (40 tokens: a
    chunk and a padded one) and two decode steps, logits and every cache
    leaf (conv, state, K/V, shared, self, memory, index) within 1e-5 of
    the reference."""
    cfg = family_config(configs, name)
    splan = _own(cfg)
    assert splan.own_shards
    assert splan.attn_mode == ("cp" if name.endswith(":cp") else "tp")
    assert splan.ssm_state[1] == ("model" if cfg.ssm_layers else None)
    if name.endswith(":cp"):
        assert splan.hidden == P("data", "model", None)
    p = shard_params(LM.params_from_arrays(_tree(reference, f"w/{name}"),
                                           device="cpu"), splan)
    toks = torch.from_numpy(reference[f"in/{name}/tokens"]).long()
    frames = (torch.from_numpy(reference[f"in/{name}/frames"])
              if cfg.encoder_layers else None)
    got = _family_run(cfg, p, splan, toks, frames)
    names = {path[-1] for path, _ in tree_flatten_with_path(got[0][1])}
    assert names == ({"memory", "index", "k", "v"} if cfg.encoder_layers
                     else {"conv", "state", "index"}
                     | ({"k", "v"} if cfg.shared_attn_every else set()))
    for i, (logits, caches) in enumerate(got):
        key = ("prefill", "decode", *(f"decode{j + 1}"
                                      for j in range(1, FAMILY_STEPS)))[i]
        _close(logits, reference[f"out/{name}/{key}"])
        _close_tree(caches, _tree(reference, f"out/{name}/"
                                  + ("caches" if i == 0 else f"{key}_caches")))


def _scout_moe(reference):
    cfg = configs.reduced(configs.get_config(SCOUT))
    moe = tree_map(lambda t: t[0], LM.params_from_arrays(
        _tree(reference, f"w/{SCOUT}"), device="cpu")["blocks"]["p0"]["moe"])
    splan = _own(cfg)
    return cfg, splan, moe, shard_params({"moe": moe}, splan)["moe"]


def test_own_shards_ep_prefill_with_drops_matches_reference(reference):
    """Each (data, model) position routes its own 4 tokens at cap_src = 1:
    the kept set equals the reference's (the rows of its routed-only
    output that are not 0), and the outputs are within 1e-5 of their
    scale."""
    cfg, splan, moe, pieces = _scout_moe(reference)
    x = torch.from_numpy(reference["moe/x"])
    xs = shard_tensor(x, splan.mesh, P("data", None, None))
    routed, routes = PS.moe_prefill(cfg, pieces, xs, splan, with_routes=True)
    _close_to_scale(C.gather_to(routed, "cpu"), reference["moe/routed"])
    kept = torch.zeros((B, S), dtype=torch.bool)
    for pos, (_, keep) in routes.items():
        b0, s0 = routed.offset(pos, 0), routed.offset(pos, 1)
        b, s = routed.pieces[pos].shape[:2]
        kept[b0:b0 + b, s0:s0 + s] = keep.reshape(b, s)
    np.testing.assert_array_equal(
        kept.numpy(), np.abs(reference["moe/routed"]).max(-1) > 0)
    assert 0 < int(kept.sum()) < B * S
    full = PS.moe_layer(cfg, splan, pieces, xs, P("data", None, None),
                        decode=False)
    _close_to_scale(C.gather_to(full, "cpu"), reference["moe/ep"])


def test_own_shards_ep_decode_matches_reference(reference):
    cfg, splan, moe, pieces = _scout_moe(reference)
    x = torch.from_numpy(reference["moe/x"])[:, :1]
    xs = shard_tensor(x, splan.mesh, splan.decode_hidden)
    got = PS.moe_layer(cfg, splan, pieces, xs, splan.decode_hidden,
                       decode=True)
    _close_to_scale(C.gather_to(got, "cpu"), reference["moe/decode"])


# -- the port alone ---------------------------------------------------------------------


def test_collectives_move_pieces_and_fold_in_position_order():
    mesh = _mesh()
    t = torch.randn(4, 8, 12, generator=torch.Generator().manual_seed(0))
    x = shard_tensor(t, mesh, P("data", None, "model"))
    assert torch.equal(C.gather_to(x, "cpu"), t)
    for spec in (P("data", None, None), P("data", "model", None),
                 P(None, None, None), P("model", "data", None),
                 P(None, ("data", "model"), None)):
        y = C.relayout(x, spec)
        assert y.spec == spec and torch.equal(C.gather_to(y, "cpu"), t)
    y = C.all_to_all(C.all_gather(x, 0), 1, 2)
    assert y.spec == P(None, "model", None)
    assert torch.equal(C.gather_to(y, "cpu"), t)
    # partial sums: model member m holds t * (m + 1) / 10; the fold is
    # sequential in ascending m, bit for bit
    part = C.relayout(x, P(None, None, None)).map(
        lambda pos, u: u * (pos[1] + 1) / 10)
    want = None
    for m in range(4):
        term = t * (m + 1) / 10
        want = term if want is None else want + term
    summed = C.psum(part, ("model",))
    assert summed.spec == part.spec
    assert torch.equal(C.gather_to(summed, "cpu"), want)
    rs = C.reduce_scatter(part, ("model",), 2)
    assert rs.spec == P(None, None, "model")
    assert torch.equal(C.gather_to(rs, "cpu"), want)
    b = C.broadcast(part, ("model",), 2)
    assert all(torch.equal(b.pieces[pos], part.pieces[(pos[0], 2)])
               for pos in b.pieces)
    # a one-row batch over data = 2 is held whole at both data positions
    one = shard_tensor(t[:1], mesh, P("data", None, "model"))
    assert one.spec == P(None, None, "model") and one.shape == (1, 8, 12)


@pytest.mark.parametrize("arch,pairs,decode_batch", [
    ("olmo-1b", RUN_MESH, 2), ("qwen2-7b", RUN_MESH, 2),
    ("olmo-1b", RUN_MESH, 1), ("qwen2-7b", RUN_MESH, 1),
    ("olmo-1b", (("pod", 2), ("data", 2), ("model", 2)), 4),
    ("minitron-4b", RUN_MESH, 2), ("minitron-4b", RUN_MESH, 1),
    ("llama4-maverick-400b-a17b", RUN_MESH, 2),
    ("llama4-maverick-400b-a17b", RUN_MESH, 1)])
def test_wide_own_shards_match_held_once(arch, pairs, decode_batch):
    """At d_model 256 the MLP, embedding and (for qwen2) attention weights
    are sharded: FSDP gathers, the tp MLP's reduce-scatter, the cp K/V
    gather (minitron: ``cp`` with one KV head), llama4-maverick's EP
    prefill and its shared expert.  decode_batch 1 < data: the cache's
    sequence is split over every axis and the decode merges the
    positions' (max, sum, output).  Logits and caches within 1e-5 of the
    held-once path after prefill and two decode steps."""
    cfg = configs.reduced(configs.get_config(arch), **WIDE)
    p = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(5),
                             dtype=torch.float32, device="cpu")
    mesh = _mesh(pairs)
    held = make_plan(cfg, mesh, decode_batch=decode_batch)
    own = make_plan(cfg, mesh, decode_batch=decode_batch, own_shards=True)
    pieces = shard_params(p, own)
    assert any(v.parts(v.ndim - 1) > 1 or v.parts(v.ndim - 2) > 1
               for v in tree_leaves(pieces))
    toks = torch.randint(0, cfg.vocab_size, (2, 18),
                         generator=torch.Generator().manual_seed(6))
    ctx = 24
    want, wc = LM.lm_prefill(cfg, p, toks[:, :16], splan=held, ctx=ctx)
    got, gc = LM.lm_prefill(cfg, pieces, toks[:, :16], splan=own, ctx=ctx)
    _close(got, want)
    if decode_batch < 2:
        assert gc["p0"]["k"].entry(2) == ("data", "model")
    for i in range(2):
        want, wc = LM.lm_decode(cfg, p, wc, toks[:, 16 + i:17 + i],
                                splan=held)
        got, gc = LM.lm_decode(cfg, pieces, gc, toks[:, 16 + i:17 + i],
                               splan=own)
        _close(got, want)
    for (path, g), (_, w) in zip(tree_flatten_with_path(_gather(gc)),
                                 tree_flatten_with_path(wc)):
        _close(g, w)


@pytest.mark.parametrize("arch", ["yi-34b", "chameleon-34b"])
def test_sharded_norms_match_held_once(arch, monkeypatch):
    """At full width ``param_specs`` splits yi-34b's and chameleon-34b's
    stacked ``[nB, D]`` norm scales over ``model`` (60 x 7168 and 48 x
    8192 pass the size floor); the positions gather them whole before
    use, as the norms and chameleon's q / k norms need.  The reduced
    configs run with the floor lowered to 1, so that their norms are
    split as the full ones are; logits and caches within 1e-5 of the
    held-once path after prefill and two decode steps."""
    from repro_torch.dist import sharding
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import state_shapes

    full = configs.get_config(arch)
    meta = state_shapes(full, make_optimizer(OptimizerConfig()))["params"]
    specs = param_specs(meta, _mesh())
    assert specs["blocks"]["p0"]["norm1"]["scale"] == P(None, "model")
    monkeypatch.setattr(sharding, "_MIN_SHARD_SIZE", 1)
    cfg = configs.reduced(full)
    p = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(7),
                             dtype=torch.float32, device="cpu")
    held = make_plan(cfg, _mesh(), decode_batch=2)
    own = make_plan(cfg, _mesh(), decode_batch=2, own_shards=True)
    pieces = shard_params(p, own)
    blk = pieces["blocks"]["p0"]
    norms = [blk["norm1"]["scale"], blk["norm2"]["scale"]] + (
        [blk["attn"]["q_norm"], blk["attn"]["k_norm"]] if cfg.qk_norm
        else [])
    assert all(v.entry(1) == ("model",) for v in norms)
    toks = torch.randint(0, cfg.vocab_size, (2, 18),
                         generator=torch.Generator().manual_seed(8))
    want, wc = LM.lm_prefill(cfg, p, toks[:, :16], splan=held, ctx=24)
    got, gc = LM.lm_prefill(cfg, pieces, toks[:, :16], splan=own, ctx=24)
    _close(got, want)
    for i in range(2):
        want, wc = LM.lm_decode(cfg, p, wc, toks[:, 16 + i:17 + i],
                                splan=held)
        got, gc = LM.lm_decode(cfg, pieces, gc, toks[:, 16 + i:17 + i],
                               splan=own)
        _close(got, want)
    for (path, g), (_, w) in zip(tree_flatten_with_path(_gather(gc)),
                                 tree_flatten_with_path(wc)):
        _close(g, w)


def _family(name: str, seed: int):
    """A family config (zamba2 at two blocks, so that the LoRA and the
    shared caches go by block) and its f32 parameters on the CPU."""
    cfg = family_config(configs, name)
    if cfg.shared_attn_every:
        cfg = dataclasses.replace(cfg, num_layers=2 * cfg.block_period)
    return cfg, get_bundle(cfg).init(cfg, torch.Generator().manual_seed(seed),
                                     dtype=torch.float32, device="cpu")


def _family_inputs(cfg, seed: int):
    """Tokens (and an enc-dec's frames) for ``_family_run``."""
    gen = torch.Generator().manual_seed(seed)
    n = ED_TOKENS if cfg.encoder_layers else FAMILY_S
    toks = torch.randint(0, cfg.vocab_size, (B, n + FAMILY_STEPS),
                         generator=gen)
    frames = (torch.randn(B, ED_FRAMES, cfg.d_model, generator=gen)
              if cfg.encoder_layers else None)
    return toks, frames


@pytest.mark.parametrize("name,pairs,decode_batch", [
    (name, pairs, db) for name in SPMD_FAMILIES for pairs in SPLIT_MESHES
    for db in (1, 2)])
def test_families_with_every_leaf_split_match_held_once(
        name, pairs, decode_batch, monkeypatch):
    """With ``param_specs``' size floor at 1 every leaf of rank 2 or more
    is split (``in_proj``, the conv and the SSD's vectors, ``out_proj``,
    the LoRA, the shared and cross-attention weights, the norms), as the
    full-width ones are: the SSD's column block and projection gather, the
    summed gate norm, the LoRA column block, cross-attention's heads, all
    against the held-once path on (1, 4) and (2, 2, 2), decode batch 1
    (the state's batch replicated, the K/V sequence over every axis) and
    2: logits and every cache leaf within 1e-5 after prefill and two
    decode steps."""
    from repro_torch.dist import sharding
    monkeypatch.setattr(sharding, "_MIN_SHARD_SIZE", 1)
    cfg, p = _family(name, 11)
    mesh = _mesh(pairs)
    held = make_plan(cfg, mesh, decode_batch=decode_batch)
    own = make_plan(cfg, mesh, decode_batch=decode_batch, own_shards=True)
    pieces = shard_params(p, own)
    whole = [path for path, v in tree_flatten_with_path(pieces)
             if v.ndim >= 2 and not any(v.entry(d) for d in range(v.ndim))]
    assert not whole
    toks, frames = _family_inputs(cfg, 12)
    want = _family_run(cfg, p, held, toks, frames)
    got = _family_run(cfg, pieces, own, toks, frames)
    for (gl, gc), (wl, wc) in zip(got, want):
        _close(gl, wl)
        _close_tree(gc, wc)


@pytest.mark.parametrize("name,pairs", [
    (name, pairs) for name in ("mamba2-2.7b:cp", "zamba2-2.7b")
    for pairs in ((("data", 2), ("model", 3)), (("data", 4),))])
def test_families_on_meshes_that_split_no_heads_match_held_once(
        name, pairs, monkeypatch):
    """A model axis that divides neither the SSD nor the attention heads
    (3), or none at all: the plan is ``cp``, ``ssm_state`` splits no
    heads, and every position scans all the heads with the whole
    ``in_proj`` / ``out_proj`` (``_ssd_out``'s held-once norm), zamba2's
    shared block on its sequence block; logits and every cache leaf
    within 1e-5 of the held-once path (the size floor at 1)."""
    from repro_torch.dist import sharding
    monkeypatch.setattr(sharding, "_MIN_SHARD_SIZE", 1)
    cfg, p = _family(name, 11)
    mesh = _mesh(pairs)
    held = make_plan(cfg, mesh, decode_batch=2)
    own = make_plan(cfg, mesh, decode_batch=2, own_shards=True)
    assert own.attn_mode == "cp" and own.ssm_state[1] is None
    toks, frames = _family_inputs(cfg, 12)
    want = _family_run(cfg, p, held, toks, frames)
    got = _family_run(cfg, shard_params(p, own), own, toks, frames)
    for (gl, gc), (wl, wc) in zip(got, want):
        _close(gl, wl)
        _close_tree(gc, wc)


@pytest.mark.parametrize("name", SPMD_FAMILIES)
def test_family_cache_pieces_are_the_devices_indices_map_slices(name):
    """The own-shards caches of each family, after prefill and in the
    engine's slots: every piece is its position's ``devices_indices_map``
    slice under ``own_spec`` of its ``cache_specs`` spec (the SSD ``conv``
    window by its rows, whole over ``model``; the f32 ``state`` by
    ``ssm_state``, heads over ``model``; the shared and self K/V by
    ``decode_cache``; the memory by its rows), and no position holds a
    whole copy of a leaf its spec splits."""
    cfg, p = _family(name, 13)
    splan = _own(cfg)
    pieces = shard_params(p, splan)
    toks, frames = _family_inputs(cfg, 14)
    if cfg.encoder_layers:
        _, caches = ED.encdec_prefill(cfg, pieces, frames,
                                      toks[:, :ED_TOKENS], splan=splan)
        trees = [caches]
    else:
        _, caches = LM.lm_prefill(cfg, pieces, toks[:, :FAMILY_S],
                                  splan=splan, ctx=FAMILY_CTX)
        from repro_torch.serve.engine import ServeEngine
        eng = ServeEngine(cfg, pieces, slots=4, max_ctx=48,
                          prompt_buckets=(16,), splan=splan,
                          dtype=torch.float32, device="cpu")
        trees = [caches, eng.caches]
    mesh = splan.mesh
    split = 0
    for tree in trees:
        specs = tree_flatten_with_path(cache_specs(tree, splan))
        for (path, x), (_, spec) in zip(tree_flatten_with_path(tree), specs):
            whole_value = C.gather_to(x, "cpu")
            assert x.spec == own_spec(spec, whole_value.shape, mesh), path
            slices = NamedSharding(mesh, x.spec).devices_indices_map(
                whole_value.shape)
            assert list(slices) == list(x.pieces)
            for pos, idx in slices.items():
                assert torch.equal(x.pieces[pos], whole_value[idx]), path
            if any(x.entry(d) for d in range(x.ndim)):
                split += 1
                assert all(q.numel() < whole_value.numel()
                           for q in x.pieces.values()), path
    assert split >= 2
    if cfg.ssm_layers:
        assert caches["p0"]["state"].entry(2) == ("model",)
        assert caches["p0"]["conv"].entry(1) == ("data",)
        assert not caches["p0"]["conv"].entry(3)
    if cfg.encoder_layers:
        assert caches["memory"].spec == P("data", None, None)


def test_ssd_gate_sums_squares_in_position_order():
    """The gated norm over d_inner with the heads split: each position's
    sum of squares of its slice, summed over ``model`` in ascending
    position before the rsqrt, then its rows of ``out_proj`` reduce-
    scattered onto the hidden spec, folded in ascending position: bit for
    bit that fold computed by hand (a summation order of its own, within
    1e-6 of the held-once ``_gated_rmsnorm`` over the whole d_inner)."""
    from repro_torch.models import ssd as SSD
    cfg = configs.reduced(configs.get_config("zamba2-2.7b"))
    splan = make_plan(cfg, _mesh((("data", 1), ("model", 4))), decode_batch=2,
                      own_shards=True)
    gen = torch.Generator().manual_seed(15)
    di, D = cfg.d_inner, cfg.d_model
    y, z = (torch.randn(2, 8, di, generator=gen) for _ in range(2))
    p = {"norm": 1 + 0.1 * torch.randn(di, generator=gen),
         "out_proj": torch.randn(di, D, generator=gen) / 8}
    pieces = shard_params(p, splan)
    mesh = splan.mesh
    share = P(None, None, "model")
    got = C.gather_to(PS._ssd_out(
        cfg, splan, pieces, shard_tensor(y, mesh, share),
        shard_tensor(z, mesh, share), PS._whole(pieces["norm"]),
        splan.hidden), "cpu")
    g = (y * torch.nn.functional.silu(z)).float().chunk(4, dim=-1)
    ss = None
    for part in g:
        t = (part * part).sum(-1, keepdim=True)
        ss = t if ss is None else ss + t
    rows = p["out_proj"].chunk(4, dim=0)
    want = None
    for part, norm, w in zip(g, p["norm"].chunk(4), rows):
        t = (part * torch.rsqrt(ss / di + 1e-6) * norm) @ w
        want = t if want is None else want + t
    assert torch.equal(got, want)
    held = SSD._gated_rmsnorm(y, z, p["norm"]) @ p["out_proj"]
    torch.testing.assert_close(got, held, rtol=1e-6, atol=1e-6)


def test_pieces_are_the_devices_indices_map_slices():
    """Every piece of a placed parameter tree is its position's
    ``devices_indices_map`` slice (under ``own_spec``), no position holds
    a whole copy of a leaf its spec shards, and no two positions share a
    piece's storage."""
    cfg = configs.reduced(configs.get_config("olmo-1b"), **WIDE)
    p = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(5),
                             dtype=torch.float32, device="cpu")
    mesh = _mesh()
    splan = _own(cfg)
    pieces = shard_params(p, splan)
    specs = param_specs(p, mesh)
    sharded = 0
    for (path, t), (_, x), (_, spec) in zip(
            tree_flatten_with_path(p), tree_flatten_with_path(pieces),
            tree_flatten_with_path(specs)):
        assert x.spec == P(*(tuple(spec) + (None,) * (t.ndim - len(spec))))
        slices = NamedSharding(mesh, x.spec).devices_indices_map(t.shape)
        assert list(slices) == list(x.pieces)
        for pos, idx in slices.items():
            assert torch.equal(x.pieces[pos], t[idx]), path
        if any(x.entry(d) for d in range(t.ndim)):
            sharded += 1
            assert all(q.numel() < t.numel() for q in x.pieces.values())
        ptrs = {q.untyped_storage().data_ptr() for q in x.pieces.values()}
        assert len(ptrs) == mesh.size, path
    assert sharded >= 4
    # a cache tree by cache_specs: K/V by decode_cache, index replicated
    caches = LM.init_caches(cfg, 2, 24, dtype=torch.float32, device="cpu")
    caches["p0"]["k"].normal_(generator=torch.Generator().manual_seed(2))
    placed = shard_caches(caches, splan)
    for (path, t), (_, x), (_, spec) in zip(
            tree_flatten_with_path(caches), tree_flatten_with_path(placed),
            tree_flatten_with_path(cache_specs(caches, splan))):
        assert x.spec == own_spec(spec, t.shape, mesh), path
        slices = NamedSharding(mesh, x.spec).devices_indices_map(t.shape)
        assert all(torch.equal(x.pieces[pos], t[idx])
                   for pos, idx in slices.items()), path
    assert placed["p0"]["k"].spec == P(None, "data", None, "model", None)
    assert placed["index"].first.shape == ()


class _Recorder:
    def __init__(self):
        self.records = []

    def collective(self, kind, nbytes, group, members):
        self.records.append((kind, nbytes, group, members))


#: the bytes that cross positions in one recorded collective, as the
#: functions of ``dist/collectives`` move them
_CROSSING = {
    "all-gather": lambda r, g, n: n * r * (g - 1) // g,
    "all-to-all": lambda r, g, n: n * r * (g - 1) // g,
    "reduce-scatter": lambda r, g, n: n * r * (g - 1),
    "all-reduce": lambda r, g, n: n * r * (g - 1),
    "collective-permute": lambda r, g, n: n * r * (g - 1) // g,
}


def _recorded(fn):
    rec = _Recorder()
    prev = C.set_recorder(rec)
    moved = C.moved_bytes()
    try:
        fn()
    finally:
        C.set_recorder(prev)
    return rec.records, C.moved_bytes() - moved


def test_ep_records_equal_held_once_and_every_move_is_recorded():
    """The EP prefill's two all-to-alls and the EP decode's all-reduce
    record the kind, bytes, group and members the held-once path records;
    over a whole own-shards prefill and decode, the bytes the collectives
    moved across positions are the recorded collectives' crossing bytes,
    so no move went unrecorded."""
    cfg = configs.reduced(configs.get_config(SCOUT))
    moe = tree_map(lambda t: t[0], get_bundle(cfg).init(
        cfg, torch.Generator().manual_seed(7), dtype=torch.float32,
        device="cpu")["blocks"]["p0"]["moe"])
    routed = {k: v for k, v in moe.items() if k != "shared"}
    mesh = _mesh()
    held = make_plan(cfg, mesh, decode_batch=B)
    own = _own(cfg)
    pieces = shard_params({"moe": routed}, own)["moe"]
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(8))
    want, _ = _recorded(lambda: L.moe_dispatch_blocks(
        routed, x, 2, 4, L.ep_capacity(cfg, held, x)))
    got, moved = _recorded(lambda: PS.moe_prefill(
        cfg, pieces, shard_tensor(x, mesh, P("data", "model", None)), own))
    assert got == want and [r[0] for r in got] == ["all-to-all"] * 2
    assert moved == sum(_CROSSING[k](r, g, n) for k, r, g, n in got)
    want, _ = _recorded(lambda: L.moe_decode(
        dataclasses.replace(cfg, shared_expert=False), routed, x[:, :1],
        splan=held))
    got, _ = _recorded(lambda: PS.moe_decode(
        cfg, pieces, shard_tensor(x[:, :1], mesh, own.decode_hidden), own))
    assert got == want and [r[0] for r in got] == ["all-reduce"]
    # a whole prefill and decode of the wide olmo (tp) and qwen2 (cp)
    for arch in ("olmo-1b", "qwen2-7b"):
        wcfg = configs.reduced(configs.get_config(arch), **WIDE)
        splan = _own(wcfg)
        p = shard_params(get_bundle(wcfg).init(
            wcfg, torch.Generator().manual_seed(9), dtype=torch.float32,
            device="cpu"), splan)
        toks = torch.randint(0, wcfg.vocab_size, (B, S + 1),
                             generator=torch.Generator().manual_seed(10))

        def run():
            _, c = LM.lm_prefill(wcfg, p, toks[:, :S], splan=splan, ctx=CTX)
            LM.lm_decode(wcfg, p, c, toks[:, S:], splan=splan)

        got, moved = _recorded(run)
        kinds = {r[0] for r in got}
        assert {"all-gather", "all-to-all"} <= kinds
        assert ("reduce-scatter" in kinds) == (arch == "olmo-1b")
        assert moved == sum(_CROSSING[k](r, g, n) for k, r, g, n in got) > 0


@pytest.mark.parametrize("name", ["mamba2-2.7b:cp", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_family_moves_are_recorded(name, monkeypatch):
    """With every leaf split (the size floor at 1), over an own-shards
    prefill and decode step of the SSD under ``cp`` (the sequence gathered
    for the scan, the projection gathered, the gate's all-reduce,
    ``out_proj``'s reduce-scatter onto the sequence), the hybrid under
    ``tp`` (the concat's d_model gathers, the LoRA's column blocks) and
    the enc-dec (the memory, cross-attention), and over one engine tick
    of the first two, the bytes the collectives moved across positions
    are the recorded collectives' crossing bytes: no move went
    unrecorded."""
    from repro_torch.dist import sharding
    from repro_torch.serve.engine import ServeEngine
    monkeypatch.setattr(sharding, "_MIN_SHARD_SIZE", 1)
    cfg, p = _family(name, 16)
    splan = _own(cfg)
    pieces = shard_params(p, splan)
    toks, frames = _family_inputs(cfg, 17)
    got, moved = _recorded(lambda: _family_run(cfg, pieces, splan, toks,
                                               frames))
    kinds = {r[0] for r in got}
    assert {"all-gather", "all-reduce", "reduce-scatter",
            "all-to-all"} <= kinds
    assert moved == sum(_CROSSING[k](r, g, n) for k, r, g, n in got) > 0
    if cfg.encoder_layers:
        return
    eng = ServeEngine(cfg, pieces, slots=2, max_ctx=48, prompt_buckets=(16,),
                      splan=make_plan(cfg, splan.mesh, decode_batch=2,
                                      own_shards=True),
                      dtype=torch.float32, device="cpu")
    eng.submit(np.arange(5) % cfg.vocab_size, max_new_tokens=3)
    eng.step()                                   # the admission's prefill
    got, moved = _recorded(eng.step)             # a decode tick
    assert {r[0] for r in got} >= {"all-gather", "all-reduce"}
    assert moved == sum(_CROSSING[k](r, g, n) for k, r, g, n in got) > 0


@pytest.mark.parametrize("arch,pairs,slots", [
    ("olmo-1b", RUN_MESH, 4), ("qwen2-7b", RUN_MESH, 1),
    (SCOUT, (("data", 1), ("model", 4)), 2),
    ("mamba2-2.7b", RUN_MESH, 4), ("mamba2-2.7b:cp", RUN_MESH, 1),
    ("zamba2-2.7b", RUN_MESH, 4), ("zamba2-2.7b", RUN_MESH, 1)])
def test_own_shards_engine_matches_held_once_and_loop(arch, pairs, slots):
    """The same script through a held-once and an own-shards engine: the
    same tokens, shed flags and finishing order; and each request's
    tokens the single-request greedy loop's under the own-shards plan.
    qwen2 and zamba2 with one slot on data = 2 decode by flash-decoding;
    mamba2's and zamba2's slots hold SSD conv / state pieces (one slot:
    the state's batch replicated over data), zamba2's the shared K/V."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.router import TIER_BATCH, TIER_INTERACTIVE
    cfg = family_config(configs, arch)
    p = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(3),
                             dtype=torch.float32, device="cpu")
    mesh = _mesh(pairs)
    r = np.random.default_rng(4)
    prompts = [r.integers(0, cfg.vocab_size, int(n)) for n in (5, 9, 16, 3)]
    runs = []
    for own in (False, True):
        splan = make_plan(cfg, mesh, decode_batch=slots, own_shards=own)
        eng = ServeEngine(cfg, p, slots=slots, max_ctx=48,
                          prompt_buckets=(16,), splan=splan,
                          dtype=torch.float32, device="cpu")
        assert eng.own == own
        uids = [eng.submit(q, max_new_tokens=5,
                           priority=TIER_INTERACTIVE if i % 2
                           else TIER_BATCH)
                for i, q in enumerate(prompts)]
        done = eng.run_until_drained()
        runs.append(([q.uid for q in done], {q.uid: (q.tokens, q.shed)
                                              for q in done}, uids))
        if own:
            for leaf in eng.caches["p0"].values():
                assert isinstance(leaf, Sharded)
                assert len(leaf.pieces) == mesh.size
            pieces = eng.params
    assert runs[0] == runs[1]
    splan = make_plan(cfg, mesh, decode_batch=slots, own_shards=True)
    order, tokens, uids = runs[1]
    for uid, q in zip(uids, prompts):
        toks = torch.zeros((1, 16), dtype=torch.long)
        toks[0, 16 - len(q):] = torch.from_numpy(q)
        logits, caches = LM.lm_prefill(cfg, pieces, toks, splan=splan,
                                       ctx=48)
        want = []
        while len(want) < 5:
            want.append(int(torch.argmax(logits[0])))
            logits, caches = LM.lm_decode(cfg, pieces, caches,
                                          torch.tensor([[want[-1]]]),
                                          splan=splan)
        assert tokens[uid][0] == want


def test_own_shards_refusals_name_13h_and_13i():
    """On repeated positions with ``own_shards=True``: the train step, the
    LM's and the enc-dec's loss (each bundle's too) and ``lm_hidden``,
    refused under 13h before it was ported, run and give the held-once
    values within 1e-5;
    the SSD, hybrid and enc-dec families, refused under 13i before it was
    ported, get an own-shards plan; a held-once path is never run
    instead (whole parameters raise ``TypeError``)."""
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import make_train_step
    cfg = configs.reduced(configs.get_config("olmo-1b"))
    splan = _own(cfg)
    opt = make_optimizer(OptimizerConfig())
    assert callable(make_train_step(cfg, opt, splan))
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 4), generator=gen)
    p = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    want = float(LM.lm_loss(cfg, p, toks, toks))
    pieces = shard_params(p, splan)
    for call in (lambda: LM.lm_loss(cfg, pieces, toks, toks, splan=splan),
                 lambda: get_bundle(cfg).loss(
                     cfg, pieces, {"tokens": toks, "labels": toks}, splan)):
        assert abs(float(call()) - want) <= 1e-5 * abs(want)
    _close(C.gather_to(LM.lm_hidden(cfg, pieces, toks, splan=splan), "cpu"),
           LM.lm_hidden(cfg, p, toks).detach().numpy())
    for arch in ("mamba2-2.7b", "zamba2-2.7b", "seamless-m4t-large-v2"):
        fam, mesh = configs.reduced(configs.get_config(arch)), _mesh()
        plan = make_plan(fam, mesh, own_shards=True)
        assert plan.own_shards and plan.attn_mode == "tp"
        assert plan.ssm_state == P("data", "model" if fam.ssm_layers
                                   else None, None, None)
        assert plan == dataclasses.replace(make_plan(fam, mesh),
                                           own_shards=True)
    ed = configs.reduced(configs.get_config("seamless-m4t-large-v2"))
    ep = get_bundle(ed).init(ed, torch.Generator().manual_seed(1),
                             dtype=torch.float32, device="cpu")
    frames = torch.randn(2, 8, ed.d_model, generator=gen)
    want = float(ED.encdec_loss(ed, ep, frames, toks, toks))
    epieces = shard_params(ep, _own(ed))
    for call in (lambda: ED.encdec_loss(ed, epieces, frames, toks, toks,
                                        splan=_own(ed)),
                 lambda: get_bundle(ed).loss(
                     ed, epieces, {"frames": frames, "tokens": toks,
                                   "labels": toks}, _own(ed))):
        assert abs(float(call()) - want) <= 1e-5 * abs(want)
    # a placement over distinct devices (two CPU indices, which torch
    # keeps apart) is a Sharded, never a held copy; on one device it is
    # the held-once tensor
    t = torch.arange(8.0).reshape(4, 2)
    two = Mesh([[torch.device("cpu", 0), torch.device("cpu", 1)]],
               ("data", "model"))
    placed = NamedSharding(two, P(None, "model")).place(t)
    assert isinstance(placed, Sharded) and placed.first.shape == (4, 1)
    assert torch.equal(placed.pieces[(0, 1)], t[:, 1:])
    assert NamedSharding(_mesh(), P("data")).place(t) is t
    for call in (lambda: LM.lm_prefill(cfg, p, toks, splan=splan),
                 lambda: LM.lm_loss(cfg, p, toks, toks, splan=splan)):
        with pytest.raises(TypeError):
            call()
