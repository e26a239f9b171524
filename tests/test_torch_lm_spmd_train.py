"""Port only: LM training over positions that own their shards
(``dist/collectives``' transposes, ``models/positions.loss`` /
``encdec_loss``, the optimizers over ``Sharded`` leaves, the trainer's
own-shards step, checkpoints and ``TrainLoop`` over pieces), held against
the held-once step on the same positions.  The reference's half
(the compressed step of olmo and llama4-scout, the restore of its
checkpoint) is in ``tests/test_torch_lm_mesh.py``.

Every family at ``reduced()`` in f32, with ``param_specs``' size floor at
1 so that every leaf of rank 2 or more is split (as the full-width ones
are): olmo (``tp``), qwen2 (``cp``), llama4-scout (EP), mamba2 (``tp``
and, with no attention heads, ``cp``), zamba2 (the shared block, LoRA)
and seamless (the enc-dec), on (1, 4), (2, 4) and (pod 2, data 2, model
2):

  * the loss within 1e-5; each leaf's gradient within 2e-5 of that
    leaf's largest held-once gradient (1e-5 holds in 20 of the 21 cases;
    zamba2's ``conv_b`` on (2, 2, 2) lands at 1.01e-5), and no leaf's
    norm off by a group's size (the transposes sum each copy's cotangent
    once);
  * one AdamW and one Adafactor step over the pieces against the
    held-once optimizer fed the same gradients (gathered): each leaf's
    update within 1e-5 of its largest plus two ulps of the parameter (a
    norm scale of 1 resolves an update of 1e-2 to 1.2e-5 of itself), the
    state within 1e-5 of its largest, gnorm within 1e-5 (both
    first updates divide a gradient by its own size, AdamW's ``lr g /
    (|g| + eps)``, Adafactor's by its factored RMS, which for a one-row
    leaf is ``|g|``: fed the held-once gradients instead, a rounding-sized
    difference of a gradient near 0 would move its update by up to
    ``2 lr``; ``tests/test_torch_lm_mesh.py`` holds the whole own-shards
    step against the reference's under its level-flip rule);
  * every piece of the new parameters, gradients and state its position's
    ``devices_indices_map`` slice under ``param_specs`` of its tree, no
    position holding a whole split leaf;
  * two microbatches equal to one batch within 2e-5;
  * the compressed gradients bit for bit ``compress_grads_crosspod`` of
    the gathered gradients, the cross-pod all-reduce recorded at int8
    bytes;
  * every move recorded in forward and backward (the bytes moved across
    positions are the records' crossing bytes), the recompute's moves
    recorded again under remat, each move's backward its transpose;
  * ``TrainLoop`` with ``fail_at``: the restored continuation bit for bit
    the uninterrupted run; a save on (2, 4) restored onto (2, 2, 2) as
    pieces and held once, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_lm_mesh import TRAIN_MESH, family_config
from test_torch_lm_spmd import _CROSSING, _recorded

from repro_torch import configs
from repro_torch.dist import collectives as C
from repro_torch.dist.compression import compress_grads_crosspod
from repro_torch.dist.sharding import (Mesh, NamedSharding, P, Sharded,
                                       make_plan, own_spec, param_specs,
                                       shard_tensor)
from repro_torch.launch.mesh import make_position_mesh
from repro_torch.models import get_bundle
from repro_torch.train.data import batch_for
from repro_torch.train.optimizer import (OptimizerConfig, global_norm,
                                         make_optimizer)
from repro_torch.train.trainer import (_whole_grads, init_state,
                                       loss_and_grads, make_train_step,
                                       place_state)
from repro_torch.train.tree import tree_flatten_with_path, tree_leaves

SCOUT = "llama4-scout-17b-a16e"
FAMILIES = ["olmo-1b", "qwen2-7b", SCOUT, "mamba2-2.7b", "mamba2-2.7b:cp",
            "zamba2-2.7b", "seamless-m4t-large-v2"]
MESHES = {"1x4": (("data", 1), ("model", 4)),
          "2x4": (("data", 2), ("model", 4)),
          "2x2x2": TRAIN_MESH}
SHAPE = configs.ShapeConfig("own", 16, 4, "train")
TOL = 1e-5
#: gradients: zamba2's ``conv_b`` on (2, 2, 2) lands at 1.01e-5 of its
#: largest (the scan's sums taken over positions in another order)
GRAD_TOL = 2e-5
MICRO_TOL = 2e-5
OPT = dict(lr=1e-2, warmup_steps=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: the own-shards path runs many
    small ops a step, which one thread runs faster than several, and
    parallel test workers then do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _every_leaf_split(monkeypatch):
    from repro_torch.dist import sharding
    monkeypatch.setattr(sharding, "_MIN_SHARD_SIZE", 1)


def _config(name: str):
    cfg = family_config(configs, name)
    if cfg.shared_attn_every:          # two blocks: the LoRA goes by block
        cfg = dataclasses.replace(cfg, num_layers=2 * cfg.block_period)
    return cfg


def _batch(cfg, seed: int = 0) -> dict:
    return {k: (torch.from_numpy(v) if v.dtype.kind == "f"
                else torch.from_numpy(v).long())
            for k, v in batch_for(cfg, SHAPE, 0, seed=seed).items()}


def _gather(x):
    return C.gather_to(x, "cpu") if isinstance(x, Sharded) else x


def _flat(tree) -> list:
    return [(("/".join(str(k) for k in path)), x)
            for path, x in tree_flatten_with_path(tree)]


def _check_pieces(tree, mesh) -> int:
    """Every ``Sharded`` leaf held by ``param_specs`` of ``tree``, each
    piece its position's ``devices_indices_map`` slice, no position
    holding a whole split leaf; returns the count of split leaves."""
    split = 0
    for (name, x), (_, spec) in zip(_flat(tree), _flat(param_specs(tree,
                                                                   mesh))):
        whole = _gather(x)
        assert x.spec == own_spec(spec, whole.shape, mesh), name
        slices = NamedSharding(mesh, x.spec).devices_indices_map(whole.shape)
        assert list(slices) == list(x.pieces)
        for pos, idx in slices.items():
            assert torch.equal(x.pieces[pos], whole[idx]), name
        if any(x.entry(d) for d in range(x.ndim)):
            split += 1
            assert all(t.numel() < whole.numel()
                       for t in x.pieces.values()), name
    return split


def _within(got, want, tol: float, what: str) -> None:
    """Each leaf of ``got`` (pieces gathered) within ``tol`` of the largest
    magnitude of ``want``'s leaf."""
    for (name, g), (_, w) in zip(_flat(got), _flat(want)):
        err = float((_gather(g) - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-30), \
            (what, name, err, float(w.abs().max()))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", FAMILIES)
def test_own_shards_step_matches_held_once(name, mesh_name):
    """Loss and each leaf's gradient over own shards against the held-once
    step on the same positions; one AdamW and one Adafactor update over
    the pieces against the held-once optimizer on the same gradients;
    every piece of the gradients and the new state its
    ``devices_indices_map`` slice."""
    cfg = _config(name)
    mesh = make_position_mesh(MESHES[mesh_name], "cpu")
    held = make_plan(cfg, mesh)
    own = make_plan(cfg, mesh, own_shards=True)
    adamw = make_optimizer(OptimizerConfig(**OPT))
    state = init_state(cfg, adamw, torch.Generator().manual_seed(3),
                       dtype=torch.float32, device="cpu")
    batch = _batch(cfg)
    want_loss, want_g = loss_and_grads(cfg, state["params"], batch, held)
    placed = place_state(state, mesh, own_shards=True)
    assert _check_pieces(placed["params"], mesh) >= 4
    loss, grads = loss_and_grads(cfg, placed["params"], batch, own)
    grads = _whole_grads(grads, own, compress=False)
    assert abs(float(loss) - float(want_loss)) <= TOL * abs(float(want_loss))
    _within(grads, want_g, GRAD_TOL, "grad")
    sizes = {int(mesh.shape[a]) for a in mesh.axis_names} | {mesh.size}
    for (nm, g), (_, w) in zip(_flat(grads), _flat(want_g)):
        ratio = float(_gather(g).norm()) / max(float(w.norm()), 1e-30)
        assert abs(ratio - 1) < 1e-3 or float(w.norm()) == 0, (nm, ratio)
        assert not any(abs(ratio - n) < 1e-3 for n in sizes if n > 1)
    _check_pieces(grads, mesh)
    assert abs(float(_gather(global_norm(grads))) -
               float(global_norm(want_g))) <= TOL * float(
                   global_norm(want_g))

    # each optimizer over the pieces against the held-once one fed the same
    # gradients, gathered: what differs is the optimizer's own reductions
    whole_g = {nm: _gather(g) for nm, g in _flat(grads)}
    whole_g = _unflat(want_g, whole_g)
    ada = make_optimizer(OptimizerConfig(name="adafactor", **OPT))
    for opt, opt_state in ((adamw, state["opt"]),
                           (ada, ada.init(state["params"]))):
        pl = place_state({**state, "opt": opt_state}, mesh, own_shards=True)
        new, st = opt.update(grads, pl["opt"], pl["params"], pl["step"])
        w_new, w_st = opt.update(whole_g, opt_state, state["params"],
                                 state["step"])
        assert abs(float(_gather(st.pop("gnorm"))) - float(
            w_st.pop("gnorm"))) <= TOL * float(_gather(global_norm(grads)))
        for (nm, g), (_, o), (_, w) in zip(_flat(new), _flat(state["params"]),
                                           _flat(w_new)):
            upd = w - o
            ulps = 2 * torch.finfo(o.dtype).eps * float(o.abs().max())
            assert float(((_gather(g) - o) - upd).abs().max()) <= TOL * max(
                float(upd.abs().max()), 1e-30) + ulps, (opt.cfg.name, nm)
        _within(st, w_st, TOL, opt.cfg.name)
        _check_pieces(new, mesh)
        _check_pieces(st, mesh)


def _unflat(like, flat: dict):
    """``like``'s structure with ``flat``'s leaves (by joined path)."""
    from repro_torch.train.tree import tree_map_with_path
    return tree_map_with_path(lambda path, _: flat["/".join(
        str(k) for k in path)], like)


@pytest.mark.parametrize("name", FAMILIES)
def test_own_shards_microbatches_equal_one_batch(name):
    """``make_train_step`` over own shards on (2, 4) with two microbatches
    against one batch (the gradients accumulated piece by piece in f32),
    SGD: every new parameter within 2e-5, the loss within 1e-5.  The MoE
    runs at ``capacity_factor`` E (no drops): a microbatch's EP blocks
    hold half the tokens, so with drops they keep another set."""
    cfg = _config(name)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    mesh = make_position_mesh(MESHES["2x4"], "cpu")
    own = make_plan(cfg, mesh, own_shards=True)
    sgd = make_optimizer(OptimizerConfig(name="sgd", lr=1e-2,
                                         warmup_steps=0, grad_clip=1e9))
    state = place_state(init_state(cfg, sgd, torch.Generator().manual_seed(4),
                                   dtype=torch.float32, device="cpu"),
                        mesh, own_shards=True)
    batch = batch_for(cfg, configs.ShapeConfig("m", 16, 8, "train"), 0)
    one, m1 = make_train_step(cfg, sgd, own)(state, batch)
    two, m2 = make_train_step(cfg, sgd, own, microbatches=2)(state, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= \
        TOL * abs(float(m1["loss"]))
    for (nm, a), (_, b) in zip(_flat(one["params"]), _flat(two["params"])):
        assert a.spec == b.spec
        assert float((_gather(a) - _gather(b)).abs().max()) < MICRO_TOL, nm
    assert int(two["step"].first) == 1 and two["step"].spec == P()


@pytest.mark.parametrize("name", ["olmo-1b", SCOUT])
def test_own_shards_compressed_grads_bit_for_bit(name):
    """On (pod 2, data 2, model 2): the reduced gradients' int8 round trip
    (each leaf's scale the pmax of its distinct slices' max-abs) bit for
    bit ``compress_grads_crosspod`` of the gathered gradients; the step
    with ``grad_compress`` records the cross-pod all-reduce of each
    floating leaf at its int8 levels and scale, and its gnorm is the one
    over the round-tripped gradients."""
    cfg = _config(name)
    mesh = make_position_mesh(TRAIN_MESH, "cpu")
    own = make_plan(cfg, mesh, own_shards=True)
    opt = make_optimizer(OptimizerConfig(**OPT))
    state = place_state(init_state(cfg, opt, torch.Generator().manual_seed(5),
                                   dtype=torch.float32, device="cpu"),
                        mesh, own_shards=True)
    batch = _batch(cfg, seed=1)
    _, grads = loss_and_grads(cfg, state["params"], batch, own)
    grads = _whole_grads(grads, own, compress=True)
    sent = compress_grads_crosspod(grads, mesh)
    whole = {name_: _gather(g) for name_, g in _flat(grads)}
    want = compress_grads_crosspod(whole, None)
    for name_, g in _flat(sent):
        got = _gather(g)
        assert got.numpy().tobytes() == want[name_].numpy().tobytes(), name_
        assert not torch.equal(got, whole[name_])
    _check_pieces(sent, mesh)
    records, _ = _recorded(lambda: make_train_step(
        cfg, opt, own, grad_compress=True)(state, batch))
    pod = [r for r in records if r[0] == "all-reduce" and r[2] == 2
           and r[1] in {x.first.numel() + 4 for x in tree_leaves(grads)}]
    assert len(pod) >= len(tree_leaves(grads))
    _, m = make_train_step(cfg, opt, own, grad_compress=True)(state, batch)
    assert abs(float(m["gnorm"]) - float(global_norm(want))) <= \
        TOL * float(m["gnorm"])


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2-7b", SCOUT,
                                  "mamba2-2.7b:cp", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_own_shards_train_moves_are_recorded(name):
    """Over a loss and its gradients on (2, 4), the bytes the collectives
    moved across positions, forward and backward, are the recorded
    collectives' crossing bytes (no move unrecorded); the backward's
    transposes appear (the FSDP gathers' reduce-scatters, EP's all-to-alls
    twice each way); under remat the recompute records its moves again."""
    cfg = _config(name)
    mesh = make_position_mesh(MESHES["2x4"], "cpu")
    own = make_plan(cfg, mesh, own_shards=True)
    params = place_state({"params": init_state(
        cfg, make_optimizer(OptimizerConfig(name="sgd")),
        torch.Generator().manual_seed(6), dtype=torch.float32,
        device="cpu")["params"], "opt": {}, "step": torch.zeros(())},
        mesh, own_shards=True)["params"]
    batch = _batch(cfg, seed=2)

    def fwd_only():
        with torch.no_grad():
            get_bundle(cfg).loss(cfg, params, batch, own)

    fwd, fwd_moved = _recorded(fwd_only)
    both, moved = _recorded(lambda: loss_and_grads(cfg, params, batch, own))
    assert moved == sum(_CROSSING[k](r, g, n) for k, r, g, n in both) > \
        fwd_moved == sum(_CROSSING[k](r, g, n) for k, r, g, n in fwd)
    kinds = [r[0] for r in both]
    fwd_kinds, back = kinds[:len(fwd)], kinds[len(fwd):]
    assert fwd_kinds == [r[0] for r in fwd]
    # each backward move is the transpose of a forward one that carried a
    # gradient: FSDP gathers -> reduce-scatters, and so on
    transpose = {"all-gather": "reduce-scatter",
                 "reduce-scatter": "all-gather", "all-to-all": "all-to-all",
                 "all-reduce": "all-reduce",
                 "collective-permute": "all-reduce"}
    for kind in set(back):
        assert back.count(kind) <= sum(fwd_kinds.count(k) for k, t in
                                       transpose.items() if t == kind)
    assert back.count("reduce-scatter") > 0
    if cfg.num_experts:
        assert back.count("all-to-all") == fwd_kinds.count("all-to-all") > 0
    remat = dataclasses.replace(cfg, remat=True, remat_policy="full")
    again, again_moved = _recorded(lambda: loss_and_grads(remat, params,
                                                          batch, own))
    assert len(again) > len(both) and again_moved > moved
    assert again_moved == sum(_CROSSING[k](r, g, n)
                              for k, r, g, n in again)


def test_moves_backward_is_the_transpose():
    """Each move's backward (through ``_Move``) gives the gradients plain
    autograd gives through the same move's ops (each its exact adjoint),
    for a chain of every move on (pod 2, data 2, model 2), in f64; and the
    norm counts a replicated piece once."""
    mesh = make_position_mesh(TRAIN_MESH, "cpu")
    t = torch.randn(4, 8, 12, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(7))

    def run():
        x = shard_tensor(t, mesh, P(("pod", "data"), None, "model")).map(
            lambda pos, u: u.requires_grad_(True))
        a = C.all_gather(x, 2).map(lambda pos, u: u * (1 + pos[2]))
        b = C.broadcast(C.reduce_scatter(a, ("model",), 1), ("pod",), 1)
        s = C.psum(b.map(lambda pos, u: u.sin()), ("data",))
        y = C.relayout(s, P(None, ("pod", "data", "model"), None))
        z = C.all_to_all(C.relayout(y, P(None, "model", "pod")), 2, 1)
        loss = sum((v * v.cos()).sum() * (1 + k)
                   for k, v in enumerate(z.pieces.values()))
        got = torch.autograd.grad(loss, list(x.pieces.values()),
                                  allow_unused=True)
        return [torch.zeros_like(u) if g is None else g
                for g, u in zip(got, x.pieces.values())]

    records, _ = _recorded(run)
    through = run()
    plain_move = C._move
    C._move = lambda fwd, bwd, x: fwd(x)
    try:
        plain = run()
    finally:
        C._move = plain_move
    assert all(torch.allclose(a, b, rtol=1e-12, atol=1e-12)
               for a, b in zip(through, plain))
    # forward: gather, reduce-scatter, permute, all-reduce, then the
    # relayouts' gathers and all-to-alls; backward: each one's transpose
    assert {"all-gather", "reduce-scatter", "all-to-all", "all-reduce",
            "collective-permute"} <= {r[0] for r in records}
    w = shard_tensor(torch.arange(6.0).reshape(2, 3), mesh, P("data", None))
    assert float(_gather(global_norm({"w": w}))) == \
        float(torch.arange(6.0).norm())


def test_own_shards_train_loop_restores_bit_for_bit(tmp_path):
    """``TrainLoop`` over own shards on (2, 4): a failure at step 5, the
    restore (as pieces) from the step-3 checkpoint and the rest of the
    steps bit for bit the uninterrupted run, losses equal; the final save
    restored onto (2, 2, 2) as pieces and onto a held-once plan equal to
    the saved leaves bit for bit."""
    from repro_torch.train import checkpoint as K
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.fault import FailureInjector, TrainLoop
    cfg = _config("olmo-1b")
    mesh = make_position_mesh(MESHES["2x4"], "cpu")
    own = make_plan(cfg, mesh, own_shards=True)
    opt = make_optimizer(OptimizerConfig(lr=1e-3, warmup_steps=2))
    dc = DataConfig(seed=5, vocab_size=cfg.vocab_size, batch=4, seq_len=16)

    def fresh():
        return place_state(init_state(cfg, opt,
                                      torch.Generator().manual_seed(8),
                                      dtype=torch.float32, device="cpu"),
                           mesh, own_shards=True)

    def loop(ckpt_dir=None, injector=None):
        return TrainLoop(make_train_step(cfg, opt, own),
                         lambda k: synthetic_batch(dc, k), ckpt_dir=ckpt_dir,
                         ckpt_every=3, injector=injector)

    straight, report = loop().run(fresh(), 7)
    faulty = loop(str(tmp_path), FailureInjector(fail_at=5))
    with pytest.raises(RuntimeError, match="injected node failure"):
        faulty.run(fresh(), 7)
    restored, step = faulty.restore(fresh(), mesh=mesh, own_shards=True)
    assert step == 3
    assert all(isinstance(x, Sharded) for x in tree_leaves(restored))
    resumed, rep2 = faulty.run(restored, 7 - step, start_step=step)
    assert rep2.losses == report.losses[step:]
    for (nm, a), (_, b) in zip(_flat(resumed), _flat(straight)):
        assert a.spec == b.spec, nm
        assert all(torch.equal(a.pieces[q], b.pieces[q]) for q in a.pieces)
    saved = {nm: _gather(x) for nm, x in _flat(straight)}
    m3 = make_position_mesh(TRAIN_MESH, "cpu")
    pieces, at = K.restore_checkpoint(str(tmp_path), straight, mesh=m3,
                                      own_shards=True)
    held, _ = K.restore_checkpoint(str(tmp_path), straight, mesh=m3)
    assert at == 7
    _check_pieces({"params": pieces["params"]}, m3)
    for (nm, x), (_, h) in zip(_flat(pieces), _flat(held)):
        assert x.mesh is m3 and not isinstance(h, Sharded)
        assert _gather(x).numpy().tobytes() == saved[nm].numpy().tobytes()
        assert h.numpy().tobytes() == saved[nm].numpy().tobytes()
    two = Mesh([[torch.device("cpu", 0), torch.device("cpu", 1)]],
               ("data", "model"))
    dist, _ = faulty.restore(straight, mesh=two)
    assert all(isinstance(x, Sharded) for x in tree_leaves(dist))
    assert np.array_equal(_gather(dist["params"]["embed"]).numpy(),
                          saved["params/embed"].numpy())
