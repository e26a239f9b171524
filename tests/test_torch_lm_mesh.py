"""Port parity: the LM on a mesh (``repro_torch.dist.sharding``'s LM half,
``launch/mesh.make_production_mesh``, the mesh paths of
``models/{layers,lm,ssd,encdec}.py``, ``train/trainer.py``,
``train/checkpoint.py`` and ``serve/engine.py``).

The reference's LM mesh runs only with forced host devices, so its half of
the comparison runs in ONE subprocess (this file run as a script, with
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``),
started when the module's first test asks for it and read by the tests
that need it; a failure or a timeout of that process fails them.  Its
meshes are built as ``jax.sharding.Mesh`` over the host devices (Auto
axes): the reference's own ``make_local_mesh`` gives Explicit axes under
this jax, on which its LM cannot run (pinned below).  The port's mesh is
eight explicit ``"cpu"`` positions; the reference's f32 weights and
states cross by ``params_from_arrays`` / ``state_from_arrays``.

  * specs, pure data: every field of ``make_plan`` for all ten configs on
    {data 16, model 16}, {pod 2, data 16, model 16} and {data 2, model 4}
    with ``decode_batch`` None, 1 and 64; ``param_specs`` of every
    config's full-width parameter tree and its AdamW and Adafactor states
    (the port's on meta tensors, so nothing is allocated);
    ``cache_specs`` and ``batch_specs``: all equal to the reference's;
    each placement's index slices equal ``devices_indices_map`` on (2, 4)
    and (2, 2, 2), position by position;
  * forward and decode at reduced width on (2, 4) within 1e-5: prefill and
    one decode step for olmo (tp), qwen2 (cp), mamba2, zamba2 and
    seamless; llama4-scout's EP prefill with capacity drops (the outputs
    and the kept set) and its EP decode; an uneven block raising
    ``ValueError`` in both packages;
  * training: one AdamW step with ``grad_compress`` on (2, 2, 2) for olmo
    and llama4-scout, at an lr whose first update is far above the limits
    -- loss and gnorm within tolerance, each leaf's update within
    tolerance wherever both packages' int8 gradient levels agree, and a
    pinned bound on the count of elements where they do not; the
    uncompressed step missing the gnorm and update limits;
    ``compress_grads_crosspod`` bit for bit on the same arrays;
    ``restore_checkpoint(mesh=)`` of the reference's checkpoint bit for
    bit the reference's own reshard;
  * the port alone: ``shard``'s checks, an LM mesh over distinct cards
    raising ``NotImplementedError`` naming item 13g, the production
    meshes, the placed and undonated ``jit_train_step``, a serving engine
    on a mesh plan against the single-request loop under that plan.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT_S = 300
TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["yi-34b", "olmo-1b", "qwen2-7b", "minitron-4b", "mamba2-2.7b",
         "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
         "seamless-m4t-large-v2", "zamba2-2.7b", "chameleon-34b"]
SCOUT = "llama4-scout-17b-a16e"
#: the spec meshes: (axis, size) pairs
SPEC_MESHES = {"16x16": (("data", 16), ("model", 16)),
               "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
               "2x4": (("data", 2), ("model", 4))}
DECODE_BATCHES = (None, 1, 64)
RUN_MESH = (("data", 2), ("model", 4))
TRAIN_MESH = (("pod", 2), ("data", 2), ("model", 2))
FWD_ARCHS = ["olmo-1b", "qwen2-7b", "mamba2-2.7b", "zamba2-2.7b",
             "seamless-m4t-large-v2"]
B, S, CTX = 2, 16, 20
ED_FRAMES, ED_TOKENS = 16, 4
TRAIN_SHAPE = (64, 4)            # (seq, batch): the EP blocks divide
#: placements held against devices_indices_map: (spec, shape), a spec
#: naming pod only on the (2, 2, 2) mesh
PLACEMENTS = [(("data", None, "model"), (4, 6, 8)),
              (("data", "model", None), (2, 8, 3)),
              ((None, ("data", "model"), None, None), (3, 16, 2, 2)),
              (("model", "data", None), (8, 4, 5)),
              ((None, "data"), (5, 6)),
              ((), (3, 5)),
              ((("pod", "data"), None, "model"), (4, 3, 6))]
#: the train step: elements whose int8 gradient level differs between the
#: packages (1-ulp gradient differences crossing a rounding boundary),
#: at most this many in a tree
LEVEL_FLIPS_MAX = 64
#: the train step's optimizer: lr 1e-2 from step 0 (warmup 1), so AdamW's
#: first update, about lr x sign(g), is 1e-2 an element and the limit below
#: 1e-5; the default config's first update (3e-6) would be under it, and a
#: step that applied none would pass
TRAIN_OPT = dict(lr=1e-2, warmup_steps=1)
#: the update new - old of each leaf held, where both packages' int8 levels
#: agree, within UPDATE_RTOL x the reference's largest update of that leaf
UPDATE_RTOL = 1e-3
#: gnorm (over the compressed gradients) within this relative limit, below
#: the gap between the compressed and uncompressed gnorm (olmo: 4.5e-5
#: relative); the test shows the uncompressed step falls outside it
GNORM_RTOL = 1e-5


def _entry(e):
    """A spec entry as JSON: None, a name or a list of names."""
    return list(e) if isinstance(e, tuple) else e


def _spec_json(spec) -> list:
    return [_entry(e) for e in tuple(spec)]


def _plan_json(plan) -> dict:
    return {"attn_mode": plan.attn_mode, "data_axes": list(plan.data_axes),
            "model_axis": plan.model_axis,
            **{f: _spec_json(getattr(plan, f)) for f in
               ("hidden", "decode_hidden", "qkv", "kv_ctx", "decode_cache",
                "ssm_state")}}


class FakeMesh:
    """Any object with ``.shape`` / ``.axis_names``: the spec functions of
    both packages take one."""

    def __init__(self, pairs):
        self.axis_names = tuple(a for a, _ in pairs)
        self.shape = dict(pairs)


# -- the reference's half (run as a script) -------------------------------------


def _skeleton(tree):
    """A nested dict's structure, leaves as 0 (empty dicts kept)."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    return 0


def _put_tree(out: dict, name: str, tree) -> None:
    """Save a tree of arrays into ``out``: its skeleton as JSON and each
    leaf under ``name/path``."""
    out[f"{name}#tree"] = np.array(json.dumps(_skeleton(tree)))

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}")
        else:
            out[prefix] = np.asarray(node)
    walk(tree, name)


def _reference_main(out_path: str, part: str) -> None:
    """One part of the reference's results into ``out_path``: ``forward``
    (the specs, the placements, forward and decode of three configs, the
    pinned local-mesh defect), ``forward-moe`` (the other three, and
    llama4-scout's MoE layer) or one train step of ``olmo-1b`` or
    ``SCOUT``.  The parts run as four processes at once."""
    import jax
    from jax.sharding import Mesh as JMesh

    out: dict = {}
    key = jax.random.PRNGKey(0)

    def auto_mesh(pairs):
        shape = tuple(n for _, n in pairs)
        devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
        return JMesh(devs, tuple(a for a, _ in pairs))

    run_mesh, train_mesh = auto_mesh(RUN_MESH), auto_mesh(TRAIN_MESH)
    if part == "forward":
        _reference_specs(out, key)
        _reference_forward(out, key, run_mesh, train_mesh,
                           FWD_ARCHS[:3], seed=0)
    elif part == "forward-moe":
        _reference_forward(out, key, run_mesh, None,
                           FWD_ARCHS[3:] + [SCOUT], seed=1)
    else:
        _reference_train(out, key, part, train_mesh,
                         os.path.join(os.path.dirname(out_path), "ckpt"))
    np.savez(out_path, **out)


def _reference_specs(out: dict, key) -> None:
    """Every spec function on the full-width configs (shapes only)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro import configs as jconfigs
    from repro.dist import sharding as JS
    from repro.models import get_bundle as jget_bundle
    from repro.train.optimizer import OptimizerConfig, make_optimizer

    def flat_specs(tree) -> dict:
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): _spec_json(s) for path, s in leaves}

    specs: dict = {}
    for arch in ARCHS:
        cfg = jconfigs.get_config(arch)
        bundle = jget_bundle(cfg)
        params = jax.eval_shape(functools.partial(
            bundle.init, cfg, dtype=jnp.bfloat16), key)
        states = {name: jax.eval_shape(
            make_optimizer(OptimizerConfig(name=name)).init, params)
            for name in ("adamw", "adafactor")}
        caches = jax.eval_shape(lambda: bundle.init_caches(cfg, 4, 32))
        for mname, pairs in SPEC_MESHES.items():
            mesh = FakeMesh(pairs)
            entry = specs.setdefault(arch, {}).setdefault(mname, {})
            entry["params"] = flat_specs(JS.param_specs(params, mesh))
            for name, st in states.items():
                entry[name] = flat_specs(JS.param_specs(st, mesh))
            for db in DECODE_BATCHES:
                plan = JS.make_plan(cfg, mesh, decode_batch=db)
                entry[f"plan/{db}"] = _plan_json(plan)
                entry[f"caches/{db}"] = flat_specs(JS.cache_specs(caches,
                                                                  plan))
                entry[f"batch/{db}"] = {k: _spec_json(v) for k, v in
                                        JS.batch_specs(plan).items()}
    out["specs"] = np.array(json.dumps(specs))


def _reference_forward(out: dict, key, run_mesh, train_mesh, archs,
                       *, seed: int) -> None:
    """Prefill and one decode step of ``archs`` on (2, 4); with
    ``train_mesh`` also the placements and the local-mesh defect, with
    llama4-scout among ``archs`` its MoE layer alone."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro import configs as jconfigs
    from repro.dist import sharding as JS
    from repro.launch import mesh as JLaunch
    from repro.models import encdec as JED
    from repro.models import get_bundle as jget_bundle
    from repro.models import layers as JL
    from repro.models import lm as JLM

    def init(cfg):
        """f32 weights, one compiled program a config (eager init would
        compile each op on its own)."""
        return jax.jit(functools.partial(jget_bundle(cfg).init, cfg,
                                         dtype=jnp.float32))(key)

    # -- placements ----------------------------------------------------------
    for mname, mesh in ((("2x4", run_mesh), ("2x2x2", train_mesh))
                        if train_mesh is not None else ()):
        got = []
        for spec, shape in PLACEMENTS:
            if "pod" in json.dumps(spec) and "pod" not in mesh.axis_names:
                got.append(None)
                continue
            m = jax.sharding.NamedSharding(mesh, JP(*spec)) \
                .devices_indices_map(shape)
            got.append([[[s.start, s.stop] for s in m[d]]
                        for d in mesh.devices.flat])
        out[f"placements/{mname}"] = np.array(json.dumps(got))

    # -- forward and decode on (2, 4) ---------------------------------------
    r = np.random.default_rng(seed)
    for arch in archs:
        cfg = jconfigs.reduced(jconfigs.get_config(arch))
        params = init(cfg)
        _put_tree(out, f"w/{arch}", jax.tree_util.tree_map(np.asarray,
                                                            params))
        splan = JS.make_plan(cfg, run_mesh, decode_batch=B)
        if cfg.encoder_layers:
            frames = r.normal(size=(B, ED_FRAMES, cfg.d_model)).astype(
                np.float32)
            toks = r.integers(0, cfg.vocab_size, (B, ED_TOKENS + 1))
            out[f"in/{arch}/frames"] = frames
            pre = jax.jit(lambda p, f, t: JED.encdec_prefill(
                cfg, p, f, t, splan=splan))
            logits, caches = pre(params, frames, toks[:, :ED_TOKENS])
            dec = jax.jit(lambda p, c, t: JED.encdec_decode(
                cfg, p, c, t, splan=splan))
        else:
            toks = r.integers(0, cfg.vocab_size, (B, S + 1))
            pre = jax.jit(lambda p, t: JLM.lm_prefill(
                cfg, p, t, splan=splan, ctx=CTX))
            logits, caches = pre(params, toks[:, :S])
            dec = jax.jit(lambda p, c, t: JLM.lm_decode(
                cfg, p, c, t, splan=splan))
        n = ED_TOKENS if cfg.encoder_layers else S
        out[f"in/{arch}/tokens"] = toks.astype(np.int32)
        out[f"out/{arch}/prefill"] = np.asarray(logits)
        _put_tree(out, f"out/{arch}/caches",
                  jax.tree_util.tree_map(np.asarray, caches))
        logits, caches = dec(params, caches, toks[:, n:n + 1])
        out[f"out/{arch}/decode"] = np.asarray(logits)
        _put_tree(out, f"out/{arch}/decode_caches",
                  jax.tree_util.tree_map(np.asarray, caches))

    if SCOUT in archs:
        _reference_moe(out, init, r, run_mesh)
    if train_mesh is None:
        return

    # -- the reference's own local mesh cannot run its LM --------------------
    local = JLaunch.make_local_mesh(2, 4)
    try:
        jax.jit(lambda v: JL.shard(v, JP("data"), local))(jnp.zeros((4, 4)))
        msg = ""
    except Exception as exc:                   # noqa: BLE001 (recorded)
        msg = f"{type(exc).__name__}: {exc}"
    out["local_mesh"] = np.array(json.dumps({
        "axis_types": [str(t) for t in getattr(local, "axis_types", ())],
        "error": msg}))


def _reference_moe(out: dict, init, r, run_mesh) -> None:
    """llama4-scout's MoE layer alone: EP prefill at the config's capacity
    (with and without the shared expert: without it, a dropped token's row
    is exactly 0), EP decode, and the uneven blocks."""
    import jax

    from repro import configs as jconfigs
    from repro.dist import sharding as JS
    from repro.models import layers as JL

    cfg = jconfigs.reduced(jconfigs.get_config(SCOUT))
    moe = jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                 init(cfg)["blocks"]["p0"]["moe"])
    x = r.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    out["moe/x"] = x
    splan = JS.make_plan(cfg, run_mesh, decode_batch=B)
    routed = dataclasses.replace(cfg, shared_expert=False)
    for name, c in (("ep", cfg), ("routed", routed)):
        out[f"moe/{name}"] = np.asarray(jax.jit(
            lambda p, v, c=c: JL.apply_moe(c, p, v, splan=splan))(moe, x))
    out["moe/decode"] = np.asarray(jax.jit(
        lambda p, v: JL.moe_decode(cfg, p, v, splan=splan))(moe, x[:, :1]))
    raised = {}
    for name, fn in (
            ("prefill", lambda: jax.jit(lambda p, v: JL.apply_moe(
                cfg, p, v, splan=splan))(moe, x[:1])),
            ("decode", lambda: jax.jit(lambda p, v: JL.moe_decode(
                cfg, p, v, splan=JS.make_plan(cfg, run_mesh)))(moe,
                                                               x[:1, :1]))):
        try:
            fn()
            raised[name] = None
        except Exception as exc:               # noqa: BLE001 (recorded)
            raised[name] = type(exc).__name__
    out["moe/raised"] = np.array(json.dumps(raised))


def _reference_train(out: dict, key, arch: str, train_mesh,
                     ckpt: str) -> None:
    """One f32 AdamW step with grad_compress on (2, 2, 2), with the
    gradients it compresses; olmo's new state saved and restored onto the
    mesh."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.dist import compression as JC
    from repro.dist import sharding as JS
    from repro.models import get_bundle as jget_bundle
    from repro.train import checkpoint as JK
    from repro.train.data import batch_for
    from repro.train.optimizer import OptimizerConfig, make_optimizer
    from repro.train.trainer import init_state, make_train_step

    opt = make_optimizer(OptimizerConfig(**TRAIN_OPT))
    cfg = jconfigs.reduced(jconfigs.get_config(arch))
    state = jax.jit(functools.partial(init_state, cfg, opt,
                                      dtype=jnp.float32))(key)
    _put_tree(out, f"state/{arch}", jax.tree_util.tree_map(np.asarray,
                                                           state))
    batch = batch_for(cfg, jconfigs.ShapeConfig("mesh", *TRAIN_SHAPE,
                                                "train"), 0, seed=0)
    splan = JS.make_plan(cfg, train_mesh)
    bundle = jget_bundle(cfg)
    step = make_train_step(cfg, opt, splan, grad_compress=True)

    def both(st, bt):
        """The step, and the gradients it compresses with their int8
        levels."""
        grads = jax.grad(lambda p: bundle.loss(cfg, p, bt, splan))(
            st["params"])
        return (step(st, bt), grads,
                jax.tree_util.tree_map(lambda g: JC.quantize_int8(g)[0],
                                       grads))

    with train_mesh:
        (new, metrics), grads, levels = jax.jit(both)(state, batch)
    # eager, on one device: the compiled round trip inside the jitted step
    # can land one ulp off the eager one, which the port's matches
    grads = jax.tree_util.tree_map(np.asarray, grads)
    sent = JC.compress_grads_crosspod(grads, train_mesh)
    out[f"train/{arch}/loss"] = np.asarray(metrics["loss"])
    out[f"train/{arch}/gnorm"] = np.asarray(metrics["gnorm"])
    _put_tree(out, f"train/{arch}/params",
              jax.tree_util.tree_map(np.asarray, new["params"]))
    _put_tree(out, f"train/{arch}/grads",
              jax.tree_util.tree_map(np.asarray, grads))
    _put_tree(out, f"train/{arch}/levels",
              jax.tree_util.tree_map(np.asarray, levels))
    _put_tree(out, f"train/{arch}/compressed",
              jax.tree_util.tree_map(np.asarray, sent))
    if arch == "olmo-1b":
        JK.save_checkpoint(ckpt, new, 1)
        restored, _ = JK.restore_checkpoint(ckpt, new, mesh=train_mesh)
        _put_tree(out, "restored", jax.tree_util.tree_map(np.asarray,
                                                          restored))


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


# -- the port's half ----------------------------------------------------------

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.dist import compression as C  # noqa: E402
from repro_torch.dist.sharding import (Mesh, NamedSharding, P,  # noqa: E402
                                       ShardingPlan, batch_specs,
                                       cache_specs, make_plan, param_specs,
                                       tree_named)
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_position_mesh,
                                     make_production_mesh)
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import get_bundle  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.train import checkpoint as K  # noqa: E402
from repro_torch.train.data import batch_for  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         make_optimizer)
from repro_torch.train.trainer import (jit_train_step,  # noqa: E402
                                       make_train_step, state_from_arrays)
from repro_torch.train.tree import (tree_flatten_with_path,  # noqa: E402
                                    tree_leaves, tree_map, tree_unflatten)


PARTS = ("forward", "forward-moe", "olmo-1b", SCOUT)


@pytest.fixture(scope="module", autouse=True)
def _reference_procs(tmp_path_factory):
    """The reference's four parts, started as the module's tests start,
    so they run beside the tests that need no reference; stopped at the
    module's end if still running."""
    out = tmp_path_factory.mktemp("lm-mesh-reference")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for i, part in enumerate(PARTS):
        with open(out / f"{i}.err", "w") as err:
            procs[part] = subprocess.Popen(
                [sys.executable, __file__, str(out / f"{i}.npz"), part],
                env=env, cwd=str(ROOT), stdout=subprocess.DEVNULL,
                stderr=err)
    yield out, procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(_reference_procs):
    """The reference's mesh results (a dict of arrays), or the reason there
    are none."""
    out, procs = _reference_procs
    got: dict = {"#dir": str(out)}
    for i, (part, proc) in enumerate(procs.items()):
        try:
            proc.wait(timeout=REF_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            return f"the reference's {part} ran past {REF_TIMEOUT_S} s"
        if proc.returncode != 0:
            err = (out / f"{i}.err").read_text()
            return f"the reference's {part} failed:\n{err[-4000:]}"
        with np.load(out / f"{i}.npz") as z:
            got.update(z)
    return got


def _ref(reference) -> dict:
    if isinstance(reference, str):
        pytest.fail(reference)
    return reference


def _json(ref, name):
    return json.loads(str(ref[name]))


def _tree(ref: dict, name: str):
    """A tree saved by ``_put_tree``, as nested dicts of numpy arrays."""
    def fill(node, prefix):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}/{k}") for k, v in node.items()}
        return ref[prefix]
    return fill(_json(ref, f"{name}#tree"), name)


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, **tol) -> None:
    np.testing.assert_allclose(_np(got), np.asarray(want), **(tol or TOL))


def _close_to_scale(got, want) -> None:
    """Within rtol = 1e-5 and atol = 1e-5 x the output's largest magnitude:
    the MoE layer's outputs reach O(100) (the reference's fan-in scale on
    the expert weights), so a cancellation near 0 keeps that scale's f32
    rounding (``tests/test_torch_lm_families.py``'s rule)."""
    _close(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def _flat_specs(tree) -> dict:
    return {"/".join(path): _spec_json(s)
            for path, s in tree_flatten_with_path(tree)}


# -- the port alone: plans, shard, the meshes -------------------------------


def test_spec_functions_take_any_mesh_like_object():
    cfg = configs.get_config("olmo-1b")
    plan = make_plan(cfg, FakeMesh(SPEC_MESHES["2x16x16"]))
    assert plan.data_axes == ("pod", "data") and plan.attn_mode == "tp"
    assert plan.hidden == P(("pod", "data"), None, "model")
    assert plan.block_counts() == (32, 16)
    assert make_plan(cfg, None) == ShardingPlan() == make_plan(
        cfg, FakeMesh(()))
    assert P(("data",), None) == P("data", None)
    assert repr(P("data", None)) == "P('data', None)"


def test_shard_checks_as_the_reference_constraint():
    mesh = make_position_mesh(RUN_MESH, "cpu")
    x = torch.zeros(2, 3, 4)
    assert L.shard(x, P("data", None, "model"), mesh) is x
    assert L.shard(x, P(None, ("data", "model")), mesh) is x   # uneven: ok
    assert L.shard(x, None, mesh) is x and L.shard(x, P("pod"), None) is x
    for spec, what in ((P(None, None, None, None), "entries"),
                       (P("pod"), "not in the mesh"),
                       (P("data", "data"), "more than one")):
        with pytest.raises(ValueError, match=what):
            L.shard(x, spec, mesh)


def test_lm_mesh_over_distinct_cards_raises_13g(tmp_path):
    """A fake two-card grid, checked without a card."""
    cards = Mesh([[torch.device("cuda", 0), torch.device("cuda", 1)]],
                 ("data", "model"))
    cfg = configs.reduced(configs.get_config("olmo-1b"))
    opt = make_optimizer(OptimizerConfig())
    K.save_checkpoint(str(tmp_path), {"w": torch.zeros(2)}, 1)
    for call in (lambda: make_plan(cfg, cards),
                 lambda: jit_train_step(cfg, opt, cards),
                 lambda: NamedSharding(cards, P()).place(torch.zeros(1)),
                 lambda: K.restore_checkpoint(str(tmp_path),
                                              {"w": torch.zeros(2)},
                                              mesh=cards)):
        with pytest.raises(NotImplementedError, match="item 13g"):
            call()
    one_card = Mesh([[torch.device("cuda", 0)] * 2], ("data", "model"))
    assert make_plan(cfg, one_card).mesh is one_card


def test_production_meshes():
    mesh = make_production_mesh(devices=["cpu"] * 256)
    assert mesh.shape == {"data": 16, "model": 16}
    pods = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert pods.axis_names == ("pod", "data", "model")
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    plan = make_plan(configs.get_config("qwen2-7b"), pods)
    assert plan.attn_mode == "cp" and plan.data_axes == ("pod", "data")
    if torch.cuda.device_count() < 512:
        with pytest.raises(RuntimeError, match="distinct cards"):
            make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="takes 256 devices"):
        make_production_mesh(devices=["cpu"] * 8)
    assert make_local_mesh(1, 2, devices=["cpu"] * 2).shape == \
        {"data": 1, "model": 2}


def test_jit_train_step_places_and_donates_nothing():
    cfg = configs.reduced(configs.get_config("olmo-1b"))
    opt = make_optimizer(OptimizerConfig())
    from repro_torch.train.trainer import init_state
    state = init_state(cfg, opt, torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")
    before = tree_map(torch.clone, state)
    batch = batch_for(cfg, configs.ShapeConfig("m", 32, 4, "train"), 0)
    mesh = make_position_mesh(RUN_MESH, "cpu")
    step, splan = jit_train_step(cfg, opt, mesh)
    new, m = step(state, batch)
    assert splan == make_plan(cfg, mesh)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                 tree_leaves(before)))
    twin, tm = make_train_step(cfg, opt)(state, batch)
    # no pod axis: no compression, and a dense model's step is the twin's
    assert float(m["loss"]) == float(tm["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                 tree_leaves(twin)))


def test_full_width_trees_allocate_nothing():
    """Every config's full-width tree and optimizer states as meta
    tensors, the inputs of the spec tests below."""
    for arch in ARCHS:
        cfg, params, states, caches = _meta_trees(arch)
        for tree in (params, *states.values(), caches):
            assert all(t.device.type == "meta" for t in tree_leaves(tree))
        assert sum(t.numel() for t in tree_leaves(params)) > 1e9


# -- serving on a mesh plan ---------------------------------------------------------


def test_serve_engine_on_a_mesh_plan_matches_the_loop():
    """An EP model served through ``make_plan(cfg, mesh, slots)`` on a
    (data 1, model 4) mesh: token for token the single-request greedy loop
    under the same plan (the prefill's EP blocks at B = 1)."""
    from repro_torch.serve.engine import ServeEngine
    cfg = configs.reduced(configs.get_config(SCOUT))
    p = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(3),
                             dtype=torch.float32, device="cpu")
    mesh = make_position_mesh((("data", 1), ("model", 4)), "cpu")
    splan = make_plan(cfg, mesh, decode_batch=2)
    engine = ServeEngine(cfg, p, slots=2, max_ctx=48, prompt_buckets=(16,),
                         splan=splan, dtype=torch.float32, device="cpu")
    r = np.random.default_rng(4)
    prompts = [r.integers(0, cfg.vocab_size, int(n)) for n in (5, 9, 16)]
    uids = [engine.submit(q, max_new_tokens=6) for q in prompts]
    done = {q.uid: q.tokens for q in engine.run_until_drained()}
    for uid, q in zip(uids, prompts):
        toks = torch.zeros((1, 16), dtype=torch.long)
        toks[0, 16 - len(q):] = torch.from_numpy(q)
        logits, caches = LM.lm_prefill(cfg, p, toks, splan=splan, ctx=48)
        want = []
        while len(want) < 6:
            want.append(int(torch.argmax(logits[0])))
            logits, caches = LM.lm_decode(cfg, p, caches,
                                          torch.tensor([[want[-1]]]),
                                          splan=splan)
        assert done[uid] == want
    other = Mesh([[torch.device("meta")] * 4], ("data", "model"))
    with pytest.raises(ValueError, match="engine runs on"):
        ServeEngine(cfg, p, splan=make_plan(cfg, other), device="cpu")


# -- specs, pure data -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _meta_trees(arch: str):
    """The full-width parameter tree and its AdamW and Adafactor states on
    the meta device: shapes only, nothing allocated."""
    cfg = configs.get_config(arch)
    bundle = get_bundle(cfg)
    params = bundle.init(cfg, torch.Generator(), dtype=torch.bfloat16,
                         device="meta")
    states = {name: make_optimizer(OptimizerConfig(name=name)).init(params)
              for name in ("adamw", "adafactor")}
    caches = bundle.init_caches(cfg, 4, 32, device="meta")
    return cfg, params, states, caches


@pytest.mark.parametrize("arch", ARCHS)
def test_make_plan_matches_reference(reference, arch):
    want = _json(_ref(reference), "specs")[arch]
    cfg = configs.get_config(arch)
    for mname, pairs in SPEC_MESHES.items():
        for db in DECODE_BATCHES:
            plan = make_plan(cfg, FakeMesh(pairs), decode_batch=db)
            assert _plan_json(plan) == want[mname][f"plan/{db}"], \
                (mname, db)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(reference, arch):
    """The parameter tree and both optimizer states, on the three meshes;
    the port's trees are meta tensors."""
    want = _json(_ref(reference), "specs")[arch]
    _, params, states, _ = _meta_trees(arch)
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    for mname, pairs in SPEC_MESHES.items():
        mesh = FakeMesh(pairs)
        assert _flat_specs(param_specs(params, mesh)) == \
            want[mname]["params"], mname
        for name, st in states.items():
            assert _flat_specs(param_specs(st, mesh)) == want[mname][name], \
                (mname, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(reference, arch):
    want = _json(_ref(reference), "specs")[arch]
    cfg, _, _, caches = _meta_trees(arch)
    for mname, pairs in SPEC_MESHES.items():
        for db in DECODE_BATCHES:
            plan = make_plan(cfg, FakeMesh(pairs), decode_batch=db)
            assert _flat_specs(cache_specs(caches, plan)) == \
                want[mname][f"caches/{db}"], (mname, db)
            assert {k: _spec_json(v) for k, v in batch_specs(plan).items()} \
                == want[mname][f"batch/{db}"], (mname, db)


@pytest.mark.parametrize("mname,pairs", [("2x4", RUN_MESH),
                                         ("2x2x2", TRAIN_MESH)])
def test_placements_match_devices_indices_map(reference, mname, pairs):
    want = _json(_ref(reference), f"placements/{mname}")
    mesh = make_position_mesh(pairs, "cpu")
    for (spec, shape), w in zip(PLACEMENTS, want):
        if w is None:
            with pytest.raises(ValueError, match="not in the mesh"):
                NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
            continue
        got = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
        assert list(got) == list(np.ndindex(*mesh.devices.shape))
        assert [[[s.start, s.stop] for s in got[pos]] for pos in got] == w, \
            spec
    with pytest.raises(ValueError, match="evenly"):
        NamedSharding(mesh, P("model")).devices_indices_map((3, 5))
    # tree_named places every leaf once, on the mesh's one device
    placed = tree_map(lambda sh, t: sh.place(t),
                      tree_named(mesh, {"w": P("data"), "b": P()}),
                      {"w": torch.ones(4, 2), "b": torch.zeros(3)})
    assert placed["w"].device.type == "cpu" and placed["b"].shape == (3,)


# -- forward and decode on (2, 4) ---------------------------------------------


def _params(ref, arch):
    return LM.params_from_arrays(_tree(ref, f"w/{arch}"), device="cpu")


@pytest.mark.parametrize("arch", FWD_ARCHS + [SCOUT])
def test_prefill_and_decode_on_mesh_match_reference(reference, arch):
    """Logits and caches within 1e-5 after the prefill and one decode
    step; llama4-scout's prefill runs the EP dispatch with capacity drops
    and its decode the EP sum (``moe_decode_ep``)."""
    ref = _ref(reference)
    cfg = configs.reduced(configs.get_config(arch))
    p = _params(ref, arch)
    splan = make_plan(cfg, make_position_mesh(RUN_MESH, "cpu"),
                      decode_batch=B)
    toks = torch.from_numpy(ref[f"in/{arch}/tokens"]).long()
    if cfg.encoder_layers:
        frames = torch.from_numpy(ref[f"in/{arch}/frames"])
        n = ED_TOKENS
        logits, caches = ED.encdec_prefill(cfg, p, frames, toks[:, :n],
                                           splan=splan)
    else:
        n = S
        logits, caches = LM.lm_prefill(cfg, p, toks[:, :n], splan=splan,
                                       ctx=CTX)
    _close(logits, ref[f"out/{arch}/prefill"])
    want = _tree(ref, f"out/{arch}/caches")
    caches_np = tree_map(lambda t: _np(t).copy(), caches)
    decode = ED.encdec_decode if cfg.encoder_layers else LM.lm_decode
    logits, caches = decode(cfg, p, caches, toks[:, n:n + 1], splan=splan)
    _close(logits, ref[f"out/{arch}/decode"])
    tol = dict(rtol=3e-5, atol=3e-5) if cfg.num_experts else TOL
    for got, name in ((caches_np, "caches"), (caches, "decode_caches")):
        w = _tree(ref, f"out/{arch}/{name}")
        for (path, g), (_, x) in zip(tree_flatten_with_path(got),
                                     tree_flatten_with_path(w)):
            np.testing.assert_allclose(_np(g), x, **tol, err_msg=str(path))
    assert set(want) == set(caches)


def _scout_moe(ref):
    cfg = configs.reduced(configs.get_config(SCOUT))
    p = _params(ref, SCOUT)["blocks"]["p0"]["moe"]
    return cfg, tree_map(lambda t: t[0], p)


def test_ep_prefill_with_drops_matches_reference(reference):
    """The MoE layer under the (2, 4) plan at the config's capacity: 8
    blocks of 4 tokens, ``cap_src`` = 1.  Outputs within 1e-5 of their
    scale (``_close_to_scale``), and the kept
    set equal to the reference's (the rows of its routed-only output that
    are not 0); the kept count is the sum over blocks and experts of
    min(routed, cap_src)."""
    ref = _ref(reference)
    cfg, moe = _scout_moe(ref)
    x = torch.from_numpy(ref["moe/x"])
    splan = make_plan(cfg, make_position_mesh(RUN_MESH, "cpu"),
                      decode_batch=B)
    _close_to_scale(L.apply_moe(cfg, moe, x, splan=splan), ref["moe/ep"])
    routed = L.apply_moe(dataclasses.replace(cfg, shared_expert=False), moe,
                         x, splan=splan)
    _close_to_scale(routed, ref["moe/routed"])
    cap = L.ep_capacity(cfg, splan, x)
    assert cap == 1
    _, eidx, keep = L.moe_dispatch_blocks(moe, x, 2, 4, cap)
    kept = keep.reshape(2, 4, 1, 4).permute(0, 2, 1, 3).reshape(B, S)
    want_kept = np.abs(ref["moe/routed"]).max(-1) > 0
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    per = torch.nn.functional.one_hot(eidx, cfg.num_experts).sum(1)
    assert int(keep.sum()) == int(per.clamp(max=cap).sum()) < B * S
    # a mesh-less layer keeps other tokens: the blocks change the result
    assert not np.allclose(_np(L.apply_moe(cfg, moe, x)), ref["moe/ep"])


def test_ep_decode_matches_reference(reference):
    """The four model positions' masked products over their local experts,
    summed in model order, against the reference's ``psum``."""
    ref = _ref(reference)
    cfg, moe = _scout_moe(ref)
    assert cfg.moe_decode_ep
    x = torch.from_numpy(ref["moe/x"])[:, :1]
    splan = make_plan(cfg, make_position_mesh(RUN_MESH, "cpu"),
                      decode_batch=B)
    got = L.moe_decode(cfg, moe, x, splan=splan)
    _close_to_scale(got, ref["moe/decode"])
    # the gather path agrees within f32 rounding (another summation order)
    _close(L.moe_decode(cfg, moe, x), ref["moe/decode"], rtol=2e-4,
           atol=2e-4)


@pytest.mark.parametrize("path", ["prefill", "decode"])
def test_uneven_blocks_raise_in_both_packages(reference, path):
    """B = 1 over data = 2: the reference's ``shard_map`` raises; the
    port's blocks raise ``ValueError``."""
    ref = _ref(reference)
    assert _json(ref, "moe/raised")[path] == "ValueError"
    cfg, moe = _scout_moe(ref)
    x = torch.from_numpy(ref["moe/x"])[:1]
    mesh = make_position_mesh(RUN_MESH, "cpu")
    with pytest.raises(ValueError, match="evenly"):
        if path == "prefill":
            L.apply_moe(cfg, moe, x, splan=make_plan(cfg, mesh,
                                                     decode_batch=B))
        else:
            L.moe_decode(cfg, moe, x[:, :1], splan=make_plan(cfg, mesh))


# -- training on (2, 2, 2) --------------------------------------------------------


def _update_excess(new, old, want, same) -> float:
    """The worst leaf's max |(new - old) - (want - old)| over the elements
    where ``same`` (the int8 levels agree), as a multiple of UPDATE_RTOL x
    that leaf's largest reference update: at most 1 passes."""
    worst = 0.0
    for g, o, w, m in zip(new, old, want, same):
        ref_upd = w - o
        err = np.abs((_np(g) - o) - ref_upd)[m]
        if err.size:
            worst = max(worst, float(err.max()) / (
                UPDATE_RTOL * float(np.abs(ref_upd).max()) or 1e-30))
    return worst


@pytest.mark.parametrize("arch", ["olmo-1b", SCOUT])
def test_mesh_train_step_matches_reference(reference, arch):
    """One f32 AdamW step (``TRAIN_OPT``) with ``grad_compress`` on (pod 2,
    data 2, model 2).  Both packages' gradients differ by ~1e-7, which can
    move an element's int8 level by one, and the first AdamW step turns a
    changed level into a changed update: each leaf's update new - old is
    held within UPDATE_RTOL of its largest reference update wherever the
    two packages' levels agree, and the elements where they do not are
    counted and bounded.  The same step without compression misses both
    the update and the gnorm limits: they see the compression."""
    ref = _ref(reference)
    cfg = configs.reduced(configs.get_config(arch))
    opt = make_optimizer(OptimizerConfig(**TRAIN_OPT))
    state = state_from_arrays(_tree(ref, f"state/{arch}"), device="cpu")
    batch = batch_for(cfg, configs.ShapeConfig("mesh", *TRAIN_SHAPE,
                                               "train"), 0, seed=0)
    mesh = make_position_mesh(TRAIN_MESH, "cpu")
    step, splan = jit_train_step(cfg, opt, mesh, grad_compress=True)
    assert splan.data_axes == ("pod", "data")
    new, metrics = step(state, batch)
    _close(metrics["loss"], ref[f"train/{arch}/loss"], rtol=1e-5, atol=1e-6)
    want_gnorm = float(ref[f"train/{arch}/gnorm"])
    assert abs(float(metrics["gnorm"]) - want_gnorm) <= \
        GNORM_RTOL * want_gnorm
    # the port's own gradients under the plan, and their int8 levels
    leaves = [t.detach().requires_grad_(True)
              for t in tree_leaves(state["params"])]
    loss = get_bundle(cfg).loss(cfg, tree_unflatten(state["params"], leaves),
                                {k: torch.from_numpy(v).long()
                                 for k, v in batch.items()}, splan)
    grads = torch.autograd.grad(loss, leaves)
    levels = [C.quantize_int8(g)[0].numpy() for g in grads]
    want_levels = [x for _, x in tree_flatten_with_path(
        _tree(ref, f"train/{arch}/levels"))]
    want_params = [x for _, x in tree_flatten_with_path(
        _tree(ref, f"train/{arch}/params"))]
    old = [_np(t) for t in tree_leaves(state["params"])]
    same = [lv == wl for lv, wl in zip(levels, want_levels)]
    flips = sum(int((~m).sum()) for m in same)
    assert flips <= LEVEL_FLIPS_MAX
    assert _update_excess(tree_leaves(new["params"]), old, want_params,
                          same) <= 1.0
    # the limits see the compression: the uncompressed step misses both
    plain, pm = jit_train_step(cfg, opt, mesh)[0](state, batch)
    assert abs(float(pm["gnorm"]) - want_gnorm) > GNORM_RTOL * want_gnorm
    assert _update_excess(tree_leaves(plain["params"]), old, want_params,
                          same) > 100.0


@pytest.mark.parametrize("arch", ["olmo-1b", SCOUT])
def test_compress_grads_crosspod_bit_for_bit(reference, arch):
    ref = _ref(reference)
    grads = LM.params_from_arrays(_tree(ref, f"train/{arch}/grads"),
                                  device="cpu")
    got = C.compress_grads_crosspod(grads,
                                    make_position_mesh(TRAIN_MESH, "cpu"))
    for (path, g), (_, w) in zip(tree_flatten_with_path(got),
                                 tree_flatten_with_path(_tree(
                                     ref, f"train/{arch}/compressed"))):
        assert _np(g).tobytes() == w.tobytes(), path


def test_restore_checkpoint_onto_mesh_bit_for_bit(reference, tmp_path):
    """The reference's checkpoint, restored onto the port's (2, 2, 2) mesh,
    bit for bit its own restore onto its mesh; and the port's save and
    restore through the loop."""
    from repro_torch.train.fault import TrainLoop
    ref = _ref(reference)
    want = _tree(ref, "restored")
    like = state_from_arrays(want, device="cpu")
    mesh = make_position_mesh(TRAIN_MESH, "cpu")
    got, step = K.restore_checkpoint(os.path.join(ref["#dir"], "ckpt"),
                                     tree_map(torch.zeros_like, like),
                                     mesh=mesh)
    assert step == 1
    for (path, g), (_, w) in zip(tree_flatten_with_path(got),
                                 tree_flatten_with_path(want)):
        assert _np(g).tobytes() == np.asarray(w).tobytes(), path
    K.save_checkpoint(str(tmp_path), got, 3)
    loop = TrainLoop(lambda s, b: (s, {"loss": torch.zeros(())}),
                     lambda k: None, ckpt_dir=str(tmp_path))
    again, step = loop.restore(tree_map(torch.zeros_like, like), mesh=mesh)
    assert step == 3
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                 tree_leaves(got)))


# -- the reference's defect, pinned -------------------------------------------------


def test_reference_lm_cannot_run_on_its_own_local_mesh(reference):
    """``repro.launch.mesh.make_local_mesh`` builds its mesh with
    ``jax.make_mesh``, whose axes are Explicit under this jax; the first
    ``with_sharding_constraint`` then raises, so the reference's LM runs
    only on a mesh built as ``jax.sharding.Mesh`` (Auto axes).  The port's
    ``make_local_mesh`` has no axis types to get wrong."""
    got = _json(_ref(reference), "local_mesh")
    assert got["axis_types"] and all("Explicit" in t
                                     for t in got["axis_types"])
    assert "Auto" in got["error"]
