"""Port parity: the optimizers (``repro_torch.train.optimizer``) and one
train step of each against the reference's on the CPU.

  * each optimizer's ``update`` on the same gradients, state, parameters
    and step as the reference's jitted ``update``: new parameters and
    state within rtol = 2e-6, atol = 1e-7 (``torch.pow`` / ``torch.cos``
    against XLA's for ``beta ** t``, ``t ** -decay_rate`` and the cosine
    schedule: an ulp of the f32 scalars; measured in the docstring of each
    test), through several steps of warmup and decay;
  * one ``make_train_step`` step of each optimizer from a reference state
    carried across with ``state_from_arrays``, against the reference's
    jitted step: loss and ``gnorm`` within rtol 1e-5; SGD's new
    parameters within 1e-6; AdamW's and Adafactor's 99.9 % of elements
    within 1e-6 and every one within 2 lr.  The gradients agree within
    ~1e-6 (test_torch_lm_train), and the first update ``g / (|g| + eps)``
    (AdamW) or ``g / |g|`` (Adafactor) turns that rounding on gradients
    near 0 into up to lr-sized moves (measured: 1 element of 2,048 of
    qwen2's ``wk`` 1.4e-4 off at lr 1e-3);
  * Adafactor's state shapes, the reference's: factored by ``ndim >= 2``,
    a stacked ``[nB, D]`` norm scale included; ``_decayable`` on the last
    key only (qwen2's ``bq``, zamba2's LoRA ``a`` decay);
  * ``lr_schedule``, ``global_norm`` and ``clip_by_global_norm``, and the
    reference test's claim that each optimizer lowers the loss.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.sharding import make_plan as jmake_plan
from repro.train import optimizer as JO
from repro.train import trainer as JT
from repro_torch import configs
from repro_torch.models import get_bundle
from repro_torch.train import data as D
from repro_torch.train import optimizer as O
from repro_torch.train.trainer import make_train_step, state_from_arrays

OPTIMIZERS = ["adamw", "adafactor", "sgd"]


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _leaves(tree) -> list:
    return [leaf for _, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _tree_close(got, want, **tol):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=jax.tree_util
                                   .keystr(path), **tol)


def _arrays(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


#: a tree with every kind of leaf the models have: stacked matrices and
#: stacked 1-D leaves, qwen2's biases, zamba2's LoRA and SSD scalars, an
#: unstacked norm with a bias
SHAPES = {
    "blocks": {"p0": {"attn": {"wq": (2, 8, 12), "bq": (2, 12)},
                      "norm1": {"scale": (2, 8)},
                      "ssm": {"A_log": (2, 4), "D": (2, 4),
                              "dt_bias": (2, 4), "conv_w": (2, 4, 6)}}},
    "lora": {"a": (2, 8, 3), "b": (2, 3, 12)},
    "embed": (16, 8),
    "final_norm": {"scale": (8,), "bias": (8,)},
}


def _random_tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (r.normal(size=s) * scale).astype(np.float32), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_update_matches_reference(name):
    """The same (grads, state, params, step) through both packages'
    ``update``, over steps 0-5 of a 3-step warmup (clipping active at
    steps 0 and 3).  Measured: within 2.4e-7 relative."""
    oc = dict(name=name, lr=1e-2, warmup_steps=3, total_steps=8)
    jopt = JO.make_optimizer(JO.OptimizerConfig(**oc))
    opt = O.make_optimizer(O.OptimizerConfig(**oc))
    jparams = jax.tree_util.tree_map(jnp.asarray, _random_tree(0))
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    for k in range(6):
        grads = _random_tree(10 + k, scale=3.0 if k in (0, 3) else 0.01)
        params = state_from_arrays(_arrays(jparams), device="cpu")
        state = state_from_arrays(_arrays(jstate), device="cpu")
        step = torch.tensor(k, dtype=torch.int32)
        new_p, new_s = opt.update(state_from_arrays(grads, device="cpu"),
                                  state, params, step)
        jparams, jstate = jupdate(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams,
            jnp.int32(k))
        _tree_close(new_p, jparams, rtol=2e-6, atol=1e-7)
        _tree_close(new_s, jstate, rtol=2e-6, atol=1e-7)
        jstate = dict(jstate)
        jstate.pop("gnorm")


@functools.lru_cache(maxsize=None)
def _start(arch: str):
    cfg = configs.reduced(configs.get_config(arch))
    params = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(3),
                                  dtype=torch.float32, device="cpu")
    batch = D.synthetic_batch(D.DataConfig(seed=4, vocab_size=cfg.vocab_size,
                                           batch=4, seq_len=16), 0)
    return cfg, _arrays(jax.tree_util.tree_map(lambda t: t.numpy(), params)
                        ), batch


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_train_step_matches_reference_jitted_step(name):
    arch = "qwen2-7b"
    cfg, arrays, batch = _start(arch)
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    oc = dict(name=name, lr=1e-3, warmup_steps=1, total_steps=10)
    jopt = JO.make_optimizer(JO.OptimizerConfig(**oc))
    opt = O.make_optimizer(O.OptimizerConfig(**oc))
    jparams = jax.tree_util.tree_map(jnp.asarray, arrays)
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    state = state_from_arrays(_arrays(jstate), device="cpu")
    assert state["step"].dtype == torch.int32 and state["step"].ndim == 0
    new, m = make_train_step(cfg, opt)(state, batch)
    jnew, jm = jax.jit(JT.make_train_step(jcfg, jopt, jmake_plan(jcfg, None)))(
        jstate, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                               rtol=1e-5)
    if name == "sgd":
        _tree_close(new["params"], jnew["params"], rtol=0, atol=1e-6)
    else:
        got, want = _leaves(new["params"]), _leaves(jnew["params"])
        diffs = np.concatenate([np.abs(_np(a) - _np(b)).ravel()
                                for a, b in zip(got, want)])
        assert diffs.max() <= 2 * oc["lr"]
        assert np.mean(diffs > 1e-6) < 1e-3, np.mean(diffs > 1e-6)
    assert int(new["step"]) == int(jnew["step"]) == 1
    assert jax.tree_util.tree_structure(_arrays(jax.tree_util.tree_map(
        lambda t: t.numpy(), new))) == jax.tree_util.tree_structure(
        _arrays(jnew))


def test_adafactor_factors_as_the_reference_does():
    """``ndim >= 2`` counts the stacked axis: zamba2's stacked norm scales
    ``[nB, D]`` get ``vr [nB]`` and ``vc [D]``; unstacked 1-D leaves a
    full ``v``.  Shapes and dtypes equal the reference's state."""
    cfg, arrays, _ = _start("zamba2-2.7b")
    jstate = JO.make_optimizer(JO.OptimizerConfig(name="adafactor")).init(
        jax.tree_util.tree_map(jnp.asarray, arrays))
    state = O.make_optimizer(O.OptimizerConfig(name="adafactor")).init(
        state_from_arrays(arrays, device="cpu"))
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                    state)
    jshapes = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), torch.float32), jstate)
    assert shapes == jshapes
    v = state["v"]["blocks"]["p0"]["norm1"]["scale"]
    nB = cfg.num_blocks
    assert set(v) == {"vr", "vc"} and tuple(v["vr"].shape) == (nB,) \
        and tuple(v["vc"].shape) == (cfg.d_model,)
    assert set(state["v"]["final_norm"]["scale"]) == {"v"}


@pytest.mark.parametrize("path,decays", [
    (("blocks", "p0", "attn", "bq"), True),
    (("blocks", "p0", "attn", "bv"), True),
    (("lora", "a"), True),
    (("lora", "b"), True),
    (("blocks", "p0", "attn", "wq"), True),
    (("blocks", "p0", "norm1", "scale"), False),
    (("final_norm", "bias"), False),
    (("blocks", "p0", "ssm", "A_log"), False),
    (("blocks", "p0", "ssm", "D"), False),
    (("blocks", "p0", "ssm", "dt_bias"), False),
    ((), True),
])
def test_decayable_reads_the_last_key_as_the_reference(path, decays):
    jpath = tuple(jax.tree_util.DictKey(k) for k in path)
    assert O._decayable(path) is JO._decayable(jpath) is decays


def test_lr_schedule_matches_reference():
    """Warmup, cosine decay and the floor, over steps 0-130; ``torch.cos``
    against XLA's: measured within 5.0e-7 relative (4 ulps)."""
    cfg = O.OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=120)
    jcfg = JO.OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=120)
    steps = np.arange(131, dtype=np.int32)
    got = torch.stack([O.lr_schedule(cfg, torch.tensor(int(s),
                                                        dtype=torch.int32))
                       for s in steps]).numpy()
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: JO.lr_schedule(jcfg, s)))(jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[[0, 9, 130]], [3e-5, 3e-4, 3e-5],
                               rtol=1e-6)


def test_clip_by_global_norm():
    tree = {"a": torch.full((4,), 10.0),
            "b": torch.full((4,), 10.0).to(torch.bfloat16)}
    clipped, norm = O.clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(800.0), rtol=1e-6)
    np.testing.assert_allclose(float(O.global_norm(clipped)), 1.0, rtol=5e-3)
    assert clipped["b"].dtype == torch.bfloat16
    same, _ = O.clip_by_global_norm(tree, 1e9)
    assert torch.equal(same["a"], tree["a"])
    with pytest.raises(ValueError, match="unknown optimizer"):
        O.make_optimizer(O.OptimizerConfig(name="lion"))


@functools.lru_cache(maxsize=None)
def _reference_olmo_params():
    """The reference test's start: ``init_state``'s f32 parameters from
    ``PRNGKey(0)``, as arrays."""
    jcfg = jconfigs.reduced(jconfigs.get_config("olmo-1b"))
    opt = JO.make_optimizer(JO.OptimizerConfig(name="sgd"))
    return _arrays(jax.jit(lambda k: JT.init_state(
        jcfg, opt, k, dtype=jnp.float32)["params"])(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_loss_decreases(name):
    """The reference test's claim (``tests/test_train.py``), on the port
    from the reference test's parameters and batches."""
    cfg = configs.reduced(configs.get_config("olmo-1b"))
    opt = O.make_optimizer(O.OptimizerConfig(name=name, lr=3e-3,
                                             warmup_steps=2,
                                             total_steps=100))
    params = state_from_arrays(_reference_olmo_params(), device="cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(cfg, opt)
    dc = D.DataConfig(seed=3, vocab_size=cfg.vocab_size, batch=8, seq_len=64)
    losses = []
    for k in range(12):
        state, m = step(state, D.synthetic_batch(dc, k))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], f"{name}: {losses[0]} -> {losses[-1]}"
    assert all(np.isfinite(losses))
