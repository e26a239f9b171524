"""Port parity: the LM training path (``repro_torch.models.lm``'s loss and
remat, ``models/registry.py``'s ``loss``, ``train/trainer.py``,
``train/data.py``, ``dist/compression.py``, ``launch/train.py``) against
the reference's on the CPU.

  * ``chunked_xent``'s loss and the gradients of ``h`` and ``w`` equal the
    reference's ``jax.grad`` within 1e-5, with a padded last chunk and -1
    labels, and backward keeps no chunk's logits;
  * for all ten architectures at ``reduced()`` size, ``bundle.loss`` on
    the same f32 parameters within 1e-5 and every gradient leaf within
    rtol = atol = 1e-4 of ``jax.grad``'s (measured: up to 7e-6);
  * remat none / full / dots give the same loss and gradients (the
    values never change, only what backward keeps: within 1e-6);
  * the MoE's dropped tokens get zero gradient; the train path never
    reaches a decode's in-place cache write;
  * the train step: two microbatches equal one batch within the
    reference test's 2e-5, the step leaves its input state untouched, and
    ``vocab_chunk`` is accepted and ignored;
  * ``synthetic_batch`` and ``batch_for`` byte for byte the reference's;
    int8 quantization, error feedback and ``compress_grads_crosspod`` bit
    for bit;
  * ``launch/train.main`` at reduced size on the CPU, with a resume, and
    the copied defect that it cannot feed the enc-dec model.

The optimizers are in ``tests/test_torch_lm_optim.py``, checkpoints and
the fault loop in ``tests/test_torch_lm_ckpt.py``, enc-dec in
``tests/test_torch_encdec.py``.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import compression as JC
from repro.dist.sharding import make_plan as jmake_plan
from repro.models import get_bundle as jget_bundle
from repro.models import lm as JLM
from repro.train import data as JD
from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.dist import compression as C
from repro_torch.models import get_bundle
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import ssd as S
from repro_torch.train import data as D
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.trainer import (init_state, make_train_step,
                                       state_from_arrays)

SHAPE = ShapeConfig("t", 32, 2, "train")


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    t = torch.from_numpy(np.array(a, copy=True))
    return t.long() if a.dtype.kind in "iu" else t


def _pair(arch: str, **changes):
    jcfg = dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config(arch)), **changes)
    cfg = dataclasses.replace(
        configs.reduced(configs.get_config(arch)), **changes)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _leaves(tree) -> list:
    """Leaves in jax's order (sorted keys), any nesting of dicts."""
    return [leaf for _, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _loss_grads(cfg, params, batch):
    """The port's loss and gradients (a tree) on detached leaves."""
    flat, tdef = jax.tree_util.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in flat]
    loss = get_bundle(cfg).loss(cfg, jax.tree_util.tree_unflatten(
        tdef, leaves), {k: _t(v) for k, v in batch.items()}, None)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), jax.tree_util.tree_unflatten(tdef, list(grads))


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(reference config, port config, f32 params, the batch, the
    reference's loss and gradients).  The parameters are the port's init
    (the same tree as the reference's, ``tests/test_torch_lm.py`` and
    ``tests/test_torch_encdec.py``), handed to the reference as arrays."""
    jcfg, cfg = _pair(arch)
    params = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.float32, device="cpu")
    batch = D.batch_for(cfg, SHAPE, 0, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jget_bundle(jcfg).loss(jcfg, p, b,
                                           jmake_plan(jcfg, None))))(
        jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return jcfg, cfg, params, batch, float(jloss), \
        jax.tree_util.tree_map(np.asarray, jgrads)


# -- chunked_xent -------------------------------------------------------------


@pytest.mark.parametrize("V,chunk", [(103, 32), (103, 103), (64, 16),
                                     (700, 16_384)])
def test_chunked_xent_matches_reference(V, chunk):
    """Loss and the gradients of h and w against the reference's, with a
    padded last chunk (103 / 32, 700 / 16,384) or none (64 / 16), and two
    -1 labels out of the mean."""
    r = np.random.default_rng(V + chunk)
    B, Sq, Dm = 2, 6, 16
    h = r.normal(size=(B, Sq, Dm)).astype(np.float32)
    w = r.normal(size=(Dm, V)).astype(np.float32)
    labels = r.integers(0, V, (B, Sq)).astype(np.int32)
    labels[0, 0] = labels[1, 3] = -1
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: JLM.chunked_xent(a, b, jnp.asarray(labels),
                                      vocab_chunk=chunk), (0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    loss = LM.chunked_xent(th, tw, _t(labels), vocab_chunk=chunk)
    gh, gw = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(_np(gh), _np(jgh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(gw), _np(jgw), rtol=1e-5, atol=1e-6)
    assert float(gh[0, 0].abs().max()) == 0.0      # a -1 label: no gradient


def test_chunked_xent_keeps_no_chunk_logits_for_backward():
    """Each chunk runs under a checkpoint: what autograd keeps between
    forward and backward holds no [B, S, chunk] logits, only the chunk's
    inputs (the reference's ``jax.checkpoint``ed body)."""
    B, Sq, Dm, V, chunk = 2, 8, 4, 256, 64
    r = np.random.default_rng(0)
    h = _t(r.normal(size=(B, Sq, Dm)).astype(np.float32)).requires_grad_()
    w = _t(r.normal(size=(Dm, V)).astype(np.float32)).requires_grad_()
    labels = _t(r.integers(0, V, (B, Sq)))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = LM.chunked_xent(h, w, labels, vocab_chunk=chunk)
    assert saved and max(saved) < B * Sq * chunk
    torch.autograd.grad(loss, (h, w))


# -- every architecture's loss and gradients ------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    _, cfg, params, batch, jloss, jgrads = _reference(arch)
    loss, grads = _loss_grads(cfg, params, batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=1e-5)
    got = jax.tree_util.tree_flatten_with_path(grads)[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, j) in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), j, rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


REMAT_ARCHS = ["olmo-1b", "llama4-scout-17b-a16e", "mamba2-2.7b",
               "zamba2-2.7b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_give_equal_loss_and_grads(arch):
    """``cfg.remat`` with each policy against remat off: the same loss and
    gradients (dense, MoE, SSD, hybrid and the enc-dec stacks)."""
    _, cfg, params, batch, _, _ = _reference(arch)
    want_loss, want = _loss_grads(cfg, params, batch)
    for policy in ("none", "full", "dots"):
        rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        loss, grads = _loss_grads(rcfg, params, batch)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
        for g, w in zip(_leaves(grads), _leaves(want)):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-7)


def test_remat_dots_saves_only_products_without_batch_dims():
    """Counted in backward at reduced olmo: "full" recomputes every
    forward product, "dots" only the batched ones (the attention's
    ``bmm``), keeping the ``x @ W`` projections' ``mm`` outputs; "none"
    recomputes nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    _, cfg, params, batch, _, _ = _reference("olmo-1b")
    counts = {}
    for policy in ("none", "full", "dots"):
        rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        flat, tdef = jax.tree_util.tree_flatten(params)
        leaves = [t.detach().requires_grad_(True) for t in flat]
        loss = get_bundle(rcfg).loss(rcfg, jax.tree_util.tree_unflatten(
            tdef, leaves), {k: _t(v) for k, v in batch.items()}, None)
        with Count() as c:
            torch.autograd.grad(loss, leaves)
        counts[policy] = c.n
    assert counts["full"]["mm"] > counts["none"]["mm"]
    assert counts["dots"]["mm"] == counts["none"]["mm"]
    assert counts["dots"]["bmm"] == counts["full"]["bmm"] > \
        counts["none"]["bmm"]
    assert LM._remat(cfg, len) is len                    # remat off
    on = dataclasses.replace(cfg, remat=True, remat_policy="none")
    assert LM._remat(on, len) is len


def test_moe_dropped_tokens_get_zero_gradient():
    """Tokens past capacity go to the dump row, whose duplicate writes are
    zeros: their routed output and every gradient through it are 0."""
    cfg = configs.reduced(configs.get_config("llama4-scout-17b-a16e"))
    p = L.init_moe(cfg, torch.Generator().manual_seed(0), cfg.d_model,
                   cfg.d_ff, torch.float32, device="cpu")
    tokens = torch.randn(40, cfg.d_model, generator=torch.Generator()
                         .manual_seed(1)).requires_grad_()
    out, eidx, keep = L._moe_dispatch(p, tokens, 3)
    assert int((~keep).sum()) >= 10                      # drops happen
    (g,) = torch.autograd.grad((out * torch.randn_like(out)).sum(),
                               (tokens,))
    assert float(out.detach()[~keep].abs().max()) == 0.0
    assert float(g[~keep].abs().max()) == 0.0
    assert float(g[keep].abs().max()) > 0.0


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b",
                                  "llama4-scout-17b-a16e"])
def test_train_path_reaches_no_decode_write(arch, monkeypatch):
    """The loss never calls a decode step (whose cache writes are in
    place) nor runs under no_grad."""
    _, cfg, params, batch, _, _ = _reference(arch)

    def refuse(*a, **k):
        raise AssertionError("a decode step on the train path")
    for mod, name in ((S, "ssd_decode"), (L, "attention_decode"),
                      (L, "moe_decode")):
        monkeypatch.setattr(mod, name, refuse)
    loss, grads = _loss_grads(cfg, params, batch)
    assert torch.isfinite(loss)
    assert all(g is not None for g in _leaves(grads))


# -- the train step -------------------------------------------------------------


def _olmo_state(opt, seed=0):
    cfg = configs.reduced(configs.get_config("olmo-1b"))
    return cfg, init_state(cfg, opt, torch.Generator().manual_seed(seed),
                           dtype=torch.float32, device="cpu")


def test_grad_accumulation_matches_single_batch():
    """2 microbatches of B/2 equal one batch of B (the reference test's
    claim and tolerance)."""
    opt = make_optimizer(OptimizerConfig(name="sgd", lr=1e-2,
                                         warmup_steps=0, grad_clip=1e9))
    cfg, state = _olmo_state(opt)
    batch = D.synthetic_batch(D.DataConfig(seed=1, vocab_size=cfg.vocab_size,
                                           batch=8, seq_len=32), 0)
    s1, m1 = make_train_step(cfg, opt, microbatches=1)(state, batch)
    s2, m2 = make_train_step(cfg, opt, microbatches=2)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    diffs = [float((a - b).abs().max()) for a, b in
             zip(_leaves(s1["params"]), _leaves(s2["params"]))]
    assert max(diffs) < 2e-5


def test_step_leaves_its_input_state_untouched():
    """The functional contract: the given state is not written, and the
    new state shares no storage with it."""
    opt = make_optimizer(OptimizerConfig(name="adamw", lr=1e-2,
                                         warmup_steps=1))
    cfg, state = _olmo_state(opt)
    before = jax.tree_util.tree_map(lambda t: t.clone(), state)
    batch = D.synthetic_batch(D.DataConfig(seed=2, vocab_size=cfg.vocab_size,
                                           batch=4, seq_len=16), 0)
    new, metrics = make_train_step(cfg, opt)(state, batch)
    for a, b in zip(_leaves(state), _leaves(before)):
        assert torch.equal(a, b) and not a.requires_grad
    old_ptrs = {t.data_ptr() for t in _leaves(state)}
    assert not old_ptrs & {t.data_ptr() for t in _leaves(new)}
    assert int(new["step"]) == 1 and new["step"].dtype == torch.int32
    assert set(metrics) == {"loss", "gnorm"}
    assert "gnorm" not in new["opt"]
    assert any(not torch.equal(a, b) for a, b in
               zip(_leaves(new["params"]), _leaves(state["params"])))


def test_vocab_chunk_is_accepted_and_ignored():
    """As in the reference, ``make_train_step(vocab_chunk=...)`` does not
    reach the loss, which keeps its default chunk."""
    opt = make_optimizer(OptimizerConfig(name="sgd", lr=1e-2))
    cfg, state = _olmo_state(opt)
    batch = D.synthetic_batch(D.DataConfig(seed=2, vocab_size=cfg.vocab_size,
                                           batch=2, seq_len=8), 0)
    a, ma = make_train_step(cfg, opt)(state, batch)
    b, mb = make_train_step(cfg, opt, vocab_chunk=7)(state, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    assert all(torch.equal(x, y) for x, y in
               zip(_leaves(a["params"]), _leaves(b["params"])))


def test_train_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points default to it")
    opt = make_optimizer(OptimizerConfig())
    cfg = configs.reduced(configs.get_config("olmo-1b"))
    for call in (lambda: init_state(cfg, opt, torch.Generator()),
                 lambda: state_from_arrays({"step": np.int32(0)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_launch_train_main_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as cli
    args = ["--arch", "olmo-1b", "--steps", "4", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    first = cli.main(args)
    assert set(first) == {"arch", "steps", "first_loss", "last_loss",
                          "mean_step_s", "stragglers"}
    assert first["steps"] == 4 and np.isfinite(first["last_loss"])
    assert json.loads(capsys.readouterr().out)["steps"] == 4
    again = cli.main(args + ["--resume", "--steps", "2"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert again["steps"] == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004", "step_00000006"]


def test_launch_train_cannot_feed_encdec_in_either_package(monkeypatch):
    """A reference defect the port copies (``docs/torch_lm_train.md``):
    the CLI feeds every architecture ``synthetic_batch``, which has no
    ``frames``, so the enc-dec loss raises ``KeyError: 'frames'`` at the
    first step, in both packages."""
    import sys

    from repro.launch import train as jcli
    from repro_torch.launch import train as cli
    args = ["--arch", "seamless-m4t-large-v2", "--steps", "1", "--batch",
            "2", "--seq", "8"]
    with pytest.raises(KeyError, match="frames"):
        cli.main(args + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    with pytest.raises(KeyError, match="frames"):
        jcli.main()


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (11, 7), (3, 123)])
def test_synthetic_batch_is_the_references_byte_for_byte(seed, step):
    dc = dict(seed=seed, vocab_size=503, batch=3, seq_len=17)
    got = D.synthetic_batch(D.DataConfig(**dc), step)
    want = JD.synthetic_batch(JD.DataConfig(**dc), step)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k].tobytes() == want[k].tobytes()
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


@pytest.mark.parametrize("arch", ["olmo-1b", "seamless-m4t-large-v2"])
def test_batch_for_is_the_references_byte_for_byte(arch):
    jcfg, cfg = _pair(arch)
    shape = ShapeConfig("t", 24, 2, "train")
    got = D.batch_for(cfg, shape, 5, seed=2)
    want = JD.batch_for(jcfg, jconfigs.ShapeConfig("t", 24, 2, "train"), 5,
                        seed=2)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes()
    if cfg.encoder_layers:
        assert got["frames"].shape == (2, 24, cfg.d_model)
        assert got["tokens"].shape == (2, 24 // cfg.dec_len_ratio)


# -- gradient compression -------------------------------------------------------


def test_int8_quantization_is_the_references_bit_for_bit():
    """Codes and scale equal, ties rounding half to even (127 sets the
    scale to 1, so x / scale keeps its exact halves)."""
    r = np.random.default_rng(0)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                    np.float32)
    for x in (ties, r.normal(size=(64, 64)).astype(np.float32),
              (r.normal(size=300) * 1e-3).astype(np.float32),
              np.zeros(5, np.float32)):
        q, s = C.quantize_int8(_t(x))
        jq, js = JC.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert q.numpy().tobytes() == np.asarray(jq).tobytes()
        assert np.float32(s).tobytes() == np.asarray(js).tobytes()
        deq = C.dequantize_int8(q, s)
        assert deq.numpy().tobytes() == \
            np.asarray(JC.dequantize_int8(jq, js)).tobytes()
        assert float((deq - _t(x)).abs().max()) <= float(s) * 0.5 + 1e-6
    q, _ = C.quantize_int8(_t(ties))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def test_error_feedback_is_the_references_bit_for_bit():
    r = np.random.default_rng(1)
    g = {"w": r.normal(size=(32,)).astype(np.float32),
         "b": {"c": r.normal(size=(4, 3)).astype(np.float32)}}
    tg = jax.tree_util.tree_map(_t, g)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    ef, jef = C.init_error_feedback(tg), JC.init_error_feedback(jg)
    total = np.zeros(32, np.float32)
    for _ in range(50):
        sent, ef = C.compress_with_error_feedback(tg, ef)
        jsent, jef = JC.compress_with_error_feedback(jg, jef)
        for a, b in zip(_leaves(sent) + _leaves(ef),
                        _leaves(jsent) + _leaves(jef)):
            assert _np(a).tobytes() == np.asarray(b).tobytes()
        total += sent["w"].numpy()
    np.testing.assert_allclose(total / 50, g["w"], atol=2e-3)
    bf = {"x": _t(g["w"]).to(torch.bfloat16), "i": torch.arange(3)}
    out = C.compress_grads_crosspod(bf, None)
    assert out["i"] is bf["i"] and out["x"].dtype == torch.bfloat16
    assert _np(C.compress_grads_crosspod(tg, None)["w"]).tobytes() == \
        np.asarray(JC.compress_grads_crosspod(jg, None)["w"]).tobytes()
