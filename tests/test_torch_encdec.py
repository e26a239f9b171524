"""Port parity: the encoder-decoder model (``repro_torch.models.encdec``,
seamless-m4t-large-v2 at ``reduced()`` size) against the reference's
``repro.models.encdec`` on the CPU, in f32.

  * ``init_encdec`` builds the reference's tree (keys, shapes, dtypes,
    scales), and ``get_bundle`` dispatches enc-dec configs to it;
  * ``encode``, ``encdec_prefill`` (logits, self caches, memory, index)
    and ``encdec_decode`` from ``init_encdec_caches`` with the memory set
    to ``encode(frames)`` (logits and caches, token by token) within
    rtol = atol = 1e-5 of the reference's on the same parameters;
  * teacher forcing: that decode equals ``encdec_prefill`` over each
    prefix within 1e-5, in both packages;
  * the self cache is written in place, as the LM's;
  * a bf16 memory under f32 weights promotes as jnp does;
  * the copied prefill-then-decode defect, in both packages.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.dist.sharding import make_plan as jmake_plan
from repro.models import encdec as JED
from repro.models import get_bundle as jget_bundle
from repro_torch import configs
from repro_torch.models import encdec as ED
from repro_torch.models import get_bundle
from repro_torch.models import lm as LM

ARCH = "seamless-m4t-large-v2"
KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
B, S_ENC, S_DEC = 2, 24, 9


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


@functools.lru_cache(maxsize=None)
def _case():
    """(reference config, port config, the reference's f32 params, the
    port's copy, frames, decoder tokens)."""
    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    cfg = configs.reduced(configs.get_config(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = jax.jit(lambda k: JED.init_encdec(jcfg, k, dtype=jnp.float32))(KEY)
    p = LM.params_from_arrays(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    r = np.random.default_rng(0)
    frames = r.normal(size=(B, S_ENC, cfg.d_model)).astype(np.float32)
    toks = r.integers(0, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    return jcfg, cfg, jp, p, frames, toks


@functools.lru_cache(maxsize=None)
def _jfns():
    jcfg = _case()[0]
    return (jax.jit(lambda p, f, t: JED.encdec_prefill(jcfg, p, f, t)),
            jax.jit(lambda p, c, t: JED.encdec_decode(jcfg, p, c, t)),
            jax.jit(lambda p, f: JED.encode(
                jcfg, p, f, splan=jmake_plan(jcfg, None))))


def _tt(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def test_init_encdec_has_the_references_tree():
    jcfg, cfg, _, _, _, _ = _case()
    assert get_bundle(cfg).init is ED.init_encdec
    assert get_bundle(cfg).loss is not get_bundle(
        configs.reduced(configs.get_config("olmo-1b"))).loss
    shapes = jax.eval_shape(
        lambda: jget_bundle(jcfg).init(jcfg, KEY, dtype=jnp.bfloat16))
    params = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.bfloat16, device="cpu")
    want = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
           jax.tree_util.tree_flatten_with_path(params)[0]}
    assert got == want
    assert all(t.dtype == torch.bfloat16 for t in
               jax.tree_util.tree_leaves(params))
    f32 = ED.init_encdec(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    assert abs(float(f32["embed"].std()) - 0.02) < 0.002
    assert abs(float(f32["lm_head"].std()) * np.sqrt(cfg.d_model) - 1) < 0.05
    caches = ED.init_encdec_caches(cfg, 3, 20, device="cpu")
    jcaches = jax.eval_shape(lambda: JED.init_encdec_caches(jcfg, 3, 20))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), caches) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), jcaches)
    assert caches["memory"].shape == (3, ED.DECODE_MEMORY_FRAMES,
                                      cfg.d_model)
    assert caches["index"].dtype == torch.int32


def test_encode_and_prefill_match_reference():
    _, cfg, jp, p, frames, toks = _case()
    jprefill, _, jencode = _jfns()
    _close(ED.encode(cfg, p, _tt(frames)), jencode(jp, frames))
    logits, caches = get_bundle(cfg).prefill(
        cfg, p, {"frames": _tt(frames), "tokens": _tt(toks).long()}, None)
    jlogits, jcaches = jprefill(jp, frames, toks)
    assert logits.shape == (B, cfg.vocab_padded)
    _close(logits, jlogits)
    for name in ("k", "v"):
        assert caches["self"][name].shape == (cfg.num_layers, B, S_DEC,
                                              cfg.num_kv_heads, cfg.head_dim)
        _close(caches["self"][name], jcaches["self"][name])
    _close(caches["memory"], jcaches["memory"])
    assert int(caches["index"]) == int(jcaches["index"]) == S_DEC


def test_decode_matches_reference_and_teacher_forcing():
    """From ``init_encdec_caches(ctx=S_DEC)`` with ``memory =
    encode(frames)``, token by token: logits and caches equal the
    reference's, and each step's logits the prefill over that prefix, in
    both packages."""
    jcfg, cfg, jp, p, frames, toks = _case()
    jprefill, jdecode, jencode = _jfns()
    caches = ED.init_encdec_caches(cfg, B, S_DEC, mem_frames=S_ENC,
                                   dtype=torch.float32, device="cpu")
    caches["memory"] = ED.encode(cfg, p, _tt(frames))
    jcaches = JED.init_encdec_caches(jcfg, B, S_DEC, mem_frames=S_ENC,
                                     dtype=jnp.float32)
    jcaches["memory"] = jencode(jp, frames)
    bundle = get_bundle(cfg)
    for i in range(S_DEC):
        tok = _tt(toks[:, i:i + 1]).long()
        logits, caches = bundle.decode(cfg, p, caches, tok, None)
        jlogits, jcaches = jdecode(jp, jcaches, toks[:, i:i + 1])
        _close(logits, jlogits)
        want, _ = ED.encdec_prefill(cfg, p, _tt(frames),
                                    _tt(toks[:, :i + 1]).long())
        _close(logits, want)
        if i in (0, S_DEC - 1):
            jwant, _ = jprefill(jp, frames, toks[:, :i + 1])
            _close(jlogits, jwant)
    for name in ("k", "v"):
        _close(caches["self"][name], jcaches["self"][name])
    assert int(caches["index"]) == int(jcaches["index"]) == S_DEC


def test_decode_writes_the_self_cache_in_place():
    _, cfg, _, p, frames, toks = _case()
    caches = ED.init_encdec_caches(cfg, B, 4, mem_frames=S_ENC,
                                   dtype=torch.float32, device="cpu")
    caches["memory"] = ED.encode(cfg, p, _tt(frames))
    k = caches["self"]["k"]
    _, out = ED.encdec_decode(cfg, p, caches, _tt(toks[:, :1]).long())
    assert out["self"]["k"] is k and out["memory"] is caches["memory"]
    assert float(k[:, :, 0].abs().max()) > 0 and \
        float(k[:, :, 1:].abs().max()) == 0


def test_bf16_memory_under_f32_weights_promotes_as_jnp():
    """The cross-attention's K/V projection of a bf16 memory under f32
    weights runs in f32, as jnp promotes the mixed product."""
    jcfg, cfg, jp, p, frames, toks = _case()
    _, jdecode, jencode = _jfns()
    mem = ED.encode(cfg, p, _tt(frames)).to(torch.bfloat16)
    caches = ED.init_encdec_caches(cfg, B, 4, mem_frames=S_ENC,
                                   dtype=torch.float32, device="cpu")
    caches["memory"] = mem
    jcaches = JED.init_encdec_caches(jcfg, B, 4, mem_frames=S_ENC,
                                     dtype=jnp.float32)
    jcaches["memory"] = jencode(jp, frames).astype(jnp.bfloat16)
    logits, _ = ED.encdec_decode(cfg, p, caches, _tt(toks[:, :1]).long())
    jlogits, _ = jdecode(jp, jcaches, toks[:, :1])
    assert logits.dtype == torch.float32
    _close(logits, jlogits)


def test_encdec_decode_after_prefill_overwrites_position_zero_in_either_package():
    """A reference defect the port copies (``docs/torch_lm_train.md``):
    ``encdec_prefill`` builds self caches with no free position
    (``attention_forward_with_cache`` without ``ctx``), so the next
    ``encdec_decode`` writes ring slot ``index % Sc = 0``, over the first
    token's K/V, and every slot stays valid.  Its logits then differ from
    a prefill over the whole sequence (the reference's by ~1, here past
    0.1) -- the same way in both packages, within 1e-5."""
    jcfg, cfg, jp, p, frames, toks = _case()
    jprefill, jdecode, _ = _jfns()
    n = S_DEC - 1
    _, caches = ED.encdec_prefill(cfg, p, _tt(frames),
                                  _tt(toks[:, :n]).long())
    k0 = caches["self"]["k"][:, :, 0].clone()
    got, caches = ED.encdec_decode(cfg, p, caches,
                                   _tt(toks[:, n:]).long())
    _, jcaches = jprefill(jp, frames, toks[:, :n])
    jgot, jcaches = jdecode(jp, jcaches, toks[:, n:])
    _close(got, jgot)
    _close(caches["self"]["k"], jcaches["self"]["k"])
    full, _ = ED.encdec_prefill(cfg, p, _tt(frames), _tt(toks).long())
    jfull, _ = jprefill(jp, frames, toks)
    _close(full, jfull)
    gap, jgap = float((got - full).abs().max()), \
        float(np.abs(np.asarray(jgot) - np.asarray(jfull)).max())
    assert gap > 0.1 and jgap > 0.1
    np.testing.assert_allclose(gap, jgap, rtol=1e-4)
    # slot 0 now holds the new token's K, not the first token's
    assert caches["self"]["k"].shape[2] == n
    assert not torch.allclose(caches["self"]["k"][:, :, 0], k0)
    assert int(caches["index"]) == S_DEC


def test_encdec_loss_with_remat_matches_reference():
    """The loss under the config's own remat (full: both stacks
    checkpointed) and its gradients of the encoder's first layer and the
    head, against the reference's ``jax.grad``."""
    jcfg, cfg, jp, p, frames, toks = _case()
    jcfg = dataclasses.replace(jcfg, remat=True)
    cfg = dataclasses.replace(cfg, remat=True)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q: JED.encdec_loss(jcfg, q, frames, toks, labels)))(jp)
    leaves = {"wq": p["enc_blocks"]["attn"]["wq"], "head": p["lm_head"]}
    live = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    q = {**p, "lm_head": live["head"],
         "enc_blocks": {**p["enc_blocks"], "attn": {
             **p["enc_blocks"]["attn"], "wq": live["wq"]}}}
    loss = get_bundle(cfg).loss(cfg, q, {"frames": _tt(frames),
                                         "tokens": _tt(toks).long(),
                                         "labels": _tt(labels).long()}, None)
    g = torch.autograd.grad(loss, [live["wq"], live["head"]])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _close(g[0], jg["enc_blocks"]["attn"]["wq"], rtol=1e-4, atol=1e-4)
    _close(g[1], jg["lm_head"], rtol=1e-4, atol=1e-4)
