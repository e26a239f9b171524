"""Port parity: the dense LM serving path (``repro_torch.configs``,
``repro_torch.models``) against the reference's ``repro.configs`` /
``repro.models`` on the CPU.

  * every config, ``reduced()`` and the parameter counts equal the
    reference's field for field;
  * each layer function equals the reference's on the same numpy arrays
    (three norms, RoPE, three MLPs, QKV bias and QK-norm, grouped SDPA,
    the blockwise attention with causal and windowed masks and a KV length
    that is not a multiple of the chunk, cross-attention, one-token decode
    with a per-slot index and ring wrap);
  * ``lm_prefill`` / ``lm_decode`` logits and caches equal the reference's
    for the five dense architectures at ``reduced()`` size, the reference's
    f32 parameters carried across with ``params_from_arrays``, within
    rtol = atol = 1e-5;
  * the claims of ``tests/test_decode.py`` on the port: decode matches
    prefill, multi-step teacher forcing, and the windowed mask (on a
    reduced olmo with ``attn_window=16``; on llama4 itself in
    ``tests/test_torch_lm_families.py``, which holds the MoE, SSD and
    hybrid families);
  * one decode on bf16 caches under f32 weights (the engine's default)
    against the reference's: logits within bf16's epsilon, caches bit for
    bit;
  * the mesh entry points on a one-device mesh (the LM's plan and
    constraint points, and for the enc-dec family its training step and
    checkpoint restore; ``tests/test_torch_lm_mesh.py`` holds them against
    the reference's), the same over two distinct (CPU-index) devices,
    whose positions own their shards (``tests/test_torch_lm_spmd_train.py``
    holds that path), and the in-place cache update (a kept divergence,
    pinned below).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist.sharding import make_plan as jmake_plan
from repro.models import get_bundle as jget_bundle
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import configs
from repro_torch.dist.sharding import Mesh, ShardingPlan, make_plan
from repro_torch.models import get_bundle, scanctl
from repro_torch.models import layers as L
from repro_torch.models import lm as LM

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
DENSE = ["olmo-1b", "qwen2-7b", "yi-34b", "minitron-4b", "chameleon-34b"]
#: the family whose bundle is its own (``models/encdec.py``): once the
#: last to be ported over positions that own their shards
OWN_BUNDLE = ("seamless-m4t-large-v2",)


def _pair(arch: str, **changes):
    """(reference config, port config) at reduced() size, with changes."""
    jcfg = dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config(arch)), **changes)
    cfg = dataclasses.replace(
        configs.reduced(configs.get_config(arch)), **changes)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _params(arch: str, window: int = 0):
    """The reference's f32 parameters and the port's copy of them."""
    changes = {"attn_window": window} if window else {}
    jcfg, cfg = _pair(arch, **changes)
    jp = jget_bundle(jcfg).init(jcfg, KEY, dtype=jnp.float32)
    p = LM.params_from_arrays(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, cfg, jp, p


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _tokens(cfg, B, S, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_config_equals_reference(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    assert type(cfg).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for port, ref in ((cfg, jcfg),
                      (configs.reduced(cfg), jconfigs.reduced(jcfg)),
                      (configs.reduced(cfg, layers=5, d_model=96, vocab=700),
                       jconfigs.reduced(jcfg, layers=5, d_model=96,
                                        vocab=700))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        for prop in ("vocab_padded", "block_period", "num_blocks",
                     "d_inner"):
            assert getattr(port, prop) == getattr(ref, prop), prop
        if port.ssm_headdim:
            assert port.ssm_heads == ref.ssm_heads


def test_registry_and_shapes_equal_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert [s.tokens for s in configs.SHAPES.values()] == \
        [s.tokens for s in jconfigs.SHAPES.values()]
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get_config("gpt-2")
    olmo = configs.get_config("olmo-1b")
    assert (olmo.vocab_padded, olmo.param_count()) == (50_432, 1_177_026_560)


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["rmsnorm", "ln", "nonparam_ln"])
def test_norm_matches_reference(norm_type):
    jcfg, cfg = _pair("olmo-1b", norm_type=norm_type)
    r = np.random.default_rng(1)
    x = r.normal(2.0, 3.0, (2, 5, 64)).astype(np.float32)
    p = {"scale": r.normal(size=64).astype(np.float32),
         "bias": r.normal(size=64).astype(np.float32)}
    init = L.init_norm(cfg, 64, torch.float32, device="cpu")
    jinit = JL.init_norm(jcfg, 64, jnp.float32)
    assert {k: _np(v).tolist() for k, v in init.items()} == \
        {k: _np(v).tolist() for k, v in jinit.items()}
    p = {k: p[k] for k in init}
    want = JL.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    _close(L.apply_norm(cfg, {k: _t(v) for k, v in p.items()}, _t(x)), want)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 7, 3, 16)).astype(np.float32)
    _close(L.rope_freqs(16, theta), JL.rope_freqs(16, theta))
    prefill = np.arange(7, dtype=np.int32) + 500
    _close(L.apply_rope(_t(x), _t(prefill), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(prefill), theta))
    per_row = np.array([[3], [1025]], np.int32)          # decode: [B, 1]
    xd = x[:, :1]
    _close(L.apply_rope(_t(xd), _t(per_row), theta),
           JL.apply_rope(jnp.asarray(xd), jnp.asarray(per_row), theta))


@pytest.mark.parametrize("mlp_type", ["swiglu", "sq_relu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    jcfg, cfg = _pair("olmo-1b", mlp_type=mlp_type)
    jp = JL.init_mlp(jcfg, KEY, 64, 256, jnp.float32)
    p = LM.params_from_arrays(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    gen = torch.Generator().manual_seed(0)
    assert {k: v.shape for k, v in L.init_mlp(
        cfg, gen, 64, 256, torch.float32, device="cpu").items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    _close(L.apply_mlp(cfg, p, _t(x)), JL.apply_mlp(jcfg, jp, jnp.asarray(x)))


@pytest.mark.parametrize("arch", ["qwen2-7b", "chameleon-34b"],
                         ids=["qkv_bias", "qk_norm"])
def test_qkv_projection_matches_reference(arch):
    jcfg, cfg = _pair(arch)
    r = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(
        np.asarray, JL.init_attention(jcfg, KEY, 64, jnp.float32))
    # non-trivial biases and QK-norm scales (init gives zeros / ones)
    tree = {k: (r.normal(size=v.shape).astype(np.float32)
                if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v)
            for k, v in tree.items()}
    assert set(tree) & {"bq", "q_norm"}
    x = r.normal(size=(2, 6, 64)).astype(np.float32)
    got = L._project_qkv(cfg, LM.params_from_arrays(tree, device="cpu"),
                         _t(x))
    want = JL._project_qkv(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                           jnp.asarray(x))
    for g, w in zip(got, want):
        _close(g, w)


def _qkv(seed, *, B=2, Sq=12, Sk=40, H=4, KV=2, dh=16):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Sq, H, dh)).astype(np.float32),
            r.normal(size=(B, Sk, KV, dh)).astype(np.float32),
            r.normal(size=(B, Sk, KV, dh)).astype(np.float32))


def test_sdpa_matches_reference():
    q, k, v = _qkv(5, Sq=40)
    mask = np.tril(np.ones((40, 40), bool))
    _close(L._sdpa(_t(q), _t(k), _t(v), _t(mask), kv_groups=2),
           JL._sdpa(*map(jnp.asarray, (q, k, v, mask)), kv_groups=2))
    _close(L._sdpa(_t(q), _t(k), _t(v), None, kv_groups=2),
           JL._sdpa(*map(jnp.asarray, (q, k, v)), None, kv_groups=2))


@pytest.mark.parametrize("causal,window,Sk,chunk", [
    (True, 0, 40, 16),        # 40 = 2.5 chunks: the padded tail is masked
    (True, 16, 40, 16),       # chunked-local window
    (False, 0, 40, 16),
    (True, 0, 48, 48),        # one chunk
    (True, 8, 37, 10),
], ids=["causal", "window", "full", "one-chunk", "window-ragged"])
def test_chunked_sdpa_matches_reference(causal, window, Sk, chunk):
    q, k, v = _qkv(6, Sq=Sk, Sk=Sk)
    spec = L.AttnSpec(causal=causal, window=window)
    jspec = JL.AttnSpec(causal=causal, window=window)
    pos = np.arange(Sk, dtype=np.int32)
    got = L._chunked_sdpa(_t(q), _t(k), _t(v), kv_groups=2,
                          q_positions=_t(pos), kv_positions=_t(pos),
                          spec=spec, chunk=chunk)
    want = JL._chunked_sdpa(*map(jnp.asarray, (q, k, v)), kv_groups=2,
                            q_positions=jnp.asarray(pos),
                            kv_positions=jnp.asarray(pos), spec=jspec,
                            chunk=chunk)
    _close(got, want)
    # the blockwise loop equals one masked softmax over the whole row
    mask = np.ones((Sk, Sk), bool)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] // window == pos[None, :] // window
    _close(got, L._sdpa(_t(q), _t(k), _t(v), _t(mask), kv_groups=2))


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_attention_forward_matches_reference(cross):
    jcfg, cfg = _pair("qwen2-7b", attn_kv_chunk=16)
    jp = JL.init_attention(jcfg, KEY, 64, jnp.float32)
    p = LM.params_from_arrays(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    r = np.random.default_rng(7)
    x = r.normal(size=(2, 20, 64)).astype(np.float32)
    mem = r.normal(size=(2, 35, 64)).astype(np.float32) if cross else None
    kw = dict(kv_x=None if mem is None else _t(mem))
    jkw = dict(kv_x=None if mem is None else jnp.asarray(mem))
    spec = L.AttnSpec(cross=cross, causal=not cross)
    jspec = JL.AttnSpec(cross=cross, causal=not cross)
    _close(L.attention_forward(cfg, p, _t(x), spec, **kw),
           JL.attention_forward(jcfg, jp, jnp.asarray(x), jspec, **jkw))
    if not cross:
        got, cache = L.attention_forward_with_cache(cfg, p, _t(x), spec,
                                                    ctx=27)
        want, jcache = JL.attention_forward_with_cache(
            jcfg, jp, jnp.asarray(x), jspec, ctx=27)
        _close(got, want)
        for name in ("k", "v"):
            assert cache[name].shape == (2, 27, cfg.num_kv_heads, 16)
            _close(cache[name], jcache[name])


@pytest.mark.parametrize("window", [0, 4], ids=["global", "window"])
@pytest.mark.parametrize("index", [[2, 7, 11], 5], ids=["per-slot", "scalar"])
def test_attention_decode_matches_reference(index, window):
    """Per-slot [B] index (slot 2 at 11 wraps the 8-position ring to 3)
    and a lockstep scalar index."""
    jcfg, cfg = _pair("qwen2-7b")
    jp = JL.init_attention(jcfg, KEY, 64, jnp.float32)
    p = LM.params_from_arrays(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    r = np.random.default_rng(8)
    x = r.normal(size=(3, 1, 64)).astype(np.float32)
    shape = (3, 8, cfg.num_kv_heads, cfg.head_dim)
    k = r.normal(size=shape).astype(np.float32)
    v = r.normal(size=shape).astype(np.float32)
    idx = np.asarray(index, np.int32)
    spec, jspec = L.AttnSpec(window=window), JL.AttnSpec(window=window)
    got, cache = L.attention_decode(
        cfg, p, _t(x), {"k": _t(k), "v": _t(v), "index": _t(idx)}, spec)
    want, jcache = JL.attention_decode(
        jcfg, jp, jnp.asarray(x),
        {"k": jnp.asarray(k), "v": jnp.asarray(v), "index": jnp.asarray(idx)},
        jspec)
    _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    assert _np(cache["index"]).tolist() == _np(jcache["index"]).tolist()


def test_scan_loops_stacks_and_writes_through_views():
    xs = {"a": torch.arange(6.0).reshape(3, 2), "b": ({}, torch.ones(3))}

    def body(carry, x):
        x["a"].mul_(10)                      # a view of the stacked leaf
        return carry + x["b"][1], {"y": x["a"].sum()}

    carry, ys = scanctl.scan(body, torch.tensor(0.0), xs)
    assert float(carry) == 3.0
    assert ys["y"].tolist() == [10.0, 50.0, 90.0]
    assert xs["a"][2].tolist() == [40.0, 50.0]
    assert scanctl.scan(lambda c, x: (c, None), 1, xs) == (1, None)


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg, jp, p = _params(arch)
    B, S, ctx = 2, 24, 27
    toks = _tokens(cfg, B, S + 1, seed=9)
    logits, caches = LM.lm_prefill(cfg, p, _t(toks[:, :S]), ctx=ctx)
    jlogits, jcaches = JLM.lm_prefill(jcfg, jp, jnp.asarray(toks[:, :S]),
                                      ctx=ctx)
    assert logits.dtype == torch.float32
    assert logits.shape == (B, cfg.vocab_padded)
    _close(logits, jlogits)
    assert set(caches) == set(jcaches)
    for name in caches:
        if name == "index":
            assert int(caches[name]) == int(jcaches[name]) == S
            continue
        for leaf in ("k", "v"):
            assert caches[name][leaf].shape == \
                (cfg.num_blocks, B, ctx, cfg.num_kv_heads, cfg.head_dim)
            _close(caches[name][leaf], jcaches[name][leaf])
    logits, caches = LM.lm_decode(cfg, p, caches, _t(toks[:, S:]))
    jlogits, jcaches = JLM.lm_decode(jcfg, jp, jcaches,
                                     jnp.asarray(toks[:, S:]))
    _close(logits, jlogits)
    assert int(caches["index"]) == int(jcaches["index"]) == S + 1
    for name in caches:
        if name != "index":
            for leaf in ("k", "v"):
                _close(caches[name][leaf], jcaches[name][leaf])


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill(arch):
    """``tests/test_decode.py::test_decode_matches_prefill`` on the port."""
    _, cfg, _, p = _params(arch)
    bundle, splan = get_bundle(cfg), make_plan(cfg, None)
    B, S = 2, 64
    toks = _t(_tokens(cfg, B, S, seed=10))
    full, _ = bundle.prefill(cfg, p, {"tokens": toks}, splan)
    _, caches = LM.lm_prefill(cfg, p, toks[:, :S - 1], ctx=S)
    step, _ = bundle.decode(cfg, p, caches, toks[:, S - 1:], splan)
    _close(step, full, rtol=1e-4, atol=1e-4)


def test_multi_step_decode_matches_teacher_forcing():
    """Three decode steps == teacher-forced prefill at each prefix."""
    _, cfg, _, p = _params("olmo-1b")
    bundle, splan = get_bundle(cfg), make_plan(cfg, None)
    B, S, EXTRA = 2, 16, 3
    toks = _t(_tokens(cfg, B, S + EXTRA, seed=11))
    _, caches = LM.lm_prefill(cfg, p, toks[:, :S], ctx=S + EXTRA)
    for i in range(EXTRA):
        want, _ = bundle.prefill(cfg, p, {"tokens": toks[:, :S + i + 1]},
                                 splan)
        got, caches = bundle.decode(cfg, p, caches, toks[:, S + i:S + i + 1],
                                    splan)
        _close(got, want, rtol=1e-4, atol=1e-4)


def test_windowed_decode_masks_out_of_chunk():
    """Chunked-local layers must not attend across window blocks (the
    reference's claim on llama4, here on a reduced olmo with a window)."""
    jcfg, cfg, jp, p = _params("olmo-1b", window=16)
    B, S = 1, 48                                  # 3 window blocks
    toks = _tokens(cfg, B, S, seed=12)
    full, _ = LM.lm_prefill(cfg, p, _t(toks))
    _close(full, JLM.lm_prefill(jcfg, jp, jnp.asarray(toks))[0])
    _, caches = LM.lm_prefill(cfg, p, _t(toks[:, :S - 1]), ctx=S)
    step, _ = LM.lm_decode(cfg, p, caches, _t(toks[:, S - 1:]))
    _close(step, full, rtol=1e-4, atol=1e-4)
    # the window matters: the global model attends further back
    _, gcfg, _, gp = _params("olmo-1b")
    glob, _ = LM.lm_prefill(gcfg, gp, _t(toks))
    assert not torch.allclose(glob, full, rtol=1e-3, atol=1e-3)


BF16 = dict(rtol=2 ** -8, atol=2 ** -8)        # bfloat16's epsilon


@pytest.mark.parametrize("arch", DENSE)
def test_decode_on_bf16_caches_matches_reference(arch):
    """The engine's default: f32 weights, f32 queries against bf16 K/V.
    Both sides decode the reference's prefill caches cast to bf16, with a
    per-slot index (one slot past the cache's end, so its write wraps): the
    logits agree within bf16's epsilon and the caches, the rows written as
    ``k_new.astype(bf16)`` among them, are equal bit for bit."""
    jcfg, cfg, jp, p = _params(arch)
    B, S, ctx = 3, 20, 32
    toks = _tokens(cfg, B, S + 1, seed=14)
    _, jcaches = JLM.lm_prefill(jcfg, jp, jnp.asarray(toks[:, :S]), ctx=ctx)
    idx = np.array([S, S - 3, ctx + 2], np.int32)
    jcaches = {n: {k: t.astype(jnp.bfloat16) for k, t in c.items()}
               for n, c in jcaches.items() if n != "index"}
    caches = LM.params_from_arrays(jax.tree_util.tree_map(np.asarray,
                                                          jcaches),
                                   device="cpu")
    old = {n: {k: t.clone() for k, t in c.items()}
           for n, c in caches.items()}
    jcaches["index"], caches["index"] = jnp.asarray(idx), _t(idx)
    got, new = LM.lm_decode(cfg, p, caches, _t(toks[:, S:]))
    want, jnew = JLM.lm_decode(jcfg, jp, jcaches, jnp.asarray(toks[:, S:]))
    assert got.dtype == torch.float32
    _close(got, want, **BF16)
    assert _np(new["index"]).tolist() == (idx + 1).tolist()
    rows = np.arange(B), idx % ctx
    for name in jnew:
        if name == "index":
            continue
        for leaf in ("k", "v"):
            t = new[name][leaf]
            assert t.dtype == torch.bfloat16
            ref = torch.from_numpy(
                np.asarray(jnew[name][leaf]).astype(np.float32))
            assert torch.equal(t.float(), ref)
            written = t.float() != old[name][leaf].float()
            assert written.any(dim=(-2, -1))[:, rows[0], rows[1]].all()
            written[:, rows[0], rows[1]] = False
            assert not written.any()


def test_decode_updates_caches_in_place():
    """Kept divergence: ``lm_decode`` writes the new K/V into the caches it
    is given and returns them; a caller that needs the old ones clones."""
    _, cfg, _, p = _params("olmo-1b")
    toks = _t(_tokens(cfg, 2, 9, seed=13))
    _, caches = LM.lm_prefill(cfg, p, toks[:, :8], ctx=12)
    old = {n: {k: t.clone() for k, t in c.items()}
           for n, c in caches.items() if n != "index"}
    old["index"] = caches["index"].clone()
    got, new = LM.lm_decode(cfg, p, caches, toks[:, 8:])
    for name in ("p0",):
        for leaf in ("k", "v"):
            assert new[name][leaf] is caches[name][leaf]       # aliased
            assert not torch.equal(caches[name][leaf], old[name][leaf])
            # only position 8 changed
            assert torch.equal(caches[name][leaf][:, :, :8],
                               old[name][leaf][:, :, :8])
    assert int(new["index"]) == 9 and int(caches["index"]) == 8
    again, _ = LM.lm_decode(cfg, p, old, toks[:, 8:])           # the clone
    assert torch.equal(again, got)


def test_params_from_arrays_copies_path_for_path():
    jcfg, cfg, jp, p = _params("qwen2-7b")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        t = p
        for k in path:
            t = t[k.key]
        assert t.shape == leaf.shape and t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(leaf))
    a = np.ones((2, 3), np.float32)
    t = LM.params_from_arrays({"w": a}, device="cpu")["w"]
    a[0, 0] = 5.0
    assert float(t[0, 0]) == 1.0                        # a copy
    bf = LM.params_from_arrays(
        {"w": np.asarray(jnp.arange(4, dtype=jnp.bfloat16) / 3)},
        device="cpu")["w"]
    assert bf.dtype == torch.bfloat16
    assert bf.float().tolist() == np.asarray(
        jnp.arange(4, dtype=jnp.bfloat16) / 3).astype(np.float32).tolist()
    cast = LM.params_from_arrays({"w": a}, device="cpu",
                                 dtype=torch.bfloat16)["w"]
    assert cast.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", DENSE)
def test_init_lm_has_the_reference_tree(arch):
    jcfg, cfg = _pair(arch)
    shapes = jax.eval_shape(
        lambda: jget_bundle(jcfg).init(jcfg, KEY, dtype=jnp.bfloat16))
    gen = torch.Generator().manual_seed(0)
    params = get_bundle(cfg).init(cfg, gen, dtype=torch.bfloat16,
                                  device="cpu")
    want = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}['{k}']")
            else:
                assert v.dtype == torch.bfloat16
                got[f"{prefix}['{k}']"] = tuple(v.shape)
    walk(params, "")
    assert got == want
    # caches: the reference's shapes and a scalar int32 index
    caches = LM.init_caches(cfg, 3, 20, device="cpu")
    jcaches = jax.eval_shape(lambda: JLM.init_caches(jcfg, 3, 20))
    assert {n: {k: tuple(t.shape) for k, t in c.items()}
            for n, c in caches.items() if n != "index"} == \
        {n: {k: tuple(t.shape) for k, t in c.items()}
         for n, c in jcaches.items() if n != "index"}
    assert caches["index"].dtype == torch.int32 and caches["index"].ndim == 0
    # same seed, same weights; the reference's init scale on the embedding
    again = LM.init_lm(cfg, torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")
    assert torch.equal(again["embed"], params["embed"])
    assert abs(float(params["embed"].float().std()) - 0.02) < 0.002


def _cards_mesh() -> Mesh:
    """Two distinct cards as positions: a plan over them, checked without
    a card."""
    return Mesh([[torch.device("cuda", 0), torch.device("cuda", 1)]],
                ("data", "model"))


def _two_devices() -> Mesh:
    """Two distinct devices the CPU runs (torch keeps ``cpu:0`` and
    ``cpu:1`` apart): a plan over them owns its shards by default."""
    return Mesh([[torch.device("cpu", 0), torch.device("cpu", 1)]],
                ("data", "model"))


@pytest.mark.parametrize("arch", OWN_BUNDLE)
def test_unported_families_are_refused(arch, tmp_path):
    """The family's bundle is its own (enc-dec: ``models/encdec.py``) and
    serves its entry points on the CPU.  On a one-device mesh its plan,
    its training step and a restore run; over distinct devices its plan's
    positions own their shards, and its training step and a restore run
    there too (nothing is refused any longer): the same loss and the
    restored pieces the saved leaves bit for bit."""
    from repro_torch.dist.collectives import gather_to
    from repro_torch.dist.sharding import Sharded
    from repro_torch.models import encdec as ED
    from repro_torch.train import checkpoint as K
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import init_state, jit_train_step
    from repro_torch.train.tree import tree_leaves
    cfg = configs.reduced(configs.get_config(arch))
    bundle = get_bundle(cfg)
    assert bundle.init is ED.init_encdec
    assert bundle.init_caches is ED.init_encdec_caches
    assert ED.init_encdec_caches(cfg, 2, 8, device="cpu")["index"] == 0
    mesh = Mesh([["cpu"] * 2] * 2, ("data", "model"))
    opt = make_optimizer(OptimizerConfig())
    state = init_state(cfg, opt, torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")
    assert make_plan(cfg, mesh).attn_mode == "tp"
    batch = batch_for(cfg, configs.ShapeConfig("m", 16, 2, "train"), 0)
    step, _ = jit_train_step(cfg, opt, mesh)
    new, m = step(state, batch)
    _, want = jit_train_step(cfg, opt, None)[0](state, batch)
    assert float(m["loss"]) == float(want["loss"])
    K.save_checkpoint(str(tmp_path), new, 1)
    got, _ = K.restore_checkpoint(str(tmp_path), state, mesh=mesh)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(new)))
    assert make_plan(cfg, _cards_mesh()).own_shards
    two = _two_devices()
    step, splan = jit_train_step(cfg, opt, two)
    assert splan.own_shards
    own, om = step(state, batch)
    assert abs(float(om["loss"]) - float(want["loss"])) <= \
        1e-5 * abs(float(want["loss"]))
    assert all(isinstance(x, Sharded) for x in tree_leaves(own))
    pieces, at = K.restore_checkpoint(str(tmp_path), state, mesh=two)
    assert at == 1
    assert all(isinstance(x, Sharded) and torch.equal(gather_to(x, "cpu"), w)
               for x, w in zip(tree_leaves(pieces), tree_leaves(new)))


def test_unported_entry_points_are_refused():
    """The loss is ported (a finite scalar), and so is the mesh on one
    device: the plan, ``shard``'s checks, the placed train step and the
    cross-pod compression's call site.  Over distinct devices the plan's
    positions own their shards, and the train step runs there too (the
    loss the held-once step's within 1e-5; nothing is refused)."""
    from repro_torch.dist.sharding import P
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import (init_state, jit_train_step,
                                           make_train_step)
    _, cfg, _, p = _params("olmo-1b")
    toks = _t(_tokens(cfg, 1, 4))
    loss = get_bundle(cfg).loss(cfg, p, {"tokens": toks, "labels": toks},
                                make_plan(cfg, None))
    assert loss.ndim == 0 and bool(torch.isfinite(loss))
    mesh = Mesh([["cpu"] * 2] * 2, ("data", "model"))
    plan = make_plan(cfg, mesh)
    assert plan.mesh is mesh and plan.attn_mode == "tp"
    assert plan.hidden == P("data", None, "model")
    assert L.shard(toks, P("data"), mesh) is toks
    with pytest.raises(ValueError, match="not in the mesh"):
        L.shard(toks, P("pod"), mesh)
    opt = make_optimizer(OptimizerConfig())
    state = init_state(cfg, opt, torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")
    batch = {"tokens": toks.numpy(), "labels": toks.numpy()}
    step_fn, splan = jit_train_step(cfg, opt, mesh)
    assert splan == plan
    pods = Mesh(np.array(["cpu"] * 8, object).reshape(2, 2, 2),
                ("pod", "data", "model"))
    _, plain = make_train_step(cfg, opt)(state, batch)
    _, mesh_m = step_fn(state, batch)
    _, pod_m = make_train_step(cfg, opt, make_plan(cfg, pods),
                               grad_compress=True)(state, batch)
    assert float(mesh_m["loss"]) == float(plain["loss"]) == \
        float(pod_m["loss"])
    assert float(pod_m["gnorm"]) != float(plain["gnorm"])   # compressed
    own = make_plan(cfg, _cards_mesh())
    assert own.own_shards and own.hidden == plan.hidden
    step_fn, splan = jit_train_step(cfg, opt, _two_devices())
    assert splan.own_shards
    _, own_m = step_fn(state, batch)
    assert abs(float(own_m["loss"]) - float(plain["loss"])) <= \
        1e-5 * abs(float(plain["loss"]))
    step_fn, splan = jit_train_step(cfg, opt, None)
    assert callable(step_fn) and splan == ShardingPlan()
    plan = make_plan(cfg, None)
    assert plan == ShardingPlan()
    assert plan.mesh is None and jmake_plan(cfg, None).mesh is None
    assert L.shard(toks, None, plan.mesh) is toks


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points default to it")
    cfg = configs.reduced(configs.get_config("olmo-1b"))
    for call in (lambda: LM.init_lm(cfg, torch.Generator()),
                 lambda: LM.init_caches(cfg, 1, 8),
                 lambda: LM.params_from_arrays({"w": np.ones(2)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
