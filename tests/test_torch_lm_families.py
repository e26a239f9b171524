"""Port parity: the MoE, SSD and hybrid families of the LM serving path
(``repro_torch.models``) against the reference's ``repro.models`` on the
CPU, at ``reduced()`` size with the reference's f32 weights carried across
(``params_from_arrays``), within rtol = atol = 1e-5 unless a test states
otherwise.

  * MoE (llama4): ``init_moe``'s tree and its fan-in quirk; ``apply_moe``
    with and without capacity drops and ``moe_decode`` against the
    reference's, the expert indices (and the kept tokens) asserted equal
    before the outputs are compared; with and without the shared expert;
  * the hybrid (zamba2): ``_apply_shared_attn`` with a live LoRA delta in
    prefill, collect and decode modes;
  * ``lm_prefill`` / ``lm_decode`` logits and caches for mamba2, zamba2,
    llama4-scout and llama4-maverick (the alternating dense / MoE plan);
    the claims of ``tests/test_decode.py`` (decode == prefill, teacher
    forcing, the windowed mask on llama4); one decode on bf16 caches under
    f32 weights; the in-place update of the SSD and shared caches;
  * ``init_lm`` / ``init_caches`` trees and ``params_from_arrays`` key for
    key for each new family.
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
from repro_torch.dist.sharding import make_plan
from repro_torch.models import get_bundle
from repro_torch.models import layers as L
from repro_torch.models import lm as LM

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
FAMILIES = ["mamba2-2.7b", "zamba2-2.7b", SCOUT, MAVERICK]
#: two blocks, so the stacked block loop (and zamba2's per-block LoRA) runs
#: twice; ``reduced()`` alone gives one period (mamba2 already has two)
TWO_BLOCKS = {"zamba2-2.7b": 12, SCOUT: 8, MAVERICK: 8}


def _pair(arch: str, **changes):
    """(reference config, port config) at reduced() size, with changes."""
    jcfg = dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config(arch)), **changes)
    cfg = dataclasses.replace(
        configs.reduced(configs.get_config(arch)), **changes)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _live(tree: dict, seed: int) -> dict:
    """The reference's numpy tree with its constant inits made random: the
    LoRA ``b`` (zero), the SSD's ``A_log`` / ``dt_bias`` / ``conv_b``
    (zero) and ``D`` (one), so every term of the model is exercised."""
    r = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name == "b":
            return r.normal(0.0, 0.05, node.shape).astype(node.dtype)
        if name in ("A_log", "dt_bias", "conv_b"):
            return r.normal(0.0, 0.3, node.shape).astype(node.dtype)
        if name == "D":
            return r.normal(1.0, 0.3, node.shape).astype(node.dtype)
        return node
    return walk(tree)


@functools.lru_cache(maxsize=None)
def _params(arch: str, **changes):
    """The reference's live f32 parameters and the port's copy of them, at
    two blocks."""
    if arch in TWO_BLOCKS:
        changes = {"num_layers": TWO_BLOCKS[arch], **changes}
    jcfg, cfg = _pair(arch, **changes)
    assert cfg.num_blocks == 2
    tree = jax.tree_util.tree_map(
        np.asarray, jget_bundle(jcfg).init(jcfg, KEY, dtype=jnp.float32))
    tree = _live(tree, seed=len(arch))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, cfg, jp, LM.params_from_arrays(tree, device="cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _close_to_scale(got, want):
    """Within rtol = 1e-5 and atol = 1e-5 x the output's largest
    magnitude: f32 rounding of contractions whose terms are that large."""
    _close(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(_np(want)).max()))


def _tokens(cfg, B, S, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaves(caches):
    """{(name, leaf): tensor} over a cache tree, ``index`` left out."""
    return {(n, k): t for n, c in caches.items() if n != "index"
            for k, t in c.items()}


# -- MoE -------------------------------------------------------------------


def _moe(seed: int, **changes):
    jcfg, cfg = _pair(SCOUT, **changes)
    jp = JL.init_moe(jcfg, jax.random.PRNGKey(seed), 64, 256, jnp.float32)
    p = LM.params_from_arrays(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, cfg, jp, p


def test_init_moe_has_the_reference_tree():
    jcfg, cfg, jp, _ = _moe(0)
    p = L.init_moe(cfg, torch.Generator().manual_seed(0), 64, 256,
                   torch.bfloat16, device="cpu")
    jb = JL.init_moe(jcfg, KEY, 64, 256, jnp.bfloat16)
    shapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jb)
    got = {k: ({kk: (tuple(vv.shape), str(vv.dtype)[6:])
                for kk, vv in v.items()} if isinstance(v, dict)
               else (tuple(v.shape), str(v.dtype)[6:]))
           for k, v in p.items()}
    assert got == jax.tree_util.tree_map(
        lambda s: (tuple(s[0]), s[1]), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    assert p["router"].dtype == torch.float32           # whatever dtype
    # the reference's quirk: (E, d, f) expert weights take fan-in E
    E = cfg.num_experts
    assert abs(float(p["wi"].float().std()) * np.sqrt(E) - 1.0) < 0.05
    assert abs(float(p["router"].std()) * np.sqrt(64) - 1.0) < 0.1


def _ref_routing(jp, tokens: np.ndarray, capacity: int):
    """The reference's dispatch routing, from its own jnp ops
    (``layers.py:430-443``): expert index and kept flag a token."""
    logits = jnp.asarray(tokens) @ jp["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    eidx = np.asarray(jnp.argmax(probs, axis=-1))
    E = probs.shape[-1]
    onehot = np.eye(E, dtype=np.int64)[eidx]
    pos = np.take_along_axis(np.cumsum(onehot, 0) - 1, eidx[:, None],
                             1)[:, 0]
    return eidx, pos < capacity


@pytest.mark.parametrize("cf,drops", [(0.5, True), (8.0, False)],
                         ids=["capacity-drops", "no-drops"])
@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared-expert", "routed-only"])
def test_apply_moe_matches_reference(cf, drops, shared):
    """Inputs at unit scale, as the RMS-normed ``n2`` the model feeds the
    MoE; the reference's fan-in quirk makes the outputs O(100), so they are
    held to the output's scale (``_close_to_scale``)."""
    jcfg, cfg, jp, p = _moe(1, capacity_factor=cf, shared_expert=shared)
    if not shared:
        jp = {k: v for k, v in jp.items() if k != "shared"}
        p = {k: v for k, v in p.items() if k != "shared"}
    B, S_ = 2, 12
    x = np.random.default_rng(2).normal(size=(B, S_, 64)).astype(np.float32)
    cap = max(1, int(B * S_ * cf / cfg.num_experts))
    tokens = x.reshape(B * S_, 64)
    _, eidx, keep = L._moe_dispatch(p, _t(tokens), cap)
    jeidx, jkeep = _ref_routing(jp, tokens, cap)
    assert eidx.tolist() == jeidx.tolist()
    assert keep.tolist() == jkeep.tolist()
    assert (not bool(keep.all())) == drops
    routed = L._moe_dispatch(p, _t(tokens), cap)[0]
    jrouted = JL._moe_dispatch_compute(jp, jnp.asarray(tokens), cap,
                                       ep_axis=None)
    _close_to_scale(routed, jrouted)
    if drops:       # a dropped token comes back as zero
        assert not bool(routed[~keep].any())
    _close_to_scale(L.apply_moe(cfg, p, _t(x)),
                    JL.apply_moe(jcfg, jp, jnp.asarray(x)))


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared-expert", "routed-only"])
def test_moe_decode_matches_reference(shared):
    """``argmax(logits)`` routing and the per-token weight gather, held to
    the output's scale (``_close_to_scale``)."""
    jcfg, cfg, jp, p = _moe(3, shared_expert=shared)
    x = np.random.default_rng(4).normal(size=(5, 1, 64)).astype(np.float32)
    tokens = x.reshape(5, 64)
    jeidx = np.asarray(jnp.argmax(jnp.asarray(tokens) @ jp["router"], -1))
    logits, _, _ = L._route(p, _t(tokens))
    assert logits.argmax(-1).tolist() == jeidx.tolist()
    assert len(set(jeidx.tolist())) > 1               # several experts
    _close_to_scale(L.moe_decode(cfg, p, _t(x)),
                    JL.moe_decode(jcfg, jp, jnp.asarray(x)))


# -- the hybrid's shared block ------------------------------------------------


@pytest.mark.parametrize("mode", ["prefill", "collect", "decode"])
def test_shared_attn_matches_reference(mode):
    """Zamba2's shared block on concat(h, e0) with a live LoRA delta (block
    1's), in each of its three modes."""
    jcfg, cfg, jp, p = _params("zamba2-2.7b")
    assert float(np.abs(np.asarray(jp["lora"]["b"])).max()) > 0
    lora = {k: v[1] for k, v in p["lora"].items()}
    jlora = {k: v[1] for k, v in jp["lora"].items()}
    r = np.random.default_rng(5)
    D = cfg.d_model
    splan = jmake_plan(jcfg, None)
    if mode == "decode":
        B, Sc = 3, 16
        h = r.normal(size=(B, 1, D)).astype(np.float32)
        e0 = r.normal(size=(B, 1, D)).astype(np.float32)
        shape = (B, Sc, cfg.num_kv_heads, cfg.head_dim)
        k = r.normal(size=shape).astype(np.float32)
        v = r.normal(size=shape).astype(np.float32)
        idx = np.array([3, 9, 15], np.int32)
        cache = {"k": _t(k), "v": _t(v), "index": _t(idx)}
        got, nc = LM._apply_shared_attn(cfg, p["shared_attn"], lora, _t(h),
                                        _t(e0), None, decode_cache=cache)
        want, jnc = JLM._apply_shared_attn(
            jcfg, jp["shared_attn"], jlora, jnp.asarray(h), jnp.asarray(e0),
            splan, None, decode_cache={"k": jnp.asarray(k),
                                       "v": jnp.asarray(v),
                                       "index": jnp.asarray(idx)})
        assert nc["k"] is cache["k"]                  # written in place
    else:
        B, S_ = 2, 20
        h = r.normal(size=(B, S_, D)).astype(np.float32)
        e0 = r.normal(size=(B, S_, D)).astype(np.float32)
        pos = np.arange(S_, dtype=np.int32)
        collect = mode == "collect"
        got, nc = LM._apply_shared_attn(cfg, p["shared_attn"], lora, _t(h),
                                        _t(e0), _t(pos), collect=collect,
                                        ctx=24 if collect else None)
        want, jnc = JLM._apply_shared_attn(
            jcfg, jp["shared_attn"], jlora, jnp.asarray(h), jnp.asarray(e0),
            splan, jnp.asarray(pos), collect=collect,
            ctx=24 if collect else None)
        assert (nc is None) == (jnc is None) == (not collect)
    _close(got, want)
    if nc is not None:
        for name in ("k", "v"):
            _close(nc[name], jnc[name])


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch):
    """Logits within 1e-5 at prefill and at two decode steps.  The caches
    too, but for llama4's: its MoE layers add O(100) outputs (the
    reference's fan-in quirk) to the residual stream, so f32 rounding in
    the K/V grows about 1e-6 a layer; over its 8 layers they are held
    within rtol = atol = 3e-5 (the largest gap seen is 1.35e-5)."""
    jcfg, cfg, jp, p = _params(arch)
    cache_tol = dict(rtol=3e-5, atol=3e-5) if cfg.num_experts else TOL
    B, S, ctx = 2, 37, 40
    toks = _tokens(cfg, B, S + 2, seed=9)
    logits, caches = LM.lm_prefill(cfg, p, _t(toks[:, :S]), ctx=ctx)
    jlogits, jcaches = JLM.lm_prefill(jcfg, jp, jnp.asarray(toks[:, :S]),
                                      ctx=ctx)
    assert logits.dtype == torch.float32
    assert logits.shape == (B, cfg.vocab_padded)
    _close(logits, jlogits)
    assert set(caches) == set(jcaches)
    assert int(caches["index"]) == int(jcaches["index"]) == S
    got, want = _leaves(caches), _leaves(jcaches)
    assert set(got) == set(want)
    for key, t in got.items():
        assert tuple(t.shape) == tuple(want[key].shape), key
        _close(t, want[key], **cache_tol)
    for step in range(2):
        tok = toks[:, S + step:S + step + 1]
        logits, caches = LM.lm_decode(cfg, p, caches, _t(tok))
        jlogits, jcaches = JLM.lm_decode(jcfg, jp, jcaches, jnp.asarray(tok))
        _close(logits, jlogits)
        assert int(caches["index"]) == int(jcaches["index"]) == S + step + 1
        want = _leaves(jcaches)
        for key, t in _leaves(caches).items():
            _close(t, want[key], **cache_tol)


def _no_drops(arch):
    """The reference's ``test_decode.py`` disables MoE capacity drops for
    exactness (``capacity_factor=8.0``)."""
    return {"capacity_factor": 8.0} if "llama4" in arch else {}


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_prefill(arch):
    """``tests/test_decode.py::test_decode_matches_prefill`` on the port."""
    _, cfg, _, p = _params(arch, **_no_drops(arch))
    bundle, splan = get_bundle(cfg), make_plan(cfg, None)
    B, S = 2, 64
    toks = _t(_tokens(cfg, B, S, seed=10))
    full, _ = bundle.prefill(cfg, p, {"tokens": toks}, splan)
    _, caches = LM.lm_prefill(cfg, p, toks[:, :S - 1], ctx=S)
    step, _ = bundle.decode(cfg, p, caches, toks[:, S - 1:], splan)
    _close(step, full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b", SCOUT])
def test_multi_step_decode_matches_teacher_forcing(arch):
    """Three decode steps == teacher-forced prefill at each prefix."""
    _, cfg, _, p = _params(arch, **_no_drops(arch))
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
    """``tests/test_decode.py::test_windowed_decode_masks_out_of_chunk`` on
    the port: llama4's chunked-local iRoPE layers do not attend across
    window blocks."""
    jcfg, cfg, jp, p = _params(SCOUT, attn_window=16, capacity_factor=8.0)
    B, S = 1, 48                                  # 3 window blocks
    toks = _tokens(cfg, B, S, seed=12)
    full, _ = LM.lm_prefill(cfg, p, _t(toks))
    _close(full, JLM.lm_prefill(jcfg, jp, jnp.asarray(toks))[0])
    _, caches = LM.lm_prefill(cfg, p, _t(toks[:, :S - 1]), ctx=S)
    step, _ = LM.lm_decode(cfg, p, caches, _t(toks[:, S - 1:]))
    _close(step, full, rtol=1e-4, atol=1e-4)
    # the window matters: the same weights with a wider window differ
    _, wcfg, _, _ = _params(SCOUT, attn_window=64, capacity_factor=8.0)
    wide, _ = LM.lm_prefill(wcfg, p, _t(toks))
    assert not torch.allclose(wide, full, rtol=1e-3, atol=1e-3)


BF16 = dict(rtol=2 ** -8, atol=2 ** -8)        # bfloat16's epsilon


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_on_bf16_caches_matches_reference(arch):
    """The engine's default: f32 weights against bf16 caches (the SSD state
    stays f32).  Both sides decode the reference's prefill caches cast to
    bf16 with a per-slot index: the logits agree within bf16's epsilon, the
    K/V caches bit for bit, the f32 state within 1e-5.  The reference's
    ``conv`` leaf comes back f32 (its concatenate promotes), the port's is
    the cache's own bf16 tensor: equal to the reference's rounded to
    bf16 (the shifted rows bit for bit, the new row, rounded from f32 values
    within 1e-5 of each other, within bf16's epsilon)."""
    jcfg, cfg, jp, p = _params(arch)
    B, S, ctx = 3, 20, 32
    toks = _tokens(cfg, B, S + 1, seed=14)
    _, jcaches = JLM.lm_prefill(jcfg, jp, jnp.asarray(toks[:, :S]), ctx=ctx)
    idx = np.array([S, S - 3, S + 5], np.int32)
    jcaches = {n: {k: (t if k == "state" else t.astype(jnp.bfloat16))
                   for k, t in c.items()}
               for n, c in jcaches.items() if n != "index"}
    caches = LM.params_from_arrays(jax.tree_util.tree_map(np.asarray,
                                                          jcaches),
                                   device="cpu")
    jcaches["index"], caches["index"] = jnp.asarray(idx), _t(idx)
    got, new = LM.lm_decode(cfg, p, caches, _t(toks[:, S:]))
    want, jnew = JLM.lm_decode(jcfg, jp, jcaches, jnp.asarray(toks[:, S:]))
    assert got.dtype == torch.float32
    _close(got, want, **BF16)
    assert _np(new["index"]).tolist() == (idx + 1).tolist()
    jleaves = _leaves(jnew)
    for (name, leaf), t in _leaves(new).items():
        ref = jleaves[(name, leaf)]
        if leaf == "state":
            assert t.dtype == torch.float32
            _close(t, ref)
        elif leaf == "conv":    # the shifted window exact, the new row
            assert t.dtype == torch.bfloat16                # rounded
            assert ref.dtype == jnp.float32
            ref = _t(_np(ref.astype(jnp.bfloat16)))
            assert torch.equal(t[..., :-1, :].float(), ref[..., :-1, :])
            _close(t[..., -1, :], ref[..., -1, :], **BF16)
        else:
            assert t.dtype == torch.bfloat16
            assert torch.equal(t.float(), _t(_np(ref)))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_decode_updates_caches_in_place(arch):
    """The port's decode convention over the new leaves: the SSD ``conv``
    and ``state`` and the shared block's K/V are written into the given
    stacked tensors and returned; a clone decodes the same."""
    _, cfg, _, p = _params(arch)
    toks = _t(_tokens(cfg, 2, 9, seed=13))
    _, caches = LM.lm_prefill(cfg, p, toks[:, :8], ctx=12)
    old = {n: {k: t.clone() for k, t in c.items()}
           for n, c in caches.items() if n != "index"}
    old["index"] = caches["index"].clone()
    got, new = LM.lm_decode(cfg, p, caches, toks[:, 8:])
    for (name, leaf), t in _leaves(new).items():
        assert t is caches[name][leaf], (name, leaf)           # aliased
        assert not torch.equal(t, old[name][leaf]), (name, leaf)
    if cfg.shared_attn_every:       # only position 8 of the shared K/V
        for leaf in ("k", "v"):
            assert torch.equal(caches["shared"][leaf][:, :, :8],
                               old["shared"][leaf][:, :, :8])
    assert int(new["index"]) == 9 and int(caches["index"]) == 8
    again, _ = LM.lm_decode(cfg, p, old, toks[:, 8:])           # the clone
    assert torch.equal(again, got)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = (tuple(v.shape), str(v.dtype)
                                       .replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_lm_has_the_reference_tree(arch):
    jcfg, cfg = _pair(arch)
    shapes = jax.eval_shape(
        lambda: jget_bundle(jcfg).init(jcfg, KEY, dtype=jnp.bfloat16))
    params = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.bfloat16, device="cpu")
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v
            in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert _shapes(params) == want
    # caches: the reference's leaves, shapes and dtypes (f32 SSD state)
    caches = LM.init_caches(cfg, 3, 20, device="cpu")
    jcaches = jax.eval_shape(lambda: JLM.init_caches(jcfg, 3, 20))
    assert {k: v for k, v in _shapes(caches).items()
            if not k.startswith("['index']")} == \
        {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v
         in jax.tree_util.tree_flatten_with_path(jcaches)[0]
         if jax.tree_util.keystr(k) != "['index']"}
    assert caches["index"].dtype == torch.int32 and caches["index"].ndim == 0
    assert not any(bool(t.any()) for t in _leaves(caches).values())


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b", SCOUT])
def test_params_from_arrays_carries_the_family_trees(arch):
    """The reference's mamba2, zamba2 (the unstacked ``shared_attn`` beside
    the stacked ``lora``) and scout trees, key for key and value for
    value."""
    jcfg, cfg, jp, p = _params(arch)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(_shapes(p))
    for path, leaf in flat:
        t = p
        for k in path:
            t = t[k.key]
        assert t.shape == leaf.shape and t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(leaf))
    if cfg.shared_attn_every:
        assert p["shared_attn"]["attn"]["wq"].shape == \
            (2 * cfg.d_model, cfg.num_heads * cfg.head_dim)
        assert p["lora"]["a"].shape[0] == cfg.num_blocks
