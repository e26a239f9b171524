"""Port parity: the Mamba2 SSD block (``repro_torch.models.ssd``) against the
reference's ``repro.models.ssd`` on the CPU.

  * ``init_ssd``'s tree, shapes and dtypes (``A_log`` / ``D`` / ``dt_bias``
    f32 in a bf16 model) equal the reference's;
  * ``_softplus`` equals ``jax.nn.softplus`` on the range the block feeds
    it, the pad positions' -1e9 included, where torch's own softplus takes
    its linear branch past 20;
  * ``_segsum`` and ``_gated_rmsnorm`` equal the reference's;
  * ``ssd_forward`` equals the reference's at chunk sizes that divide S and
    at ones that do not (the padded tail), with and without
    ``return_cache``, on random ``A_log`` / ``D`` / ``dt_bias`` / ``conv_b``
    (init gives zeros and ones), within rtol = atol = 1e-5;
  * ``ssd_decode`` over several steps equals the reference's on f32 caches
    (1e-5) and on bf16 conv caches (stated below), and writes its cache in
    place;
  * the reference's own claim (``tests/test_property.py:126``): the chunked
    scan equals the per-token recurrence, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssd as JS
from repro_torch import configs
from repro_torch.models import lm as LM
from repro_torch.models import ssd as S

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "mamba2-2.7b"


def _cfgs():
    return (jconfigs.reduced(jconfigs.get_config(ARCH)),
            configs.reduced(configs.get_config(ARCH)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _params(seed: int = 0, dtype=jnp.float32):
    """The reference's SSD parameters with random f32 ``A_log`` / ``D`` /
    ``dt_bias`` / ``conv_b`` (so every term of the block is live), and the
    port's copy of them."""
    jcfg, cfg = _cfgs()
    jp = JS.init_ssd(jcfg, jax.random.PRNGKey(seed), dtype)
    r = np.random.default_rng(seed + 100)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    H = cfg.ssm_heads
    tree["A_log"] = r.normal(0.0, 0.5, H).astype(np.float32)
    tree["D"] = r.normal(1.0, 0.5, H).astype(np.float32)
    tree["dt_bias"] = r.normal(0.0, 1.0, H).astype(np.float32)
    tree["conv_b"] = r.normal(0.0, 0.1, tree["conv_b"].shape).astype(
        tree["conv_b"].dtype)
    tree["norm"] = r.normal(1.0, 0.2, tree["norm"].shape).astype(
        tree["norm"].dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, cfg, jp, LM.params_from_arrays(tree, device="cpu")


def _x(cfg, B, S_, seed, scale=0.5):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S_, cfg.d_model)) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_ssd_has_the_reference_tree(dtype):
    jcfg, cfg = _cfgs()
    jp = JS.init_ssd(jcfg, KEY, getattr(jnp, dtype))
    p = S.init_ssd(cfg, torch.Generator().manual_seed(0),
                   getattr(torch, dtype), device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in p.items()} == \
        {k: (tuple(v.shape), "torch." + str(v.dtype)) for k, v in jp.items()}
    for name in ("A_log", "D", "dt_bias"):
        assert p[name].dtype == torch.float32
        _close(p[name], jp[name])
    # the reference's scales: 1/sqrt(fan_in) and 1/W on the conv
    assert abs(float(p["in_proj"].float().std()) * np.sqrt(cfg.d_model)
               - 1.0) < 0.05
    assert abs(float(p["conv_w"].float().std()) * cfg.conv_width
               - 1.0) < 0.1


def test_softplus_equals_jax():
    """jax's softplus is ``logaddexp(x, 0)``; torch's ``F.softplus`` returns
    ``x`` past its threshold of 20.  The port computes jax's form, equal
    over the dt range (bias + projection, and -1e9 at pad positions)."""
    x = np.concatenate([np.linspace(-60, 60, 24_001),
                        [-1e9, -1e4, -88.0, 0.0, 19.99, 20.0, 20.01, 1e4]]
                       ).astype(np.float32)
    got = S._softplus(_t(x))
    want = jax.nn.softplus(jnp.asarray(x))
    _close(got, want, rtol=2e-7, atol=1e-30)
    assert float(got[x == -1e9][0]) == 0.0 == float(want[x == -1e9][0])


@pytest.mark.parametrize("Q", [1, 5, 16])
def test_segsum_matches_reference(Q):
    x = np.random.default_rng(Q).normal(size=(2, 3, Q)).astype(np.float32)
    got, want = S._segsum(_t(x)), JS._segsum(jnp.asarray(x))
    assert torch.equal(torch.isinf(got), torch.from_numpy(
        np.isinf(np.asarray(want))))
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(want)[fin],
                               **TOL)


def test_gated_rmsnorm_matches_reference():
    r = np.random.default_rng(1)
    y, z = (r.normal(size=(2, 5, 32)).astype(np.float32) for _ in range(2))
    scale = r.normal(1.0, 0.3, 32).astype(np.float32)
    _close(S._gated_rmsnorm(_t(y), _t(z), _t(scale)),
           JS._gated_rmsnorm(*map(jnp.asarray, (y, z, scale))))


@pytest.mark.parametrize("S_,chunk", [
    (32, 8),        # chunk divides S: 4 chunks
    (40, 40),       # one chunk
    (37, 8),        # padded tail: 5 chunks, 3 pad positions
    (20, 32),       # chunk past S: Q = S
    (45, 16),       # padded tail over 3 chunks
    (9, 4),
], ids=["aligned", "one-chunk", "padded", "short", "padded-3", "small"])
@pytest.mark.parametrize("return_cache", [False, True],
                         ids=["out", "with-cache"])
def test_ssd_forward_matches_reference(S_, chunk, return_cache):
    jcfg, cfg, jp, p = _params(seed=S_ + chunk)
    x = _x(cfg, 2, S_, seed=S_)
    got = S.ssd_forward(cfg, p, _t(x), chunk=chunk,
                        return_cache=return_cache)
    want = JS.ssd_forward(jcfg, jp, jnp.asarray(x), chunk=chunk,
                          return_cache=return_cache)
    if not return_cache:
        assert got.shape == (2, S_, cfg.d_model)
        _close(got, want)
        return
    (out, cache), (jout, jcache) = got, want
    _close(out, jout)
    assert cache["conv"].shape == (2, cfg.conv_width - 1,
                                   cfg.d_inner + 2 * cfg.ssm_state)
    assert cache["state"].dtype == torch.float32
    assert cache["state"].shape == (2, cfg.ssm_heads, cfg.ssm_headdim,
                                    cfg.ssm_state)
    for name in ("conv", "state"):
        _close(cache[name], jcache[name])


def test_ssd_forward_with_cache_is_forward_with_return_cache():
    _, cfg, _, p = _params(seed=3)
    x = _t(_x(cfg, 1, 24, seed=3))
    out, cache = S.ssd_forward_with_cache(cfg, p, x, chunk=8)
    again, cache2 = S.ssd_forward(cfg, p, x, chunk=8, return_cache=True)
    assert torch.equal(out, again)
    assert all(torch.equal(cache[k], cache2[k]) for k in cache)
    assert torch.equal(out, S.ssd_forward(cfg, p, x, chunk=8))


def test_ssd_forward_bf16_matches_reference():
    """A bf16 model: every cast of the reference (``M`` to bf16 before
    ``y_diag``, the f32 state, the gate) on both sides.  The two libraries
    round bf16 intermediates at different points (XLA fuses elementwise
    chains), so the outputs, up to 3.6 in magnitude, are held within
    atol = 2^-4 and rtol = 2^-6 (a few bf16 ulps; the largest gap seen is
    2^-5), the f32 state within 2^-6."""
    jcfg, cfg, jp, p = _params(seed=4, dtype=jnp.bfloat16)
    assert p["in_proj"].dtype == torch.bfloat16
    assert p["A_log"].dtype == torch.float32
    x = _x(cfg, 2, 37, seed=4)
    got, cache = S.ssd_forward(cfg, p, _t(x).bfloat16(), chunk=8,
                               return_cache=True)
    want, jcache = JS.ssd_forward(jcfg, jp, jnp.asarray(x, jnp.bfloat16),
                                  chunk=8, return_cache=True)
    assert got.dtype == torch.bfloat16 and cache["state"].dtype == \
        torch.float32
    _close(got, want, rtol=2 ** -6, atol=2 ** -4)
    _close(cache["state"], jcache["state"], rtol=2 ** -6, atol=2 ** -6)


def _decode_steps(cfg, p, jcfg, jp, x, cache, jcache):
    outs, jouts = [], []
    for t in range(x.shape[1]):
        y, cache = S.ssd_decode(cfg, p, _t(x[:, t:t + 1]), cache)
        jy, jcache = JS.ssd_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                   jcache)
        outs.append(y.clone())
        jouts.append(jy)
    return torch.cat(outs, 1), jnp.concatenate(jouts, 1), cache, jcache


def test_ssd_decode_matches_reference_on_f32_caches():
    """Six steps from the prefill's cache, each output and the caches after
    the last within 1e-5 of the reference's."""
    jcfg, cfg, jp, p = _params(seed=5)
    x = _x(cfg, 3, 26, seed=5)
    _, cache = S.ssd_forward(cfg, p, _t(x[:, :20]), chunk=8,
                             return_cache=True)
    _, jcache = JS.ssd_forward(jcfg, jp, jnp.asarray(x[:, :20]), chunk=8,
                               return_cache=True)
    got, want, cache, jcache = _decode_steps(cfg, p, jcfg, jp, x[:, 20:],
                                             cache, jcache)
    _close(got, want)
    for name in ("conv", "state"):
        _close(cache[name], jcache[name])


def test_ssd_decode_on_bf16_conv_caches():
    """The engine's default: f32 weights against a bf16 ``conv`` cache (the
    state stays f32).  The reference promotes the window to f32 on its
    first step (``concatenate`` of bf16 and f32), so its returned ``conv``
    leaf is f32 from then on; the port writes the window back into the
    cache's own bf16 tensor.  The first step agrees within 1e-5 (both read
    the same bf16 window) and the port's window is the reference's rounded
    to bf16; over five more steps the outputs, O(1), agree within atol =
    2^-6 and rtol = 2^-8 (the largest gap seen is 4.8e-3, where a bf16
    rounding of the window feeds the conv)."""
    jcfg, cfg, jp, p = _params(seed=6)
    x = _x(cfg, 2, 22, seed=6)
    _, jcache = JS.ssd_forward(jcfg, jp, jnp.asarray(x[:, :16]), chunk=8,
                               return_cache=True)
    jcache = {"conv": jcache["conv"].astype(jnp.bfloat16),
              "state": jcache["state"]}
    cache = LM.params_from_arrays(jax.tree_util.tree_map(np.asarray, jcache),
                                  device="cpu")
    assert cache["conv"].dtype == torch.bfloat16
    conv, state = cache["conv"], cache["state"]
    y1, _ = S.ssd_decode(cfg, p, _t(x[:, 16:17]), cache)
    jy1, jcache1 = JS.ssd_decode(jcfg, jp, jnp.asarray(x[:, 16:17]), jcache)
    _close(y1, jy1)
    assert jcache1["conv"].dtype == jnp.float32          # the drift
    assert cache["conv"] is conv and conv.dtype == torch.bfloat16
    assert torch.equal(conv.float(), _t(np.asarray(
        jcache1["conv"].astype(jnp.bfloat16).astype(jnp.float32))))
    _close(state, jcache1["state"])
    got, want, cache, jcache = _decode_steps(cfg, p, jcfg, jp, x[:, 17:],
                                             cache, jcache1)
    assert cache["state"] is state
    _close(got, want, rtol=2 ** -8, atol=2 ** -6)
    _close(cache["conv"], jcache["conv"], rtol=2 ** -8, atol=2 ** -6)


def test_ssd_decode_writes_its_cache_in_place():
    _, cfg, _, p = _params(seed=7)
    cache = S.init_ssd_cache(cfg, 2, torch.float32, device="cpu")
    conv, state = cache["conv"], cache["state"]
    x = _t(_x(cfg, 2, 1, seed=7))
    _, new = S.ssd_decode(cfg, p, x, cache)
    assert new["conv"] is conv and new["state"] is state
    assert bool(state.abs().sum() > 0) and bool(conv[:, -1].abs().sum() > 0)
    assert torch.equal(conv[:, :-1], torch.zeros_like(conv[:, :-1]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_ssd_chunked_matches_recurrence(seed):
    """``tests/test_property.py::test_ssd_chunked_matches_recurrence`` on
    the port: the chunked scan equals the literal per-token recurrence."""
    _, cfg = _cfgs()
    p = S.init_ssd(cfg, torch.Generator().manual_seed(seed), torch.float32,
                   device="cpu")
    B, S_ = 1, 24
    x = _t(_x(cfg, B, S_, seed=seed, scale=0.3))
    full = S.ssd_forward(cfg, p, x, chunk=8)
    cache = S.init_ssd_cache(cfg, B, torch.float32, device="cpu")
    outs = []
    for t in range(S_):
        y, cache = S.ssd_decode(cfg, p, x[:, t:t + 1], cache)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-4)


def test_init_ssd_cache_matches_reference():
    jcfg, cfg = _cfgs()
    got = S.init_ssd_cache(cfg, 3, torch.bfloat16, device="cpu")
    want = JS.init_ssd_cache(jcfg, 3, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == \
        {k: (tuple(v.shape), "torch." + str(v.dtype))
         for k, v in want.items()}
    assert all(not bool(v.any()) for v in got.values())
