"""Port parity: wide rows, the kernels' wide-row x mode.

Rows too wide for a staged x tile (more than ~1,200-1,800 features at
depth 8) once made every kernel algorithm raise, on the CPU too: the tiles
were sized before dispatch.  Now ``common.x_staged`` picks the wide-row
mode past ``X_STAGED_MAX_F``, whose tiles do not depend on F, so tiling,
the kernel paths and all three plans resolve at any width.  At 64 x 2,000
and depth 8 the port's kernel paths (their plain versions on the CPU) are
held against the reference's Pallas kernels in interpret mode on the same
numpy inputs: raw [B, T] bit-identical; fused sums bit-identical on
integer leaves, else within rtol = atol = 1e-6; the plans' predictions the
same way (a regression forest with integer leaves, so phase 2 is exact).
The CUDA kernels in both modes are held against these plain versions by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forest import make_forest as jmake_forest
from repro.core.reuse import ModelReuseCache as JCache
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.store import TensorBlockStore as JStore
from repro.kernels.ops import FUSED_KERNEL_ALGORITHMS as JFUSED
from repro.kernels.ops import KERNEL_ALGORITHMS as JRAW
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.store import TensorBlockStore
from repro_torch.kernels import common
from repro_torch.kernels.ops import (default_tree_block, predict_raw_pallas,
                                     predict_sum_pallas, prepare_inputs)

from conftest import random_forest_arrays
from test_torch_forest import port_forest

BASES = ("predicated", "hummingbird", "quickscorer")
WIDE_F = (1185, 2000, 4096, 10_000)
B, T, DEPTH, F = 64, 16, 8, 2000


def _case(seed, *, integer_leaves, T=T, F=F, B=B):
    fe, th, dl, lv = random_forest_arrays(None, T=T, depth=DEPTH, F=F,
                                          seed=seed)
    kw = {}
    if integer_leaves:
        lv = np.random.default_rng(seed).integers(-8, 9, lv.shape).astype(
            np.float32)
        kw = dict(model_type="xgboost", task="regression", base_score=0.5)
    jf = jmake_forest(fe, th, lv, default_left=dl, n_features=F, **kw)
    r = np.random.default_rng(seed + 1)
    x = r.normal(size=(B, F)).astype(np.float32)
    x[r.random(x.shape) < 0.1] = np.nan
    x[::7] = np.nan                                # whole NaN rows
    return jf, port_forest(jf), x


@pytest.mark.parametrize("F", WIDE_F)
@pytest.mark.parametrize("kind", BASES)
def test_wide_rows_tile_like_narrow_rows(kind, F):
    """In the wide-row mode (the only one past any staged tile's width)
    the tiles are those of a narrow F without an x tile, for fused and
    raw launches, one-tile (rel partition) launches included, and fit a
    block."""
    for fused in (True, False):
        fits = common.tile_smem_bytes(
            kind, 32 // common.rows_per_thread(kind), 1, F, DEPTH,
            fused=fused) <= common.SMEM_BLOCK_MAX
        assert common.x_staged(kind, F, DEPTH, fused) is (
            kind != "predicated" and fits)
        for one_tile in (False, True):
            got = common.block_heuristics(kind, 1_000_000, 1600, F, DEPTH,
                                          fused=fused, one_tile=one_tile,
                                          staged=False)
            want = common.block_heuristics(kind, 1_000_000, 1600, 1, DEPTH,
                                           fused=fused, one_tile=one_tile,
                                           staged=False)
            assert got == want
            bb, bt = got
            buffers = 1 if one_tile else common.tree_buffers(1600, bt)
            assert common.tile_smem_bytes(
                kind, bb, bt, F, DEPTH, fused=fused, buffers=buffers,
                staged=False) <= common.smem_budget(kind)
    # a staged tile of that width does not fit at all; asked for, it raises
    if F >= 2000:
        with pytest.raises(ValueError, match="does not fit"):
            common.block_heuristics(kind, 64, 8, F, DEPTH, staged=True)


@pytest.mark.parametrize("F", WIDE_F)
def test_default_tree_block_at_wide_rows(F):
    """A wide rel plan gets partitions of the tree tile's size, not one
    tree each: 16 trees for the raw kernel at depth 8, as at HIGGS, and
    32 for the fused one, whose tile no x shares."""
    _, tf, _ = _case(1, integer_leaves=False, T=40, F=F, B=4)
    assert default_tree_block(tf) == 32
    assert default_tree_block(tf, fused=False) == 16


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "raw"])
@pytest.mark.parametrize("kind", BASES)
def test_x_mode_switch_points(kind, fused):
    """Staged at the HIGGS width; past the measured crossover, or where no
    staged 32-sample tile fits a block, the wide-row mode."""
    assert common.x_staged(kind, 28, DEPTH, fused)
    limit = common.X_STAGED_MAX_F[kind, fused]
    if limit is not None:
        assert common.x_staged(kind, limit, DEPTH, fused)
        assert not common.x_staged(kind, limit + 1, DEPTH, fused)
    widest = max(F for F in range(28, 2000)
                 if common.x_staged(kind, F, DEPTH, fused))
    fits = common.tile_smem_bytes(
        kind, 32 // common.rows_per_thread(kind), 1, widest + 1, DEPTH,
        fused=fused) <= common.SMEM_BLOCK_MAX
    assert widest == limit if limit is not None else not fits
    # a shallower forest leaves a staged tile room for more features
    assert common.x_staged(kind, widest, 4, fused)


@pytest.mark.parametrize("integer_leaves", [False, True],
                         ids=["float", "integer"])
@pytest.mark.parametrize("kind", BASES)
def test_wide_fused_matches_reference_kernel(kind, integer_leaves):
    jf, tf, x = _case(11 + BASES.index(kind), integer_leaves=integer_leaves)
    name = kind + "_pallas_fused"
    want = np.asarray(JFUSED[name](jf, jnp.asarray(x), block_b=32,
                                   block_t=8, interpret=True))
    xt = torch.from_numpy(x)
    got = predict_sum_pallas(tf, xt, name).numpy()
    assert prepare_inputs(kind, tf, xt)[1]["staged"] is False
    assert got.shape == (B,) and np.isfinite(got).all()
    if integer_leaves:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", BASES)
def test_wide_raw_matches_reference_kernel(kind):
    jf, tf, x = _case(21 + BASES.index(kind), integer_leaves=False)
    name = kind + "_pallas"
    want = np.asarray(JRAW[name](jf, jnp.asarray(x), block_b=32, block_t=8,
                                 interpret=True))
    got = predict_raw_pallas(tf, torch.from_numpy(x), name).numpy()
    assert got.shape == (B, T)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("algorithm", ["predicated_pallas_fused",
                                       "hummingbird_pallas_fused",
                                       "quickscorer_pallas_fused",
                                       "predicated_pallas",
                                       "hummingbird_pallas",
                                       "quickscorer_pallas"])
@pytest.mark.parametrize("plan", ["udf", "rel", "rel+reuse"])
def test_wide_infer_matches_reference(plan, algorithm):
    """All three plans at 2,000 features, where the parent raised: the
    port's predictions equal the reference engine's, bit for bit (integer
    leaves), with the reference's stage counts; the rel plans' default
    partitions are tree tiles, not single trees."""
    jf, tf, x = _case(31, integer_leaves=True)
    jstore = JStore(default_page_rows=16)
    jstore.put("t", x)
    jengine = JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache())
    store = TensorBlockStore(device="cpu", default_page_rows=16)
    store.put("t", x)
    engine = ForestQueryEngine(store)
    n_parts = None if plan == "udf" else 2
    want = jengine.infer("t", jf, algorithm=algorithm, plan=plan,
                         n_parts=n_parts)
    got = engine.infer("t", tf, algorithm=algorithm, plan=plan,
                       n_parts=n_parts)
    g = got.predictions.numpy()
    assert g.shape == (B,) and np.isfinite(g).all()
    assert np.array_equal(g, np.asarray(want.predictions))
    assert got.num_stages == want.num_stages
    if plan != "udf" and "pallas" in algorithm:
        default = engine.infer("t", tf, algorithm=algorithm, plan=plan)
        assert default.n_parts == 1         # 16 trees: one 16-tree tile
        assert np.array_equal(default.predictions.numpy(), g)
