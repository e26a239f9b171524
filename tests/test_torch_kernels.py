"""Port parity: the kernels' plain versions and their wrappers.

On the CPU each wrapper runs its kernel's plain PyTorch version (and only
because the tensors lie on the CPU); those are held against the reference's
Pallas kernels in interpret mode over ``tests/test_fused.py``'s shape grid.
Fused sums: bit-identical on small-integer leaves, else within 1e-6 (the
port adds trees in another order than the reference's per-tile sums).  Raw
[B, T] scores: bit-identical on any leaves, since each entry is one leaf
lookup.  The CUDA kernels themselves are held against these plain versions
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forest import make_forest as jmake_forest
from repro.core.postprocess import postprocess as jpostprocess
from repro.kernels.ops import FUSED_KERNEL_ALGORITHMS as JFUSED
from repro.kernels.ops import KERNEL_ALGORITHMS as JRAW
from repro_torch.core.forest import hb_path_matrix
from repro_torch.core.postprocess import postprocess
from repro_torch.kernels import _build, common
from repro_torch.kernels.common import sum_trees_in_order
from repro_torch.kernels.forest_hummingbird import (_path_matrix, hb_masks,
                                                    hummingbird_fused_plain,
                                                    hummingbird_raw_plain)
from repro_torch.kernels.forest_predicated import (predicated_fused_plain,
                                                   predicated_raw_plain)
from repro_torch.kernels.forest_quickscorer import (quickscorer_fused_plain,
                                                    quickscorer_raw_plain)
from repro_torch.kernels.ops import (FUSED_KERNEL_ALGORITHMS,
                                     KERNEL_ALGORITHMS, KERNEL_WRAPPERS,
                                     RAW_KERNEL_WRAPPERS, default_tree_block,
                                     predict_raw_pallas, predict_sum_pallas,
                                     prepare_inputs)

from conftest import random_forest_arrays
from test_torch_forest import port_forest

BASES = ("predicated", "hummingbird", "quickscorer")
PLAIN = dict(predicated=predicated_fused_plain,
             hummingbird=hummingbird_fused_plain,
             quickscorer=quickscorer_fused_plain)
RAW_PLAIN = dict(predicated=predicated_raw_plain,
                 hummingbird=hummingbird_raw_plain,
                 quickscorer=quickscorer_raw_plain)

SHAPE_GRID = [
    # (B, T, depth, F, block_b, block_t), as tests/test_fused.py
    (8, 4, 3, 8, 8, 4),
    (16, 5, 4, 11, 8, 2),        # tree padding (5 -> 6)
    (7, 3, 2, 5, 4, 2),          # padding on both axes
    (24, 10, 8, 30, 8, 2),       # paper's depth-8 regime
    (9, 13, 5, 7, 8, 8),         # B and T both non-multiples
]


def _case(B, T, depth, F, seed, *, integer_leaves=False, nan_frac=0.0):
    fe, th, dl, lv = random_forest_arrays(None, T=T, depth=depth, F=F,
                                          seed=seed)
    if integer_leaves:
        lv = np.random.default_rng(seed).integers(-8, 9, lv.shape).astype(
            np.float32)
    jf = jmake_forest(fe, th, lv, default_left=dl, n_features=F)
    r = np.random.default_rng(seed + 1)
    x = r.normal(size=(B, F)).astype(np.float32)
    if nan_frac:
        x[r.random(x.shape) < nan_frac] = np.nan
        x[::3] = np.nan                            # whole NaN rows
    return jf, port_forest(jf), x


@pytest.mark.parametrize("integer_leaves", [False, True],
                         ids=["float", "integer"])
@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("shape", SHAPE_GRID,
                         ids=[f"B{b}T{t}d{d}F{f}" for b, t, d, f, _, _
                              in SHAPE_GRID])
def test_fused_matches_reference_kernel(base, shape, integer_leaves):
    B, T, depth, F, bb, bt = shape
    seed = zlib.crc32(f"{base}{shape}".encode()) % 9973
    jf, tf, x = _case(B, T, depth, F, seed, integer_leaves=integer_leaves)
    name = base + "_pallas_fused"
    want = np.asarray(JFUSED[name](jf, jnp.asarray(x), block_b=bb,
                                   block_t=bt, interpret=True))
    got = FUSED_KERNEL_ALGORITHMS[name](tf, torch.from_numpy(x)).numpy()
    assert got.shape == (B,)
    if integer_leaves:
        assert np.array_equal(got, want), (got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("integer_leaves", [False, True],
                         ids=["float", "integer"])
@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("shape", SHAPE_GRID,
                         ids=[f"B{b}T{t}d{d}F{f}" for b, t, d, f, _, _
                              in SHAPE_GRID])
def test_raw_matches_reference_kernel(base, shape, integer_leaves):
    """[B, T] per-tree scores, with NaN and whole-NaN rows: bit-identical
    to the reference's raw Pallas kernel on float and integer leaves."""
    B, T, depth, F, bb, bt = shape
    seed = zlib.crc32(f"raw{base}{shape}".encode()) % 9973
    jf, tf, x = _case(B, T, depth, F, seed, integer_leaves=integer_leaves,
                      nan_frac=0.2)
    name = base + "_pallas"
    want = np.asarray(JRAW[name](jf, jnp.asarray(x), block_b=bb,
                                 block_t=bt, interpret=True))
    got = KERNEL_ALGORITHMS[name](tf, torch.from_numpy(x)).numpy()
    assert got.shape == (B, T)
    assert np.array_equal(got, want), (got, want)


@pytest.mark.parametrize("base", BASES)
def test_raw_sum_in_order_equals_fused(base):
    """The raw plain version added tree by tree is the fused plain version,
    bit for bit, whatever tiles each picks (padding trees add 0.0)."""
    _, tf, x = _case(33, 21, 6, 9, 17, nan_frac=0.2)
    xt = torch.from_numpy(x)
    raw = predict_raw_pallas(tf, xt, base + "_pallas")
    fused = predict_sum_pallas(tf, xt, base + "_pallas_fused")
    assert torch.equal(sum_trees_in_order(raw), fused)
    args, tiles = prepare_inputs(base, tf, xt, fused=False)
    assert torch.equal(sum_trees_in_order(RAW_PLAIN[base](*args, depth=6)),
                       PLAIN[base](*args, depth=6))


def test_predict_raw_pallas_names_the_options():
    _, tf, x = _case(4, 3, 2, 5, 1)
    with pytest.raises(ValueError, match="predicated_pallas"):
        predict_raw_pallas(tf, torch.from_numpy(x), "predicated")
    empty = predict_raw_pallas(tf, torch.zeros(0, 5), "predicated_pallas")
    assert empty.shape == (0, 3)


@pytest.mark.parametrize("base", BASES)
def test_fused_nan_rows_match_reference_kernel(base):
    jf, tf, x = _case(12, 4, 4, 9, 31, nan_frac=0.25)
    name = base + "_pallas_fused"
    want = np.asarray(JFUSED[name](jf, jnp.asarray(x), block_b=4,
                                   block_t=2, interpret=True))
    got = predict_sum_pallas(tf, torch.from_numpy(x), name).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("base", BASES)
def test_fused_tree_padding_preserves_mean(base):
    """5 trees padded to a tile multiple, randomforest MEAN by the TRUE
    count, against the reference's fused kernel + postprocess."""
    fe, th, dl, lv = random_forest_arrays(None, T=5, depth=3, F=7, seed=77)
    lv = np.abs(lv) / (np.abs(lv).max() + 1.0)
    jf = jmake_forest(fe, th, lv, default_left=dl, n_features=7,
                      model_type="randomforest")
    tf = port_forest(jf)
    x = np.random.default_rng(7).normal(size=(6, 7)).astype(np.float32)
    name = base + "_pallas_fused"
    summed = FUSED_KERNEL_ALGORITHMS[name](tf, torch.from_numpy(x),
                                           block_t=4)
    got = postprocess(summed, model_type="randomforest", num_trees=5)
    want = jpostprocess(JFUSED[name](jf, jnp.asarray(x), block_b=8,
                                     block_t=4, interpret=True),
                        model_type="randomforest", task="classification",
                        num_trees=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("base", BASES)
def test_plain_versions_ignore_tiling(base):
    """The sum is tree 0, 1, 2, ... whatever the tiles: every tile choice
    gives the same bits (the CUDA kernel adds in this order too)."""
    _, tf, x = _case(20, 11, 5, 9, 5)
    xt = torch.from_numpy(x)
    outs = [FUSED_KERNEL_ALGORITHMS[base + "_pallas_fused"](
        tf, xt, block_b=bb, block_t=bt) for bb, bt in
        ((32, 1), (64, 4), (None, None), (32, 16))]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_hb_masks_encode_the_path_matrix():
    for depth in (1, 3, 6, 8):
        cpos, cneg, D = hb_masks(depth)
        C, D_ref = hb_path_matrix(depth)
        unpacked = _path_matrix(torch.from_numpy(cpos),
                                torch.from_numpy(cneg), depth)
        assert torch.equal(unpacked, torch.from_numpy(C).float())
        assert np.array_equal(D, D_ref)


def test_block_heuristics_fit_shared_memory():
    # the HIGGS shape: 256 samples x 16 trees, two blocks per SM
    for kind in BASES:
        bb, bt = common.block_heuristics(kind, 11_000_000, 500, 28, 8)
        assert (bb, bt) == (256, 16)
        assert common.tile_smem_bytes(kind, bb, bt, 28, 8) \
            <= common.SMEM_BUDGET
    # the raw kernels add their [BB, BT + 1] out tile and still fit; the
    # HummingBird raw tile halves its tree tile for it
    for kind, bt in (("predicated", 16), ("hummingbird", 8),
                     ("quickscorer", 16)):
        tiles = common.block_heuristics(kind, 11_000_000, 1600, 28, 8,
                                        fused=False)
        assert tiles == (256, bt)
        assert common.tile_smem_bytes(kind, *tiles, 28, 8, fused=False) \
            == common.tile_smem_bytes(kind, *tiles, 28, 8) + 256 * (bt + 1) * 4
        assert common.tile_smem_bytes(kind, *tiles, 28, 8, fused=False) \
            <= common.SMEM_BUDGET
    # small batches shrink the sample tile to a warp multiple
    assert common.block_heuristics("predicated", 7, 3, 5, 2) == (32, 2)
    # wide rows shrink the sample tile; too wide for any tile raises
    bb, bt = common.block_heuristics("quickscorer", 4096, 500, 400, 8)
    assert bb < 256 and bb % 32 == 0
    with pytest.raises(ValueError, match="does not fit"):
        common.block_heuristics("predicated", 64, 8, 5000, 8)


def test_default_tree_block():
    _, tf, _ = _case(8, 40, 8, 28, 3)
    assert default_tree_block(tf) == 16
    assert default_tree_block(tf, fused=False) == 16
    _, small, _ = _case(8, 3, 3, 5, 3)
    assert default_tree_block(small) == 2
    # sized by the kernel it will launch: the raw out tile takes room the
    # fused kernel gives to trees
    _, wide, _ = _case(8, 64, 6, 60, 3)
    assert default_tree_block(wide, fused=True) == 64
    assert default_tree_block(wide, fused=False) == 32


def test_wrappers_use_plain_only_for_cpu_tensors():
    """CPU tensors take the plain version and count no launch; a tensor on
    any other device gets the kernel or an error, never the plain path."""
    _, tf, x = _case(16, 6, 4, 9, 9)
    for kind, wrapper in KERNEL_WRAPPERS.items():
        args, tiles = prepare_inputs(kind, tf, torch.from_numpy(x))
        before = wrapper.launches
        got = wrapper(*args, **tiles)
        assert wrapper.launches == before
        assert torch.equal(got, PLAIN[kind](*args, depth=tiles["depth"]))
        meta = [a.to("meta") for a in args]
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(*meta, **tiles)
        assert wrapper.launches == before


def test_raw_wrappers_use_plain_only_for_cpu_tensors():
    _, tf, x = _case(16, 6, 4, 9, 9)
    for kind, wrapper in RAW_KERNEL_WRAPPERS.items():
        args, tiles = prepare_inputs(kind, tf, torch.from_numpy(x),
                                     fused=False)
        before = wrapper.launches
        got = wrapper(*args, **tiles)
        assert wrapper.launches == before
        assert got.shape == (32, args[1].shape[0])
        assert torch.equal(got, RAW_PLAIN[kind](*args, depth=tiles["depth"]))
        meta = [a.to("meta") for a in args]
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(*meta, **tiles)
        assert wrapper.launches == before


def test_prepare_inputs_pads_like_the_reference():
    _, tf, x = _case(9, 5, 3, 6, 13)
    args, tiles = prepare_inputs("predicated", tf, torch.from_numpy(x),
                                 block_b=32, block_t=4)
    xp, fe, th, dl, lv = args
    assert xp.shape == (32, 6) and torch.equal(xp[9:], torch.zeros(23, 6))
    assert fe.shape == (8, 7) and (fe[5:] == 0).all()
    assert torch.isinf(th[5:]).all() and (dl[5:] == 1).all()
    assert dl.dtype == torch.uint8 and (lv[5:] == 0).all()
    with pytest.raises(ValueError, match="features"):
        prepare_inputs("predicated", tf, torch.zeros(4, 3))


def test_kernel_sources_are_in_the_package():
    bound = set()
    for src, entry_points in _build.KERNEL_SOURCES.values():
        text = (_build.CSRC / src).read_text()
        for fn, argtypes in entry_points:
            assert f'extern "C" int {fn}(' in text
            # B is the one 64-bit integer; every pointer is c_void_p
            assert argtypes.count(_build._LL) == 1
            bound.add(fn)
    assert bound == {f"forest_{k}_{v}" for k in BASES
                     for v in ("fused", "raw")}
    names = [_build._target(n).name for n in _build.KERNEL_SOURCES]
    assert len(set(names)) == 3 and all(n.endswith(".so") for n in names)

