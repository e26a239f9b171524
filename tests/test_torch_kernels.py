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

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forest import make_forest as jmake_forest
from repro.core.postprocess import postprocess as jpostprocess
from repro.kernels.ops import FUSED_KERNEL_ALGORITHMS as JFUSED
from repro.kernels.ops import KERNEL_ALGORITHMS as JRAW
from repro_torch.core.forest import hb_path_matrix, qs_bitvectors
from repro_torch.core.postprocess import postprocess
from repro_torch.kernels import _build, common, ops
from repro_torch.kernels.common import (pack_nodes, sum_trees_in_order,
                                        unpack_nodes)
from repro_torch.kernels.forest_hummingbird import (hb_structure,
                                                    hummingbird_fused_plain,
                                                    hummingbird_raw_plain)
from repro_torch.kernels.forest_predicated import (predicated_fused_plain,
                                                   predicated_raw_plain)
from repro_torch.kernels.forest_quickscorer import (check_words, dead_words,
                                                    in_word_mask,
                                                    qs_node_masks,
                                                    qs_word_split, qs_words,
                                                    quickscorer_fused_plain,
                                                    quickscorer_raw_plain)
from repro_torch.kernels.ops import (FUSED_KERNEL_ALGORITHMS,
                                     KERNEL_ALGORITHMS, KERNEL_WRAPPERS,
                                     RAW_KERNEL_WRAPPERS, default_tree_block,
                                     kernel_trees, predict_raw_pallas,
                                     predict_sum_pallas, prepare_inputs)

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
    """The kernel's int8 structure tensor is hb_path_matrix's C, transposed
    and zero-padded to the mma shape; D is padded with -1 (never hit)."""
    for depth in range(1, 9):
        ct, D = hb_structure(depth)
        C, D_ref = hb_path_matrix(depth)
        I, L = C.shape
        assert ct.dtype == np.int8 and D.dtype == np.int32
        assert ct.shape == (max(8, L), max(32, L))
        assert np.array_equal(ct[:L, :I], C.T)
        assert not ct[L:].any() and not ct[:, I:].any()
        assert np.array_equal(D[:L], D_ref) and (D[L:] == -1).all()


def _popcount_path_counts(s: np.ndarray, C: np.ndarray) -> np.ndarray:
    """P[b, l] = popc(S & Cpos[l]) - popc(S & Cneg[l]) over bit-packed
    words: the popcount form of the contraction."""
    I, L = C.shape
    words = (I + 31) // 32

    def pack(bits):                         # [..., I] -> [..., words]
        out = np.zeros(bits.shape[:-1] + (words,), np.uint64)
        for i in range(I):
            out[..., i // 32] |= bits[..., i].astype(np.uint64) << np.uint64(
                i % 32)
        return out

    sw = pack(s)                            # [B, words]
    pos, neg = pack((C == 1).T), pack((C == -1).T)        # [L, words]

    def popc(a):
        return np.array([bin(int(v)).count("1") for v in a.ravel()]
                        ).reshape(a.shape)

    return (popc(sw[:, None] & pos[None]).sum(-1)
            - popc(sw[:, None] & neg[None]).sum(-1))


@pytest.mark.parametrize("depth", [1, 2, 3, 5, 8])
def test_int8_path_product_equals_popcount_form(depth):
    """S_int8 @ C_int8 accumulated in int32 (what the tensor cores do) is
    the popcount P of the bit-packed masks, for random S."""
    ct, _ = hb_structure(depth)
    C, _ = hb_path_matrix(depth)
    I, L = C.shape
    s = np.random.default_rng(depth).random((40, ct.shape[1])) < 0.5
    s[:, I:] = False                        # the kernel's S pad bytes are 0
    S = torch.from_numpy(s.astype(np.int8))
    P = S.to(torch.int32) @ torch.from_numpy(ct).to(torch.int32).T
    assert P.dtype == torch.int32
    assert np.array_equal(P[:, :L].numpy(),
                          _popcount_path_counts(s[:, :I], C))
    assert not P[:, L:].any()               # pad leaves: P = 0, D = -1


@pytest.mark.parametrize("depth", range(1, 9))
def test_qs_node_masks_reproduce_qs_bitvectors(depth):
    """The CUDA kernel's mask rule (top nodes kill whole words, the rest
    AND one in-word mask), rebuilt as [I, W], is the reference's bv."""
    assert np.array_equal(qs_node_masks(depth), qs_bitvectors(depth))
    assert np.array_equal(qs_node_masks(depth).view(np.int32),
                          qs_words(depth))


@pytest.mark.parametrize("depth", range(1, 9))
def test_qs_nodes_below_the_top_levels_touch_one_word(depth):
    """Every node at level >= D - 5 has exactly one mask word that is not
    all-ones (its in-word mask); a top node at level d clears 2^(K-d-1)
    whole words.  At depth 8: 260 of the 2,040 words."""
    bv = qs_bitvectors(depth)
    dw, K, W = qs_word_split(depth)
    touched = (bv != 0xFFFFFFFF).sum(axis=1)
    level = np.floor(np.log2(np.arange(1, bv.shape[0] + 1))).astype(int)
    assert (touched[level >= depth - 5] == 1).all()
    for d in range(K):
        assert (touched[level == d] == 1 << (K - d - 1)).all()
        assert (bv[level == d] % 0xFFFFFFFF == 0).all()   # whole words
    assert touched.sum() == sum((1 << d) << (K - d - 1) for d in range(K)) \
        + W * ((1 << dw) - 1)
    if depth == 8:
        assert (touched.sum(), bv.size) == (260, 2040)


def _simulate_quickscorer_kernel(x, nodes, leaf_value, depth):
    """numpy, in csrc/forest_quickscorer.cu's order, each thread's R rows
    at once: the dead-word mask from the top nodes, then word by word the
    in-word ANDs into one register, and the first non-zero word's lowest
    bit -> [B, T] scores.  Rows past B are zeros, as the kernel stages."""
    R = common.QS_ROWS_PER_THREAD
    fe, th, dl = (a.numpy() for a in unpack_nodes(nodes))
    lv = leaf_value.numpy()
    B, F = x.shape
    xs = np.zeros((-(-B // R) * R, F), np.float32)
    xs[:B] = x
    xs = xs.reshape(-1, R, F)                     # [threads, R, F]
    dw, K, W = qs_word_split(depth)
    ones = np.uint32(0xFFFFFFFF)
    out = np.empty(xs.shape[:2] + (fe.shape[0],), np.float32)
    for t in range(fe.shape[0]):
        def left(slot):
            i = slot - 1
            v = xs[:, :, fe[t, i]]
            return np.where(np.isnan(v), dl[t, i], v < th[t, i])

        dead = np.zeros(xs.shape[:2], np.uint32)
        for d in range(K):
            for p in range(1 << d):
                dead |= np.where(left((1 << d) + p), np.uint32(0),
                                 np.uint32(dead_words(K, d, p)))
        leaf = np.full(xs.shape[:2], -1)
        for w in range(W):
            cur = np.full(xs.shape[:2], ones)
            for k in range(dw):
                for q in range(1 << k):
                    cur &= np.where(left(((W + w) << k) + q), ones,
                                    np.uint32(in_word_mask(dw, k, q)))
            surv = np.where((dead >> np.uint32(w)) & 1, np.uint32(0), cur)
            low = surv & (~surv + np.uint32(1))
            bit = np.log2(np.maximum(low, 1).astype(np.float64)).astype(int)
            leaf = np.where((leaf < 0) & (surv != 0), w * 32 + bit, leaf)
        assert (leaf >= 0).all() and (leaf < 1 << depth).all()
        out[:, :, t] = lv[t, leaf]
    return out.reshape(-1, fe.shape[0])[:B]


@pytest.mark.parametrize("depth", range(1, 9))
def test_quickscorer_kernel_order_matches_plain(depth):
    """The kernel's word-by-word order gives the plain version's scores
    bit for bit, on rows with NaNs, whole-NaN rows, +-inf and -0.0
    leaves, and a ragged last group of rows."""
    _, tf, x = _case(4 * 9 + 3, 6, depth, 7, 40 + depth, nan_frac=0.2)
    x[1, 0], x[2, 3] = np.inf, -np.inf
    lv = tf.leaf_value.clone()
    lv[:, ::3] = -0.0
    tf = dataclasses.replace(tf, leaf_value=lv)
    args, tiles = prepare_inputs("quickscorer", tf, torch.from_numpy(x),
                                 fused=False)
    want = quickscorer_raw_plain(*args, depth=depth).numpy()
    got = _simulate_quickscorer_kernel(x, args[1], args[2], depth)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_quickscorer_card_path_checks_the_bit_vectors():
    """The CUDA kernel derives the masks of qs_words(depth) and reads no
    bv, so the card path raises on any other bv; the contents are
    compared once per tensor, and again after an in-place change."""
    bv = torch.as_tensor(qs_words(6))
    check_words(bv, 6)
    check_words(bv, 6)
    wrong = bv.clone()
    wrong[5, 1] ^= 4
    with pytest.raises(ValueError, match="not those of a depth-6 heap"):
        check_words(wrong, 6)
    bv[1, 0] = 0                      # in place: the next check sees it
    with pytest.raises(ValueError, match="not those of a depth-6 heap"):
        check_words(bv, 6)
    with pytest.raises(ValueError, match="do not match depth 7"):
        check_words(torch.as_tensor(qs_words(6)), 7)
    with pytest.raises(ValueError, match="do not match depth 6"):
        check_words(torch.as_tensor(qs_words(6)).long(), 6)


def test_quickscorer_rows_per_thread_mirrors_the_cuda_source():
    src = (_build.CSRC / "forest_quickscorer.cu").read_text()
    assert (f"constexpr int kRows = {common.QS_ROWS_PER_THREAD};"
            in src)
    # x, nodes, leaf_value, out: no bit-vectors cross into the kernel
    entry_points = _build.KERNEL_SOURCES["forest_quickscorer"][1]
    for _, argtypes in entry_points:
        assert argtypes.count(_build._P) == 4 + 1          # + the stream


@pytest.mark.parametrize("depth", range(1, 9))
def test_packed_nodes_round_trip(depth):
    """One 8-byte record per node, heap slot 0 unused: unpacking gives the
    feature, threshold and default_left arrays back bit for bit, extreme
    thresholds and the first and last feature included."""
    r = np.random.default_rng(depth)
    T, I, F = 7, (1 << depth) - 1, 29
    feature = r.integers(0, F, (T, I)).astype(np.int32)
    feature[0, 0], feature[-1, -1] = 0, F - 1
    threshold = r.normal(size=(T, I)).astype(np.float32)
    extremes = np.array([np.inf, -np.inf, np.finfo(np.float32).max,
                         -np.finfo(np.float32).max, np.finfo(np.float32).tiny,
                         1e-45, -0.0, 0.0], np.float32)
    flat = threshold.reshape(-1)
    flat[:min(flat.size, extremes.size)] = extremes[:flat.size]
    default_left = r.random((T, I)) < 0.5
    nodes = pack_nodes(torch.from_numpy(feature), torch.from_numpy(threshold),
                       torch.from_numpy(default_left))
    assert nodes.shape == (T, 1 << depth, 2) and nodes.dtype == torch.int32
    assert not nodes[:, 0].any()
    fe, th, dl = unpack_nodes(nodes)
    assert fe.dtype == torch.int32 and np.array_equal(fe.numpy(), feature)
    assert np.array_equal(th.numpy().view(np.uint32),
                          threshold.view(np.uint32))
    assert np.array_equal(dl.numpy(), default_left)


def test_block_heuristics_fit_shared_memory():
    # a launch over 500 trees walks double-buffered 8-tree tiles; a
    # one-tile launch (a rel partition) takes 16 trees and one buffer.
    # QuickScorer's threads hold 4 samples each: 128 threads (512 samples)
    # a block, and its 16-tree raw launch walks 4-tree tiles, two buffers
    want = {"predicated": ((256, 8), (256, 16)),
            "hummingbird": ((256, 8), (256, 16)),
            "quickscorer": ((128, 8), (128, 4))}
    for kind in BASES:
        fused_tiles, raw_tiles = want[kind]
        bb, bt = common.block_heuristics(kind, 11_000_000, 500, 28, 8)
        assert (bb, bt) == fused_tiles
        assert common.tile_smem_bytes(kind, bb, bt, 28, 8, buffers=2) \
            <= common.smem_budget(kind)
        tiles = common.block_heuristics(kind, 11_000_000, 16, 28, 8,
                                        fused=False)
        assert tiles == raw_tiles
        rows = tiles[0] * common.rows_per_thread(kind)
        assert rows == 256 if kind != "quickscorer" else rows == 512
        buffers = common.tree_buffers(16, tiles[1])
        # the raw kernels add their [rows, BT + 1] out tile and still fit
        assert common.tile_smem_bytes(kind, *tiles, 28, 8, fused=False,
                                      buffers=buffers) \
            == common.tile_smem_bytes(kind, *tiles, 28, 8, buffers=buffers) \
            + rows * (tiles[1] + 1) * 4
        assert common.tile_smem_bytes(kind, *tiles, 28, 8, fused=False,
                                      buffers=buffers) \
            <= common.smem_budget(kind)
    # two blocks an SM for predicated / QuickScorer, one for HummingBird
    assert common.smem_budget("predicated") == common.SMEM_BUDGET
    assert common.smem_budget("hummingbird") == common.SMEM_BLOCK_MAX
    # small batches shrink the sample tile to a warp multiple
    assert common.block_heuristics("predicated", 7, 3, 5, 2) == (32, 2)
    assert common.block_heuristics("quickscorer", 7, 3, 5, 2) == (32, 2)
    # a staged x tile shrinks the sample tile with F; too wide for any
    # staged tile raises
    bb, bt = common.block_heuristics("quickscorer", 4096, 500, 400, 8,
                                     staged=True)
    assert bb < 256 and bb * common.QS_ROWS_PER_THREAD % 32 == 0
    # down to 32 samples a block, as one sample a thread allows: 8
    # QuickScorer threads at Bosch's 968 features
    assert common.block_heuristics("quickscorer", 4096, 500, 968, 8,
                                   staged=True) == (8, 1)
    assert common.block_heuristics("predicated", 4096, 500, 968, 8,
                                   staged=True) == (32, 1)
    with pytest.raises(ValueError, match="does not fit"):
        common.block_heuristics("predicated", 64, 8, 5000, 8, staged=True)
    with pytest.raises(ValueError, match="does not fit"):
        common.block_heuristics("quickscorer", 64, 8, 5000, 8, staged=True)
    # the wide-row mode holds no x tile: at any F its tiles are those of
    # a narrow F without x, and nothing raises; past any staged tile's
    # width it is the mode every kernel takes
    for kind in BASES:
        narrow = common.block_heuristics(kind, 4096, 500, 1, 8,
                                         staged=False)
        for F in (400, 968, 5000, 100_000):
            assert common.block_heuristics(kind, 4096, 500, F, 8,
                                           staged=False) == narrow
        for F in (5000, 100_000):
            assert not common.x_staged(kind, F, 8)
            assert common.block_heuristics(kind, 4096, 500, F, 8) \
                == narrow


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "raw"])
@pytest.mark.parametrize("kind", BASES)
def test_tile_smem_bytes_mirrors_the_cuda_layout(kind, fused):
    """csrc/forest_common.cuh:tile_layout, part by part: x [F][rows] f32,
    then per tree buffer records [BT][L] int2 and leaves [BT][L] f32, the
    kind's extra, the raw out tile [rows][BT + 1] f32; each 16-byte
    aligned.  rows = BB, or 4 * BB for QuickScorer (kRows samples a
    thread), which has no extra: it derives its masks."""
    def a16(n):
        return -(-n // 16) * 16

    for depth in range(1, 9):
        I, L = (1 << depth) - 1, 1 << depth
        kp, np_ = max(32, L), max(8, L)
        for bb, bt, F in ((256, 16, 28), (32, 1, 5), (64, 3, 11)):
            extra = {"predicated": 0,
                     "hummingbird": a16(np_ * kp) + a16(4 * np_) + bb * kp,
                     "quickscorer": 0}[kind]
            rows = bb * (4 if kind == "quickscorer" else 1)
            for buffers in (1, 2):
                want = (a16(4 * F * rows)
                        + buffers * (a16(8 * bt * L) + a16(4 * bt * L))
                        + a16(extra)
                        + (0 if fused else a16(4 * rows * (bt + 1))))
                assert common.tile_smem_bytes(
                    kind, bb, bt, F, depth, fused=fused,
                    buffers=buffers) == want
    # the phase-7 rel partition of the raw predicated kernel, by hand:
    # 28 x 256 x 4 + 16 x 256 x 8 + 16 x 256 x 4 + 256 x 17 x 4
    if kind == "predicated" and not fused:
        assert common.tile_smem_bytes(kind, 256, 16, 28, 8,
                                      fused=False) == 95_232
    # and QuickScorer's: 28 x 512 x 4 + 2 x (4 x 256 x 12) + 512 x 5 x 4
    if kind == "quickscorer" and not fused:
        assert common.tile_smem_bytes(kind, 128, 4, 28, 8, fused=False,
                                      buffers=2) == 92_160


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
    assert default_tree_block(wide, fused=False) == 16


def test_tree_records_are_built_once_per_forest(monkeypatch):
    """No launch packs or pads trees: the records of a forest (and of each
    tree tile it is padded to) are built at its first launch and reused;
    a rel plan's partitions get slices of the model's records."""
    built = []
    real = ops.pack_nodes

    def counting(*a):
        built.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(ops, "pack_nodes", counting)
    _, tf, x = _case(16, 6, 4, 9, 21)
    xt = torch.from_numpy(x)
    for _ in range(3):
        predict_sum_pallas(tf, xt, "predicated_pallas_fused", block_t=4)
    assert len(built) == 2              # the records, then 2 pad trees
    nodes, leaves = kernel_trees(tf, 4)
    assert nodes.shape == (8, 16, 2) and leaves.shape == (8, 16)
    assert kernel_trees(tf, 4)[0] is nodes
    fe, th, dl = unpack_nodes(nodes[6:])
    assert (fe == 0).all() and torch.isinf(th).all() and dl.all()
    built.clear()
    part = dataclasses.replace(tf, feature=tf.feature[2:4],
                               threshold=tf.threshold[2:4],
                               default_left=tf.default_left[2:4],
                               leaf_value=tf.leaf_value[2:4])
    ops.share_packed_nodes(part, ops.packed_nodes(tf)[2:4])
    assert torch.equal(predict_raw_pallas(part, xt, "predicated_pallas"),
                       predict_raw_pallas(tf, xt, "predicated_pallas")[:, 2:4])
    assert built == []
    with pytest.raises(ValueError, match="do not fit"):
        ops.share_packed_nodes(part, ops.packed_nodes(tf))


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
        assert got.shape == (16, args[1].shape[0])
        assert torch.equal(got, RAW_PLAIN[kind](*args, depth=tiles["depth"]))
        meta = [a.to("meta") for a in args]
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(*meta, **tiles)
        assert wrapper.launches == before


def test_prepare_inputs_pads_like_the_reference():
    """Trees are padded like the reference's (pass-through, zero leaves);
    samples are not: the kernels mask their ragged last block."""
    _, tf, x = _case(9, 5, 3, 6, 13)
    args, tiles = prepare_inputs("predicated", tf, torch.from_numpy(x),
                                 block_b=32, block_t=4)
    xp, nodes, lv = args
    assert torch.equal(xp, torch.from_numpy(x))
    fe, th, dl = unpack_nodes(nodes)
    assert fe.shape == (8, 7) and (fe[5:] == 0).all()
    assert torch.isinf(th[5:]).all() and dl[5:].all()
    assert torch.equal(fe[:5], tf.feature) and torch.equal(dl[:5],
                                                           tf.default_left)
    assert lv.shape == (8, 8) and (lv[5:] == 0).all()
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

