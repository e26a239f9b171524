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

import sys
from pathlib import Path

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
from repro_torch.kernels.common import unpack_nodes
from repro_torch.kernels.forest_hummingbird import (hummingbird_fused_plain,
                                                    hummingbird_raw_plain)
from repro_torch.kernels.forest_predicated import predicated_fused_plain
from repro_torch.kernels.forest_quickscorer import (dead_words, in_word_mask,
                                                    qs_word_split,
                                                    quickscorer_fused_plain,
                                                    quickscorer_raw_plain)
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
        limit = common.X_STAGED_MAX_F[kind, fused]
        assert common.x_staged(kind, F, DEPTH, fused) is (F <= limit
                                                          and fits)
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
    """Staged at the HIGGS width; past the measured crossover the
    wide-row mode.  The crossovers are those measured on an H100 (PERF.md
    section 6): the wide-tiled predicated fused kernel first faster at
    512-640 features, HummingBird's at 200 (staged faster at 90), the
    row-major raw predicated one at 512, the wide-tiled QuickScorer fused
    one at 400 and raw at 200 (staged faster at 90).  Each limit is a
    width whose staged tile fits a block."""
    assert common.x_staged(kind, 28, DEPTH, fused)
    limit = common.X_STAGED_MAX_F[kind, fused]
    assert limit == {("predicated", True): 400, ("predicated", False): 400,
                     ("hummingbird", True): 90, ("hummingbird", False): 90,
                     ("quickscorer", True): 200,
                     ("quickscorer", False): 90}[kind, fused]
    assert common.x_staged(kind, limit, DEPTH, fused)
    assert not common.x_staged(kind, limit + 1, DEPTH, fused)
    widest = max(F for F in range(28, 2000)
                 if common.x_staged(kind, F, DEPTH, fused))
    assert widest == limit
    # a shallower forest stages up to the same limit
    assert common.x_staged(kind, widest, 4, fused)
    assert not common.x_staged(kind, widest + 1, 4, fused)


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


# -- the wide-tiled layout (every kernel but raw predicated) ------------------


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "raw"])
@pytest.mark.parametrize("kind", BASES)
def test_tile_smem_bytes_mirrors_the_wide_tiled_layout(kind, fused):
    """csrc/forest_common.cuh:tile_layout as the wide-tiled kernels call
    it (out_rows = kWideRows, F = 0): tree buffers, the kind's extra (one
    S tile a warp for HummingBird), and an out tile of 32 rows for fused
    kernels too, whatever rows a staged thread of the kind holds; the
    row-major wide mode (raw predicated) keeps its raw out tile of the
    block's rows."""
    def a16(n):
        return -(-n // 16) * 16

    tiled = common.wide_tiled(kind, fused)
    assert tiled is (kind != "predicated" or fused)
    for depth in range(1, 9):
        L = 1 << depth
        kp, np_ = max(32, L), max(8, L)
        for bb, bt, record in ((256, 16, 8), (128, 3, 8), (256, 32, 4)):
            if record == 4 and not fused:
                continue
            rows = bb * common.rows_per_thread(kind)
            extra = (a16(np_ * kp) + a16(4 * np_) + bb * kp
                     if kind == "hummingbird" else 0)
            out_rows = common.WIDE_ROWS if tiled else (0 if fused else rows)
            for buffers in (1, 2):
                want = (buffers * (a16(record * bt * L)
                                   + a16(record // 2 * bt * L))
                        + a16(extra) + a16(4 * out_rows * (bt + 1)))
                assert common.tile_smem_bytes(
                    kind, bb, bt, 2000, depth, fused=fused, buffers=buffers,
                    staged=False, record=record) == want
    # by hand, depth 8: fused HummingBird's 256-thread block over 8-tree
    # f32 tiles, two buffers: C^T 65,536 + D 1,024 + S 65,536, trees
    # 2 x 24,576, out 32 x 9 x 4
    if kind == "hummingbird" and fused:
        assert common.tile_smem_bytes(kind, 256, 8, 2000, 8, buffers=2,
                                      staged=False) == 182_400
    # QuickScorer's 16-tree f32 tiles, two buffers: trees 2 x 49,152, out
    # 32 x 17 x 4 -- two blocks an SM; a raw 16-tree partition holds one
    if kind == "quickscorer":
        assert common.tile_smem_bytes(kind, 256, 16, 2000, 8, fused=fused,
                                      buffers=2, staged=False) == 100_480
        assert common.tile_smem_bytes(kind, 256, 16, 2000, 8, fused=fused,
                                      staged=False) == 51_328


def test_wide_tiled_tiles_at_the_epsilon_shape():
    """The tiles the wide-tiled kernels take at 100,352 x 2,000, depth 8
    (PERF.md section 6): 256 threads, 8 warps over trees; predicated and
    QuickScorer two blocks an SM (16 f32 trees a tile, 32 bf16),
    HummingBird one (8 f32 trees a tile beside C^T and eight S tiles, 16
    bf16); raw HummingBird and raw QuickScorer over a 16-tree partition
    take it whole."""
    def tiles(kind, T, fused=True, record=8):
        return common.block_heuristics(kind, 100_352, T, 2000, DEPTH,
                                       fused=fused, record=record)

    assert tiles("predicated", 512) == (256, 16)
    assert tiles("predicated", 512, record=4) == (256, 32)
    assert tiles("hummingbird", 512) == (256, 8)
    assert tiles("hummingbird", 512, record=4) == (256, 16)
    assert tiles("hummingbird", 16, fused=False) == (256, 16)
    assert tiles("quickscorer", 512) == (256, 16)
    assert tiles("quickscorer", 512, record=4) == (256, 32)
    assert tiles("quickscorer", 16, fused=False) == (256, 16)
    # a batch of 8 rows still takes every warp: they share 32 rows, one a
    # thread, QuickScorer's too
    for kind in ("hummingbird", "quickscorer"):
        assert common.block_heuristics(kind, 8, 512, 2000, DEPTH)[0] == 256
    # one row a thread: no wide-tiled tile is sized as if it held four
    for fused in (True, False):
        assert common.rows_per_thread("quickscorer", fused,
                                      staged=False) == 1
        assert common.rows_per_thread("quickscorer", fused) == 4
        assert common.tiled_launch("quickscorer", fused, False)
        assert not common.tiled_launch("quickscorer", fused, True)
    assert not common.tiled_launch("predicated", False, False)


@pytest.mark.parametrize("B", [1, 31, 32, 33, 77, 1000])
def test_feature_major_operand_is_x_transposed(B, monkeypatch):
    """The wide-tiled kernels' x: [F, ldx], ldx = B rounded up to 32, x
    transposed and zeros past row B; chunked, each chunk's operand is its
    rows' transpose and the chunks cover the rows in order."""
    F = 13
    x = torch.from_numpy(np.random.default_rng(B).normal(
        size=(B, F)).astype(np.float32))
    x[::5] = float("nan")
    x[0, 0], x[-1, -1] = float("inf"), -float("inf")
    before = common.feature_major.launches
    xt = common.feature_major(x)
    assert common.feature_major.launches == before      # the plain version
    assert xt.shape == (F, common.wide_ldx(B)) and xt.shape[1] % 32 == 0
    assert xt.shape[1] - B < 32
    assert torch.equal(xt[:, :B], x.t()) or torch.equal(
        xt[:, :B].nan_to_num(7.0), x.t().nan_to_num(7.0))
    assert not xt[:, B:].any()
    monkeypatch.setattr(common, "XT_CHUNK_BYTES", 4 * F * 64)
    chunks = common.xt_chunks(B, F)
    assert [r0 for r0, _ in chunks] == list(range(0, B, 64))
    assert sum(n for _, n in chunks) == B
    assert all(n == 64 for _, n in chunks[:-1])
    got = torch.cat([common.feature_major(x[r0:r0 + n])[:, :n]
                     for r0, n in chunks], dim=1)
    assert torch.equal(got.nan_to_num(7.0), x.t().nan_to_num(7.0))
    # at least one block's rows a chunk, however wide the rows
    monkeypatch.setattr(common, "XT_CHUNK_BYTES", 1)
    assert common.xt_chunks(B, F)[0] == (0, min(B, 32))


def _wide_tiled_scores(kind, args, depth, block_b, block_t, *, fused=True):
    """numpy: what the wide-tiled kernels compute, in their order.
    Blocks of 32 rows read feature-major x (zeros past B); warp w of
    block_b / 32 scores trees w, w + W, ... of each tile into the out
    tile, each column once; fused, the tile's columns are then added into
    each row's f32 sum tree by tree; raw, they are the rows' [B, T]
    scores.  HummingBird's score is the P == D leaf + 0.0;
    QuickScorer's the leaf of the lowest surviving bit: the top nodes'
    dead words, then word by word the in-word ANDs."""
    x, nodes, leaves = args[:3]
    B = x.shape[0]
    xt = common.feature_major(x).numpy()
    fe, th, dl = (a.numpy() for a in unpack_nodes(nodes))
    leaves = leaves.float().numpy()
    T, L = fe.shape[0], 1 << depth
    nw = block_b // 32
    if kind == "hummingbird":
        ct, dcount = (a.numpy() for a in args[3:5])
        C = ct[:L, :L - 1].T.astype(np.int32)
        D = dcount[:L]
    dw, K, W = qs_word_split(depth)
    ones = np.uint32(0xFFFFFFFF)

    tt = np.arange(T)[:, None]               # [T, 1]: every tree at once

    def go_left(v, i):                      # v, i [T, 32] or [T, 1]
        return np.where(np.isnan(v), dl[tt, i], v < th[tt, i])

    def quickscorer_leaf(xb):
        def right(slot):
            return ~go_left(xb[fe[:, slot - 1]], slot - 1)

        dead = np.zeros((T, 32), np.uint32)
        for i in range(1, W):
            d = i.bit_length() - 1
            dead |= np.where(right(i), np.uint32(dead_words(K, d,
                                                           i - (1 << d))),
                             np.uint32(0))
        leaf = np.full((T, 32), -1)
        for w in range(W):
            cur = np.full((T, 32), ones)
            for i in range(1, 1 << dw):
                k = i.bit_length() - 1
                cur &= np.where(right(((W + w) << k) + i - (1 << k)),
                                np.uint32(in_word_mask(dw, k, i - (1 << k))),
                                ones)
            surv = np.where((dead >> np.uint32(w)) & 1, np.uint32(0), cur)
            low = surv & (~surv + np.uint32(1))
            bit = np.log2(np.maximum(low, 1).astype(np.float64)).astype(int)
            leaf = np.where((leaf < 0) & (surv != 0), w * 32 + bit, leaf)
        assert ((leaf >= 0) & (leaf < L)).all()
        return leaf

    def scores(xb):                  # xb [F, 32] -> every tree's [32, T]
        if kind == "predicated":
            idx = np.ones((T, 32), np.int64)
            for _ in range(depth):
                i = idx - 1
                v = xb[fe[tt, i], np.arange(32)]
                idx = 2 * idx + (~go_left(v, i)).astype(np.int64)
            return leaves[tt, idx - L].T
        if kind == "quickscorer":
            return leaves[tt, quickscorer_leaf(xb)].T
        s = np.stack([go_left(xb[fe[:, i]], np.full((T, 1), i))
                      for i in range(L - 1)], axis=2).astype(np.int32)
        hit = (s @ C) == D                          # [T, 32, L], one True
        assert (hit.sum(2) == 1).all()
        return (leaves[tt, hit.argmax(2)] + np.float32(0.0)).T

    out = np.empty((B,) if fused else (B, T), np.float32)
    for b0 in range(0, B, 32):
        block = scores(xt[:, b0:b0 + 32])
        acc = np.zeros(32, np.float32)
        for t0 in range(0, T, block_t):
            tile = np.full((32, block_t + 1), np.nan, np.float32)
            written = np.zeros(block_t, int)
            for w in range(nw):
                for t in range(w, block_t, nw):
                    tile[:, t] = block[:, t0 + t]
                    written[t] += 1
            assert (written == 1).all()
            if fused:
                for c in range(block_t):
                    acc = acc + tile[:, c]
            else:
                out[b0:b0 + 32, t0:t0 + block_t] = tile[:B - b0, :block_t]
        if fused:
            out[b0:b0 + 32] = acc[:B - b0]
    return out


@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("kind", BASES)
def test_wide_tiled_order_matches_plain(kind, depth):
    """The wide-tiled kernels' order -- warps over trees into the out
    tile, then the in-order add -- gives the plain fused versions' sums
    bit for bit (and raw HummingBird's and QuickScorer's out tiles their
    raw scores): ragged rows (B = 77), NaN and +-inf rows, -0.0 leaves,
    f32 and bf16 tree tiles, at the tiles the card takes and at 3 warps
    over 1-, 3- and 5-tree tiles."""
    F, B, T = 40, 77, 21
    fe, th, dl, lv = random_forest_arrays(None, T=T, depth=depth, F=F,
                                          seed=depth)
    lv[:, ::3] = -0.0
    from repro_torch.core.forest import make_forest
    forest = make_forest(fe, th, lv, default_left=dl, n_features=F,
                         device="cpu")
    r = np.random.default_rng(depth + 100)
    x = r.normal(size=(B, F)).astype(np.float32)
    x[r.random(x.shape) < 0.1] = np.nan
    x[::9] = np.nan
    x[4] = np.inf
    x[5] = -np.inf
    plain = {"predicated": (predicated_fused_plain, None),
             "hummingbird": (hummingbird_fused_plain,
                             hummingbird_raw_plain),
             "quickscorer": (quickscorer_fused_plain,
                             quickscorer_raw_plain)}[kind]
    runs = [(True, None), (True, torch.bfloat16)]
    if common.wide_tiled(kind, False):
        runs.append((False, None))
    for fused, tree_dtype in runs:
        for block_b, block_t in ((None, None), (96, 1), (96, 3), (96, 5)):
            args, tiles = prepare_inputs(kind, forest, torch.from_numpy(x),
                                         block_b=block_b, block_t=block_t,
                                         fused=fused, staged=False,
                                         tree_dtype=tree_dtype)
            want = plain[not fused](*args, depth=depth).numpy()
            got = _wide_tiled_scores(kind, args, depth, tiles["block_b"],
                                     tiles["block_t"], fused=fused)
            assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_every_library_holds_the_transpose():
    """The transpose the launch wrapper runs before a wide-tiled kernel is
    in the shared header, so every kernel library exports it, with the
    signature ``_build`` binds: (x, xt, rows, F, stream)."""
    from repro_torch.kernels import _build

    header = (_build.CSRC / "forest_common.cuh").read_text()
    assert ('extern "C" int forest_transpose_rows(const float* x, float* xt,'
            in header)
    for src, _ in _build.KERNEL_SOURCES.values():
        assert '#include "forest_common.cuh"' in (_build.CSRC / src
                                                  ).read_text()
    assert "lib.forest_transpose_rows.argtypes = [_P, _P, _LL, _I, _P]" in (
        Path(_build.__file__).read_text())


def _probe_edits():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_wide_probe as probe

    jobs = [("row_major", name, probe.ROW_MAJOR_EDITS)
            for name in probe.LIBRARIES]
    jobs += [(v, name, edits) for v, per in probe.VARIANT_EDITS.items()
             for name, edits in per.items()]
    return jobs


@pytest.mark.parametrize("tag,name,edits", _probe_edits(),
                         ids=[f"{t}-{n}" for t, n, _ in _probe_edits()])
def test_probe_edits_apply_once_to_the_wide_tiled_kernels(tag, name,
                                                          edits):
    """chip_wide_probe.py builds each library with its edits applied (the
    row-major x read, the 64-bit offset product, QuickScorer's two-tree
    walk); each old text is in the source exactly once, as the probe
    requires, and every wide-tiled kernel reads x through ``col_at`` at a
    32-bit ldx."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / _build.KERNEL_SOURCES[name][0]).read_text()
    for old, _ in edits:
        assert src.count(old) == 1, old[:60]
    assert src.count("const unsigned ldx = unsigned(wide_ldx(B));") == 1
    assert "col_at32" not in src
