"""The CUDA kernels and the query on the card (marked ``gpu``).

This file imports neither jax nor the JAX package, so it also runs on a
machine with only PyTorch and a card:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether a card is present and skips
without one.  Inputs are made with numpy from a seed; each CUDA kernel is
held against its plain PyTorch version on the same inputs.  Fused sums:
bit-identical on integer leaves, within 1e-6 otherwise (the plain versions
add the trees in the kernels' order, so in practice the float sums agree
bit for bit too).  Raw [B, T] scores: bit-identical on any leaves.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.core.forest import make_forest
from repro_torch.core.reuse import ModelReuseCache
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.store import TensorBlockStore
from repro_torch.kernels.forest_hummingbird import (hummingbird_fused_plain,
                                                    hummingbird_raw_plain)
from repro_torch.kernels.forest_predicated import (predicated_fused_plain,
                                                   predicated_raw_plain)
from repro_torch.kernels.forest_quickscorer import (quickscorer_fused_plain,
                                                    quickscorer_raw_plain)
from repro_torch.kernels.ops import (KERNEL_WRAPPERS, RAW_KERNEL_WRAPPERS,
                                     prepare_inputs)

from conftest import random_forest_arrays

BASES = ("predicated", "hummingbird", "quickscorer")
PLAIN = dict(predicated=predicated_fused_plain,
             hummingbird=hummingbird_fused_plain,
             quickscorer=quickscorer_fused_plain)
RAW_PLAIN = dict(predicated=predicated_raw_plain,
                 hummingbird=hummingbird_raw_plain,
                 quickscorer=quickscorer_raw_plain)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _case(*, T, depth, F, B, seed, integer_leaves, device):
    fe, th, dl, lv = random_forest_arrays(None, T=T, depth=depth, F=F,
                                          seed=seed)
    r = np.random.default_rng(seed + 1)
    if integer_leaves:
        lv = r.integers(-8, 9, lv.shape).astype(np.float32)
    forest = make_forest(fe, th, lv, default_left=dl, n_features=F,
                         device=device)
    x = r.normal(size=(B, F)).astype(np.float32)
    x[r.random(x.shape) < 0.1] = np.nan
    x[::7] = np.nan                                # whole NaN rows
    x[3, 0], x[5, 1] = np.inf, -np.inf
    return forest, x


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Compare floats bit for bit (-0.0 != +0.0, NaN == same NaN)."""
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("integer_leaves", [True, False],
                         ids=["integer", "float"])
@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("base", BASES)
def test_cuda_kernel_matches_plain(base, depth, integer_leaves):
    _need_card()
    forest, x = _case(T=37, depth=depth, F=28, B=300, seed=depth,
                      integer_leaves=integer_leaves, device="cuda")
    kernel = KERNEL_WRAPPERS[base]
    args, tiles = prepare_inputs(base, forest, torch.from_numpy(x).cuda())
    before = kernel.launches
    got = kernel(*args, **tiles)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = PLAIN[base](*args, depth=depth)
    if integer_leaves:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("integer_leaves", [True, False],
                         ids=["integer", "float"])
@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("base", BASES)
def test_cuda_raw_kernel_matches_plain(base, depth, integer_leaves):
    _need_card()
    forest, x = _case(T=37, depth=depth, F=28, B=300, seed=depth + 10,
                      integer_leaves=integer_leaves, device="cuda")
    kernel = RAW_KERNEL_WRAPPERS[base]
    args, tiles = prepare_inputs(base, forest, torch.from_numpy(x).cuda(),
                                 fused=False)
    before = kernel.launches
    got = kernel(*args, **tiles)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (args[0].shape[0], args[1].shape[0])
    assert torch.equal(_bits(got), _bits(RAW_PLAIN[base](*args, depth=depth)))


@pytest.mark.gpu
@pytest.mark.parametrize("T,depth", [(1, 8), (3, 4), (6, 8), (37, 2)])
@pytest.mark.parametrize("base", BASES)
def test_cuda_kernels_few_trees_ragged_rows_negative_zero(base, T, depth):
    """Tree counts below and off the predicated kernel's four chains, a
    ragged last sample block (B = 77), and -0.0 leaves: raw scores bit for
    bit, fused sums bit for bit (both add in tree order)."""
    _need_card()
    forest, x = _case(T=T, depth=depth, F=13, B=77, seed=T + depth,
                      integer_leaves=True, device="cuda")
    lv = forest.leaf_value.clone()
    lv[:, ::3] = -0.0
    forest = dataclasses.replace(forest, leaf_value=lv)
    xc = torch.from_numpy(x).cuda()
    for fused, wrappers, plain in ((True, KERNEL_WRAPPERS, PLAIN),
                                   (False, RAW_KERNEL_WRAPPERS, RAW_PLAIN)):
        args, tiles = prepare_inputs(base, forest, xc, fused=fused)
        got = wrappers[base](*args, **tiles)
        torch.cuda.synchronize()
        want = plain[base](*args, depth=depth)
        assert got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want)), (base, fused)
    if base == "predicated":        # a leaf lookup keeps the sign of zero
        assert (_bits(got) == _bits(torch.tensor(-0.0))).any()


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 3, 5, 6])
def test_cuda_quickscorer_shallow_depths_negative_zero(depth):
    """QuickScorer fused and raw below depth 8, as chip_smoke.py phase 3:
    one word with phantom bits (depths 1-5) and the first depth whose top
    node clears a whole word (6); -0.0 leaves, bit for bit."""
    _need_card()
    forest, x = _case(T=37, depth=depth, F=28, B=1000, seed=20 + depth,
                      integer_leaves=True, device="cuda")
    lv = forest.leaf_value.clone()
    lv[:, ::3] = -0.0
    forest = dataclasses.replace(forest, leaf_value=lv)
    xc = torch.from_numpy(x).cuda()
    for fused, wrappers, plain in ((True, KERNEL_WRAPPERS, PLAIN),
                                   (False, RAW_KERNEL_WRAPPERS, RAW_PLAIN)):
        args, tiles = prepare_inputs("quickscorer", forest, xc, fused=fused)
        got = wrappers["quickscorer"](*args, **tiles)
        torch.cuda.synchronize()
        want = plain["quickscorer"](*args, depth=depth)
        assert torch.equal(_bits(got), _bits(want)), (depth, fused)
    assert (_bits(got) == _bits(torch.tensor(-0.0))).any()


@pytest.mark.gpu
def test_cuda_quickscorer_wide_rows_take_partial_warp_blocks():
    """968 features (Bosch's width) leave room for 32 samples a block in
    the staged x mode: 8 QuickScorer threads of 4 rows; scores bit for
    bit."""
    _need_card()
    forest, x = _case(T=9, depth=8, F=968, B=101, seed=7,
                      integer_leaves=True, device="cuda")
    xc = torch.from_numpy(x).cuda()
    for fused, wrappers, plain in ((True, KERNEL_WRAPPERS, PLAIN),
                                   (False, RAW_KERNEL_WRAPPERS, RAW_PLAIN)):
        args, tiles = prepare_inputs("quickscorer", forest, xc, fused=fused,
                                     staged=True)
        assert tiles["block_b"] == 8
        got = wrappers["quickscorer"](*args, **tiles)
        torch.cuda.synchronize()
        want = plain["quickscorer"](*args, depth=8)
        assert torch.equal(_bits(got), _bits(want)), fused


@pytest.mark.gpu
def test_cuda_quickscorer_rejects_other_bit_vectors():
    """The kernel derives the heap's masks and reads no bv: a bv other than
    qs_words(depth) raises on the card path, before any launch."""
    _need_card()
    forest, x = _case(T=4, depth=6, F=6, B=40, seed=2,
                      integer_leaves=True, device="cuda")
    for fused, wrappers in ((True, KERNEL_WRAPPERS),
                            (False, RAW_KERNEL_WRAPPERS)):
        args, tiles = prepare_inputs("quickscorer", forest,
                                     torch.from_numpy(x).cuda(), fused=fused)
        wrong = args[3].clone()
        wrong[2, 0] ^= 1
        kernel = wrappers["quickscorer"]
        before = kernel.launches
        with pytest.raises(ValueError, match="not those of a depth-6 heap"):
            kernel(*args[:3], wrong, **tiles)
        with pytest.raises(ValueError, match="CUDA tensor"):
            kernel(*args[:3], args[3].cpu(), **tiles)
        assert kernel.launches == before
        kernel(*args, **tiles)
        assert kernel.launches == before + 1


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    forest, x = _case(T=4, depth=3, F=6, B=40, seed=1,
                      integer_leaves=False, device="cuda")
    args, tiles = prepare_inputs("predicated", forest,
                                 torch.from_numpy(x).cuda())
    kernel = KERNEL_WRAPPERS["predicated"]
    with pytest.raises(ValueError, match="block_b"):
        kernel(*args, **dict(tiles, block_b=48))
    with pytest.raises(TypeError, match="float32"):
        kernel(args[0].double(), *args[1:], **tiles)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel(args[0], args[1].cpu(), *args[2:], **tiles)


@pytest.mark.gpu
@pytest.mark.parametrize("base", BASES)
def test_udf_infer_on_the_card_matches_cpu(base):
    _need_card()
    algorithm = base + "_pallas_fused"
    results = {}
    for device in ("cpu", "cuda"):
        forest, x = _case(T=10, depth=5, F=9, B=150, seed=3,
                          integer_leaves=True, device=device)
        # integer sums are exact; regression keeps phase 2 exact too (a
        # sigmoid may round differently on the card and on the CPU)
        forest = dataclasses.replace(forest, task="regression")
        store = TensorBlockStore(device=device, default_page_rows=32)
        store.put("t", x)
        before = KERNEL_WRAPPERS[base].launches
        res = ForestQueryEngine(store).infer("t", forest,
                                             algorithm=algorithm,
                                             batch_pages=2)
        launched = KERNEL_WRAPPERS[base].launches - before
        assert launched == (res.scan.batches if device == "cuda" else 0)
        results[device] = res.predictions
    assert results["cuda"].is_cuda
    assert torch.equal(results["cuda"].cpu(), results["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("plan,algorithm", [
    ("rel", "predicated_pallas"), ("rel+reuse", "hummingbird_pallas"),
    ("rel+reuse", "quickscorer_pallas"),
    ("rel+reuse", "predicated_pallas_fused")])
def test_rel_infer_on_the_card_matches_cpu(plan, algorithm):
    """Raw (or fused) launches = n_parts x scan batches, and the card's
    predictions equal the CPU's bit for bit on integer leaves."""
    _need_card()
    base = algorithm.split("_")[0]
    wrappers = KERNEL_WRAPPERS if algorithm.endswith("_fused") \
        else RAW_KERNEL_WRAPPERS
    results = {}
    for device in ("cpu", "cuda"):
        forest, x = _case(T=37, depth=6, F=9, B=150, seed=5,
                          integer_leaves=True, device=device)
        forest = dataclasses.replace(forest, task="regression")
        store = TensorBlockStore(device=device, default_page_rows=32)
        store.put("t", x)
        engine = ForestQueryEngine(store)
        before = wrappers[base].launches
        runs = [engine.infer("t", forest, algorithm=algorithm, plan=plan,
                             n_parts=3, batch_pages=2) for _ in range(2)]
        launched = wrappers[base].launches - before
        batches = sum(r.scan.batches for r in runs)
        assert launched == (3 * batches if device == "cuda" else 0)
        assert runs[1].reuse_hit == (plan == "rel+reuse")
        results[device] = runs[-1].predictions
    assert results["cuda"].is_cuda
    assert torch.equal(results["cuda"].cpu(), results["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("plan,algorithm", [
    ("udf", "predicated_pallas_fused"), ("rel+reuse", "predicated_pallas")])
def test_infer_rows_on_the_card_matches_cpu(plan, algorithm):
    _need_card()
    results = {}
    for device in ("cpu", "cuda"):
        forest, x = _case(T=37, depth=8, F=28, B=32, seed=6,
                          integer_leaves=True, device=device)
        forest = dataclasses.replace(forest, task="regression")
        mask = np.arange(32) < 27
        engine = ForestQueryEngine(TensorBlockStore(device=device),
                                   reuse_cache=ModelReuseCache(),
                                   plan_cache=ModelReuseCache())
        first = engine.infer_rows(forest, x, row_mask=mask,
                                  algorithm=algorithm, plan=plan)
        again = engine.infer_rows(forest, x, row_mask=mask,
                                  algorithm=algorithm, plan=plan)
        assert not first.plan_reuse_hit and again.plan_reuse_hit
        assert torch.isnan(again.predictions[~torch.from_numpy(mask)
                                             .to(device)]).all()
        results[device] = again.predictions
    assert torch.equal(results["cuda"].cpu().nan_to_num(),
                       results["cpu"].nan_to_num())


@pytest.mark.gpu
def test_host_tier_is_pinned_on_the_card():
    _need_card()
    _, x = _case(T=3, depth=3, F=9, B=150, seed=7, integer_leaves=True,
                 device="cpu")
    store = TensorBlockStore(device="cuda", default_page_rows=32)
    assert store.put("h", x, tier="host").data.is_pinned()
    assert store.put("d", x).tier == "device"
    assert store.move("d", "host").data.is_pinned()
    assert store.move("d", "disk").tier == "disk"
    assert store.move("d", "host").data.is_pinned()
    assert store.move("d", "device").data.is_cuda
    w = store.stream_writer("w", num_rows=150, num_features=9, tier="host")
    w.write(x)
    assert w.close().data.is_pinned()
    auto = TensorBlockStore(device="cuda", default_page_rows=32,
                            device_budget_bytes=1)
    assert auto.put("a", torch.from_numpy(x).cuda()).data.is_pinned()
    for name in ("h", "d", "w"):
        assert torch.equal(store.get(name).data.cpu().nan_to_num(),
                           store.get("h").data.nan_to_num())


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [2, 1])
@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("plan,algorithm", [
    ("udf", "predicated_pallas_fused"), ("rel+reuse", "predicated_pallas"),
    ("udf", "quickscorer_pallas_fused"), ("rel", "hummingbird_pallas")])
def test_off_device_scan_in_many_batches_matches_the_device_tier(
        plan, algorithm, tier, depth):
    """64 one-page batches: every page buffer is refilled 32 times while
    the other is computed on, and every drain overlaps a later batch."""
    _need_card()
    base = algorithm.split("_")[0]
    wrappers = KERNEL_WRAPPERS if algorithm.endswith("_fused") \
        else RAW_KERNEL_WRAPPERS
    forest, x = _case(T=37, depth=6, F=28, B=64 * 32 - 5, seed=8,
                      integer_leaves=False, device="cuda")
    store = TensorBlockStore(device="cuda", default_page_rows=32)
    store.put("dev", x)
    store.put("off", x, tier=tier)
    engine = ForestQueryEngine(store)
    kw = dict(algorithm=algorithm, plan=plan, batch_pages=1, n_parts=3)
    ref = engine.infer("dev", forest, **kw)
    before = wrappers[base].launches
    res = engine.infer("off", forest, prefetch_depth=depth, **kw)
    s = res.scan
    assert wrappers[base].launches - before == res.n_parts * s.batches
    assert s.batches == 64 and s.max_in_flight == depth
    assert s.pinned_staging and s.drain_async == (depth == 2)
    assert s.bytes_streamed == store.get("off").nbytes
    assert res.predictions.device.type == "cpu"
    assert torch.equal(_bits(res.predictions), _bits(ref.predictions.cpu()))


@pytest.mark.gpu
def test_drain_lands_in_a_pinned_buffer():
    _need_card()
    forest, x = _case(T=10, depth=5, F=9, B=1000, seed=9,
                      integer_leaves=False, device="cuda")
    store = TensorBlockStore(device="cuda", default_page_rows=32,
                             device_budget_bytes=1)
    assert store.put("t", x).tier == "host"
    engine = ForestQueryEngine(store)
    res = engine.infer("t", forest, algorithm="predicated_pallas_fused",
                       batch_pages=4, write_as="t:pred")
    assert res.predictions.is_pinned() and res.predictions.shape == (1000,)
    assert res.scan.drain_async and res.scan.drain_s > 0
    assert res.scan.drain_overlap_s >= 0 and res.scan.transfer_wait_s > 0
    out = store.get("t:pred")
    assert out.tier == "host" and out.data.is_pinned()
    assert torch.equal(out.data[:, 0], res.predictions)


@pytest.mark.gpu
def test_write_as_on_the_device_tier_stays_on_the_card():
    """The store's device is "cuda" and a result's "cuda:0": a device-tier
    query's written result is registered on the device tier, on the card."""
    _need_card()
    forest, x = _case(T=10, depth=5, F=9, B=1000, seed=10,
                      integer_leaves=False, device="cuda")
    store = TensorBlockStore(device="cuda", default_page_rows=32)
    assert store.put("t", x).tier == "device"
    res = ForestQueryEngine(store).infer(
        "t", forest, algorithm="predicated_pallas_fused", batch_pages=4,
        write_as="t:pred")
    out = store.get("t:pred")
    assert res.predictions.is_cuda and res.scan.bytes_streamed == 0
    assert out.tier == "device" and out.data.is_cuda
    assert store.device_nbytes == store.get("t").nbytes + out.nbytes
    assert store.host_nbytes == 0
    assert torch.equal(out.data[:, 0], res.predictions)


# -- wide rows and the sparse plane -------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "raw"])
@pytest.mark.parametrize("F", [1185, 2000, 4096])
@pytest.mark.parametrize("base", BASES)
def test_cuda_kernels_wide_rows_both_x_modes(base, F, fused):
    """Wide rows, depth 8: the wide-row x mode at every width and the
    staged mode where a 32-sample tile fits, each bit for bit against the
    plain version (ragged rows, NaN rows, +-inf)."""
    _need_card()
    forest, x = _case(T=24, depth=8, F=F, B=1000, seed=F + len(base),
                      integer_leaves=True, device="cuda")
    xc = torch.from_numpy(x).cuda()
    wrappers = KERNEL_WRAPPERS if fused else RAW_KERNEL_WRAPPERS
    plain = PLAIN if fused else RAW_PLAIN
    modes = [False]
    try:
        prepare_inputs(base, forest, xc, fused=fused, staged=True)
        modes.append(True)
    except ValueError:
        assert F > 1184                        # a staged tile that fits
    for staged in modes:
        args, tiles = prepare_inputs(base, forest, xc, fused=fused,
                                     staged=staged)
        before = (wrappers[base].launches, wrappers[base].wide_launches)
        got = wrappers[base](*args, **tiles)
        torch.cuda.synchronize()
        assert (wrappers[base].launches - before[0],
                wrappers[base].wide_launches - before[1]) \
            == (1, int(not staged))
        want = plain[base](*args, depth=8)
        assert torch.equal(_bits(got), _bits(want)), staged


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 3, 5, 8])
@pytest.mark.parametrize("F", [968, 1185, 2000, 4096, 10_000])
def test_cuda_wide_tiled_kernels_match_plain(F, depth):
    """The wide-tiled mode (32-row blocks, warps over trees, feature-major
    x) of fused predicated, fused HummingBird and raw HummingBird, bit for
    bit against the plain versions (ragged rows, NaN rows, +-inf, -0.0
    leaves), f32 tiles and, at 968 and 2,000 features, bf16 ones; each
    call one launch, in the wide-row mode, after one transpose."""
    _need_card()
    from repro_torch.kernels.common import feature_major

    forest, x = _case(T=24, depth=depth, F=F, B=1000, seed=F + depth,
                      integer_leaves=False, device="cuda")
    lv = forest.leaf_value.clone()
    lv[:, ::3] = -0.0
    forest = dataclasses.replace(forest, leaf_value=lv)
    xc = torch.from_numpy(x).cuda()
    runs = [("predicated", True, None), ("hummingbird", True, None),
            ("hummingbird", False, None)]
    if F in (968, 2000):
        runs += [("predicated", True, torch.bfloat16),
                 ("hummingbird", True, torch.bfloat16)]
    for base, fused, tree_dtype in runs:
        wrapper = (KERNEL_WRAPPERS if fused else RAW_KERNEL_WRAPPERS)[base]
        plain = (PLAIN if fused else RAW_PLAIN)[base]
        args, tiles = prepare_inputs(base, forest, xc, fused=fused,
                                     staged=False, tree_dtype=tree_dtype)
        before = (wrapper.launches, wrapper.wide_launches,
                  feature_major.launches)
        got = wrapper(*args, **tiles)
        torch.cuda.synchronize()
        assert (wrapper.launches - before[0],
                wrapper.wide_launches - before[1],
                feature_major.launches - before[2]) == (1, 1, 1)
        want = plain(*args, depth=depth)
        assert torch.equal(_bits(got), _bits(want)), (base, fused,
                                                      tree_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("base,fused", [("predicated", True),
                                        ("hummingbird", True),
                                        ("hummingbird", False)])
def test_cuda_wide_tiled_rows_in_chunks(base, fused, monkeypatch):
    """Past ``XT_CHUNK_BYTES`` of x a wide-tiled launch transposes and
    scores its rows chunk by chunk (here 4 chunks, the last ragged): the
    same bits as the plain version, and four counted launches of the
    kernel, each in the wide-row mode, and four of the transpose."""
    _need_card()
    from repro_torch.kernels import common

    forest, x = _case(T=16, depth=6, F=3000, B=1000, seed=81,
                      integer_leaves=False, device="cuda")
    xc = torch.from_numpy(x).cuda()
    monkeypatch.setattr(common, "XT_CHUNK_BYTES", 4 * 3000 * 288)
    assert [n for _, n in common.xt_chunks(1000, 3000)] == [288] * 3 + [136]
    wrapper = (KERNEL_WRAPPERS if fused else RAW_KERNEL_WRAPPERS)[base]
    args, tiles = prepare_inputs(base, forest, xc, fused=fused)
    assert tiles["staged"] is False
    before = (wrapper.launches, wrapper.wide_launches,
              common.feature_major.launches)
    got = wrapper(*args, **tiles)
    torch.cuda.synchronize()
    assert (wrapper.launches - before[0], wrapper.wide_launches - before[1],
            common.feature_major.launches - before[2]) == (4, 4, 4)
    want = (PLAIN if fused else RAW_PLAIN)[base](*args, depth=6)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("B,F", [(7, 2), (33, 13), (1000, 2000),
                                 (4097, 968)])
def test_cuda_feature_major_matches_plain(B, F):
    """The transpose kernel: [F, B rounded up to 32], x transposed, zeros
    past row B, bit for bit (NaN rows, +-inf) its plain version; one
    counted launch."""
    _need_card()
    from repro_torch.kernels.common import (feature_major,
                                            feature_major_plain)

    _, x = _case(T=1, depth=1, F=F, B=B, seed=B, integer_leaves=True,
                 device="cpu")
    xc = torch.from_numpy(x).cuda()
    before = feature_major.launches
    got = feature_major(xc)
    torch.cuda.synchronize()
    assert feature_major.launches == before + 1
    assert torch.equal(_bits(got), _bits(feature_major_plain(xc)))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [2, 1])
@pytest.mark.parametrize("tier", ["device", "host", "disk"])
@pytest.mark.parametrize("plan,algorithm", [
    ("udf", "predicated_pallas_fused"), ("rel+reuse", "predicated_pallas"),
    ("udf", "hummingbird_pallas_fused"), ("rel", "quickscorer_pallas")])
def test_csr_scan_in_many_batches_matches_the_device_tier(
        plan, algorithm, tier, depth):
    """A CSR table in 64 one-page batches: its three page arrays stream
    through at most two buffers each, and every prediction equals the
    dense device tier's bit for bit."""
    _need_card()
    forest, x = _case(T=37, depth=6, F=300, B=64 * 32 - 5, seed=11,
                      integer_leaves=False, device="cuda")
    x[np.random.default_rng(3).random(x.shape) < 0.8] = np.nan
    store = TensorBlockStore(device="cuda", default_page_rows=32)
    store.put("dense", x)
    csr = store.put_sparse("csr", x, tier=tier)
    engine = ForestQueryEngine(store)
    kw = dict(algorithm=algorithm, plan=plan, batch_pages=1, n_parts=3)
    ref = engine.infer("dense", forest, **kw)
    res = engine.infer("csr", forest, prefetch_depth=depth, **kw)
    s = res.scan
    assert res.storage_format == "csr" and res.tier == tier
    assert s.batches == 64
    if tier == "device":
        assert s.bytes_streamed == 0 and res.predictions.is_cuda
    else:
        assert s.max_in_flight == depth and s.pinned_staging
        assert s.bytes_streamed == csr.nbytes
    assert torch.equal(_bits(res.predictions.cpu()),
                       _bits(ref.predictions.cpu()))


@pytest.mark.gpu
def test_csr_staging_buffers_hold_three_arrays_two_in_flight():
    """The scan's page buffers for a CSR table are three device arrays
    each (and, on the disk tier, three pinned staging arrays), never more
    than two buffers live."""
    _need_card()
    from repro_torch.db import executor as ex

    forest, x = _case(T=9, depth=4, F=64, B=40 * 32, seed=12,
                      integer_leaves=True, device="cuda")
    store = TensorBlockStore(device="cuda", default_page_rows=32)
    ds = store.put_sparse("csr", x, tier="disk")
    made = []
    real = ex._Scan.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        made.append(self)

    ex._Scan.__init__ = spy
    try:
        res = ForestQueryEngine(store).infer(
            "csr", forest, algorithm="predicated_pallas_fused",
            batch_pages=3)
    finally:
        ex._Scan.__init__ = real
    scan = made[0]
    assert len(scan.bufs) == len(scan.staging) == 2
    for buf, stage in zip(scan.bufs, scan.staging):
        assert all(t.is_cuda for t in buf.tensors())
        assert all(t.is_pinned() for t in stage.tensors())
        assert [tuple(t.shape) for t in buf.tensors()] == [
            (3, 33), (3, ds.pages.capacity), (3, ds.pages.capacity)]
    assert res.scan.max_in_flight == 2
    assert res.scan.bytes_streamed == ds.nbytes


# -- bf16 tree tiles (the fused kernels' narrow node record) ----------------


@pytest.mark.gpu
@pytest.mark.parametrize("staged", [True, False], ids=["staged", "wide"])
@pytest.mark.parametrize("depth", [1, 3, 5, 6, 8])
@pytest.mark.parametrize("base", BASES)
def test_cuda_bf16_kernel_matches_plain_both_x_modes(base, depth, staged):
    """The fused kernels over narrow records and bf16 leaves, in both x
    modes: bit for bit against the plain version on the same records, and
    bit for bit against the f32 kernel over the bf16-rounded forest (-0.0
    leaves, a ragged block, NaN rows, +-inf)."""
    _need_card()
    forest, x = _case(T=37, depth=depth, F=28, B=300, seed=depth + 40,
                      integer_leaves=False, device="cuda")
    forest = dataclasses.replace(
        forest, leaf_value=torch.where(forest.leaf_value > 0.5,
                                       torch.tensor(-0.0, device="cuda"),
                                       forest.leaf_value))
    xc = torch.from_numpy(x).cuda()
    kernel = KERNEL_WRAPPERS[base]
    args, tiles = prepare_inputs(base, forest, xc, staged=staged,
                                 tree_dtype=torch.bfloat16)
    assert args[1].dim() == 2 and args[2].dtype == torch.bfloat16
    before = (kernel.launches, kernel.wide_launches, kernel.bf16_launches)
    got = kernel(*args, **tiles)
    torch.cuda.synchronize()
    assert (kernel.launches - before[0], kernel.wide_launches - before[1],
            kernel.bf16_launches - before[2]) == (1, int(not staged), 1)
    assert torch.equal(_bits(got), _bits(PLAIN[base](*args, depth=depth)))
    q = forest.astype(torch.bfloat16).astype(torch.float32)
    fargs, ftiles = prepare_inputs(base, q, xc, staged=staged)
    want = kernel(*fargs, **ftiles)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("base", BASES)
def test_cuda_bf16_past_the_narrow_record_keeps_the_wide_one(base):
    """A forest past 32,768 features takes the 8-byte record for its bf16
    tiles: the f32 kernel, the same sums as the bf16-rounded forest."""
    _need_card()
    from repro_torch.kernels.ops import predict_sum_pallas

    forest, x = _case(T=12, depth=5, F=33_000, B=96, seed=70,
                      integer_leaves=False, device="cuda")
    xc = torch.from_numpy(x).cuda()
    kernel = KERNEL_WRAPPERS[base]
    before = (kernel.launches, kernel.bf16_launches)
    got = predict_sum_pallas(forest, xc, algorithm=f"{base}_pallas_fused",
                             tree_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (kernel.launches - before[0], kernel.bf16_launches - before[1]) \
        == (1, 0)
    q = forest.astype(torch.bfloat16).astype(torch.float32)
    want = predict_sum_pallas(q, xc, algorithm=f"{base}_pallas_fused")
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("base", ["predicated", "hummingbird"])
def test_cuda_wide_tiled_bf16_past_the_narrow_record(base):
    """bf16 tiles over 40,000 features (past the narrow record): the
    wide-tiled kernel over 8-byte records of the rounded forest, bit for
    bit its plain version, one wide launch and no narrow one."""
    _need_card()
    forest, x = _case(T=20, depth=8, F=40_000, B=500, seed=72,
                      integer_leaves=False, device="cuda")
    xc = torch.from_numpy(x).cuda()
    kernel = KERNEL_WRAPPERS[base]
    args, tiles = prepare_inputs(base, forest, xc,
                                 tree_dtype=torch.bfloat16)
    assert args[1].dim() == 3 and tiles["staged"] is False
    before = (kernel.launches, kernel.wide_launches, kernel.bf16_launches)
    got = kernel(*args, **tiles)
    torch.cuda.synchronize()
    assert (kernel.launches - before[0], kernel.wide_launches - before[1],
            kernel.bf16_launches - before[2]) == (1, 1, 0)
    assert torch.equal(_bits(got), _bits(PLAIN[base](*args, depth=8)))


@pytest.mark.gpu
def test_cuda_raw_kernels_refuse_narrow_records():
    _need_card()
    forest, x = _case(T=8, depth=4, F=11, B=64, seed=71,
                      integer_leaves=True, device="cuda")
    args, tiles = prepare_inputs("predicated", forest,
                                 torch.from_numpy(x).cuda(),
                                 tree_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32 trees only"):
        RAW_KERNEL_WRAPPERS["predicated"](*args, **tiles)


# -- the external loaders on the card ----------------------------------------


@pytest.mark.gpu
def test_device_tier_loads_land_on_the_card(tmp_path):
    """Every loader's device-tier result is CUDA tensors (the default
    device), equal bit for bit to the same load on the CPU device."""
    _need_card()
    from repro_torch.db import loader as ld

    r = np.random.default_rng(80)
    x = r.normal(size=(300, 24)).astype(np.float32)
    y = (r.random(300) < 0.5).astype(np.float32)
    xs = x.copy()
    xs[r.random(x.shape) < 0.7] = np.nan
    csv, svm, arr = (str(tmp_path / f"d.{e}") for e in ("csv", "svm", "arr"))
    ld.write_csv(csv, x)
    ld.write_libsvm(svm, xs, y)
    ld.write_array_rows(arr, x)
    for load in (lambda **k: ld.load_csv_external(csv, **k)[0],
                 lambda **k: ld.load_libsvm_external(svm, 24, **k)[0],
                 lambda **k: ld.load_array_rows_external(arr, **k)[0]):
        got, want = load(), load(device="cpu")
        assert got.is_cuda and got.dtype == torch.float32
        assert torch.equal(_bits(got.cpu()), _bits(want))
    pages, labels, t = ld.load_libsvm_csr_external(svm, 24, page_rows=32)
    assert all(a.is_cuda for a in pages.arrays()) and t.transfer_s > 0
    want, _, _ = ld.load_libsvm_csr_external(svm, 24, page_rows=32,
                                             device="cpu")
    for a, b in zip(pages.arrays(), want.arrays()):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_off_device_libsvm_loads_hand_over_zero_copy(tmp_path, tier):
    """A host-tier load returns pinned tensors and a disk-tier one memmaps,
    both without a transfer; put_sparse(pages=) on the card's store keeps
    them as they are, and udf queries equal the device-tier load's bit
    for bit."""
    _need_card()
    from repro_torch.db import loader as ld

    forest, x = _case(T=9, depth=4, F=24, B=300, seed=81,
                      integer_leaves=True, device="cuda")
    x[np.random.default_rng(82).random(x.shape) < 0.7] = np.nan
    svm = str(tmp_path / "d.svm")
    ld.write_libsvm(svm, x, np.zeros(300, np.float32))
    pages, labels, t = ld.load_libsvm_csr_external(
        svm, 24, page_rows=32, tier=tier, spill_dir=str(tmp_path))
    assert t.transfer_s == 0.0 and pages.tier == tier
    if tier == "host":
        assert all(a.device.type == "cpu" and a.is_pinned()
                   for a in pages.arrays())
    else:
        assert all(isinstance(a, np.memmap) for a in pages.arrays())
    store = TensorBlockStore(device="cuda", default_page_rows=32)
    ds = store.put_sparse("off", pages=pages, num_rows=300, labels=labels,
                          tier=tier)
    assert all(a is b for a, b in zip(ds.pages.arrays(), pages.arrays()))
    assert ds.labels.is_cuda
    dev, _, _ = ld.load_libsvm_csr_external(svm, 24, page_rows=32)
    store.put_sparse("dev", pages=dev, num_rows=300)
    engine = ForestQueryEngine(store)
    for algorithm in ("predicated_pallas_fused", "hummingbird_pallas_fused"):
        got = engine.infer("off", forest, algorithm=algorithm, plan="udf",
                           batch_pages=2)
        want = engine.infer("dev", forest, algorithm=algorithm, plan="udf",
                            batch_pages=2)
        assert got.tier == tier
        assert torch.equal(_bits(got.predictions.cpu()),
                           _bits(want.predictions.cpu()))


# -- tracing on the card ------------------------------------------------------


def _tier_engine(tier: str, seed: int, tmp_path):
    forest, x = _case(T=10, depth=5, F=9, B=1000, seed=seed,
                      integer_leaves=False, device="cuda")
    store = TensorBlockStore(device="cuda", default_page_rows=32,
                             spill_dir=str(tmp_path))
    store.put("t", x, tier=tier)
    return ForestQueryEngine(store), forest


def _traced_infer(engine, forest, **kw):
    from repro_torch.obs import TRACER

    TRACER.reset()
    TRACER.enable()
    try:
        res = engine.infer("t", forest, algorithm="predicated_pallas_fused",
                           batch_pages=4, **kw)
    finally:
        TRACER.disable()
    return res, TRACER.finished()


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [2, 1])
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_drain_write_device_spans_lie_inside_their_scan(tier, depth,
                                                        tmp_path):
    """Each batch's D2H is a device span on the ``cuda:drain`` track under
    its ``scan.batch``, and on the anchored clock it lies inside the scan's
    ``scan.execute`` host interval."""
    _need_card()
    engine, forest = _tier_engine(tier, 11, tmp_path)
    res, spans = _traced_infer(engine, forest, prefetch_depth=depth)
    by_id = {s.span_id: s for s in spans}
    execute = next(s for s in spans if s.name == "scan.execute")
    drains = [s for s in spans if s.name == "scan.drain_write"]
    assert len(drains) == res.scan.batches == 8
    for d in drains:
        assert d.track == "cuda:drain"
        assert by_id[d.parent_id].name == "scan.batch"
        assert execute.start_ns <= d.start_ns <= d.end_ns <= execute.end_ns
    assert sum(d.duration_s for d in drains) == pytest.approx(
        res.scan.drain_s, rel=1e-3, abs=1e-6)
    assert res.trace.span_counts["scan.drain_write"] == 8


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["device", "host"])
@pytest.mark.parametrize("plan", ["udf", "rel+reuse"])
def test_stage_spans_carry_the_stage_reports_device_seconds(plan, tier,
                                                            tmp_path):
    _need_card()
    engine, forest = _tier_engine(tier, 12, tmp_path)
    res, spans = _traced_infer(engine, forest, plan=plan, n_parts=2)
    stages = [s for s in spans if s.name.startswith("stage:")]
    reports = [r for r in res.stage_reports
               if r.name != "stageP:model-partition"]
    assert len(stages) == len(reports) > 0
    assert sorted(s.attrs["device_s"] for s in stages) == sorted(
        r.seconds for r in reports)
    for s in stages:                   # host wall includes the synchronise
        assert s.duration_s > 0 and s.attrs["device_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_a_disabled_tracer_adds_no_cuda_event_to_a_scan(tier, monkeypatch,
                                                        tmp_path):
    """Tracing off, a scan makes exactly its own events (two page-buffer
    events a buffer, a drain pair a batch, a pair a stage run) and waits
    on the same ones; tracing on adds the clock anchor and its wait."""
    _need_card()
    engine, forest = _tier_engine(tier, 13, tmp_path)
    made, waits = [], []

    class _Counted(torch.cuda.Event):
        def __new__(cls, *a, **kw):
            made.append(1)
            return super().__new__(cls, *a, **kw)

        def synchronize(self):
            waits.append(1)
            return super().synchronize()

    monkeypatch.setattr(torch.cuda, "Event", _Counted)
    engine.infer("t", forest, algorithm="predicated_pallas_fused",
                 batch_pages=4)                  # builds the plan
    counts = {}
    for traced in (False, True):
        made.clear()
        waits.clear()
        if traced:
            res, _ = _traced_infer(engine, forest)
        else:
            res = engine.infer("t", forest,
                               algorithm="predicated_pallas_fused",
                               batch_pages=4)
        counts[traced] = (len(made), len(waits))
    B, S = res.scan.batches, len(res.stage_reports) // res.scan.batches
    assert counts[False][0] == 2 * 2 + 2 * B + 2 * S * B
    assert counts[True] == (counts[False][0] + 1, counts[False][1] + 1)


# -- the fault plane on the card ----------------------------------------------


def _fast():
    from repro_torch.db.faults import RetryPolicy

    return RetryPolicy(backoff_base_s=0.0, max_backoff_s=0.0)


def _armed(**arming):
    from repro_torch.db.faults import FaultInjector

    inj = FaultInjector()
    for site, kw in arming.items():
        inj.inject(site, **kw)
    return inj


def _x_stages(seen=None):
    """A plan that sums each row's features (optionally recording the page
    buffer each batch reads)."""
    from repro_torch.db.operators import Operator, split_into_stages

    def udf(state):
        if seen is not None:
            seen.append(state["x"].data_ptr())
        return {**state, "pred": torch.nansum(state["x"], dim=1)}

    return split_into_stages([Operator("udf", udf, breaker=True)])


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_failed_attempts_record_no_copy_or_drain_event(tier, monkeypatch,
                                                       tmp_path):
    """A fired attempt at page_dma_in, kernel_launch or drain_copy_out
    enqueues nothing: the scan records as many CUDA events as a clean one,
    and its drain spans (one a batch) sum to ``drain_s``."""
    _need_card()
    engine, forest = _tier_engine(tier, 14, tmp_path)
    recorded = []

    class _Counted(torch.cuda.Event):
        def record(self, *a, **kw):
            recorded.append(1)
            return super().record(*a, **kw)

    monkeypatch.setattr(torch.cuda, "Event", _Counted)
    kw = dict(algorithm="predicated_pallas_fused", batch_pages=4)
    clean = engine.infer("t", forest, **kw)
    recorded.clear()
    clean = engine.infer("t", forest, **kw)
    n_clean = len(recorded)
    arming = {s: dict(fail_at=2) for s in ("page_dma_in", "kernel_launch",
                                           "drain_copy_out")}
    recorded.clear()
    res = engine.infer("t", forest, injector=_armed(**arming),
                       retry_policy=_fast(), **kw)
    assert len(recorded) == n_clean
    assert res.scan.retries == res.scan.faults_injected == 3
    assert torch.equal(_bits(res.predictions), _bits(clean.predictions))
    res, spans = _traced_infer(engine, forest, injector=_armed(**arming),
                               retry_policy=_fast())
    drains = [s for s in spans if s.name == "scan.drain_write"]
    assert len(drains) == res.scan.batches == 8
    assert sum(d.duration_s for d in drains) == pytest.approx(
        res.scan.drain_s, rel=1e-3, abs=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_halving_reuses_the_preallocated_buffers(tier, tmp_path):
    """The transfer ladder's halves go into the first pages of the same two
    page buffers: two buffer addresses, at most two in flight, and the
    result of the clean scan."""
    _need_card()
    from repro_torch.db.executor import StreamingScanExecutor

    x = np.random.default_rng(15).normal(size=(640, 7)).astype(np.float32)
    store = TensorBlockStore(device="cuda", default_page_rows=32,
                             spill_dir=str(tmp_path))
    ds = store.put("t", x, tier=tier)
    clean, _, _ = StreamingScanExecutor(_x_stages()).execute(ds, 4)
    seen = []
    out, _, stats = StreamingScanExecutor(
        _x_stages(seen), injector=_armed(page_dma_in=dict(fail_at=1,
                                                          times=3)),
        retry_policy=_fast()).execute(ds, 4)
    assert stats.batch_resubmits == 1 and stats.batches == 6
    assert stats.max_in_flight <= 2 and len(set(seen)) == 2
    assert torch.equal(_bits(out), _bits(clean))


@pytest.mark.gpu
@pytest.mark.parametrize("site", ["kernel_launch", "drain_copy_out"])
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_a_scanfault_leaves_no_stream_busy_and_no_reader(tier, site,
                                                         monkeypatch,
                                                         tmp_path):
    _need_card()
    import threading

    from repro_torch.db.faults import ScanFault

    engine, forest = _tier_engine(tier, 16, tmp_path)
    streams = []

    class _Kept(torch.cuda.Stream):
        def __new__(cls, *a, **kw):
            s = super().__new__(cls, *a, **kw)
            streams.append(s)
            return s

    monkeypatch.setattr(torch.cuda, "Stream", _Kept)
    kw = dict(algorithm="predicated_pallas_fused", batch_pages=4)
    with pytest.raises(ScanFault) as info:
        engine.infer("t", forest, retry_policy=_fast(),
                     injector=_armed(**{site: dict(fail_at=3,
                                                   times=10**6)}), **kw)
    assert info.value.site == site
    assert info.value.rows_completed == 2 * 4 * 32
    assert len(streams) >= 2 and all(s.query() for s in streams)
    assert not [t for t in threading.enumerate() if t.name == "scan-reader"]
    monkeypatch.undo()
    again = engine.infer("t", forest, **kw)
    assert again.scan.batches == 8 and not torch.isnan(
        again.predictions).any()


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["device", "host", "disk"])
def test_a_deadline_partial_has_landed_when_execute_returns(tier, tmp_path):
    """Three of eight batches: their rows are in the result when
    ``execute`` returns (no synchronise by the caller), the rest NaN."""
    _need_card()
    from repro_torch.db.executor import StreamingScanExecutor
    from repro_torch.db.faults import Deadline

    class _Counting(Deadline):
        def __init__(self, n):
            super().__init__(None)
            self.n = n

        @property
        def expired(self):
            self.n -= 1
            return self.n < 0

    x = np.random.default_rng(17).normal(size=(1024, 7)).astype(np.float32)
    store = TensorBlockStore(device="cuda", default_page_rows=32,
                             spill_dir=str(tmp_path))
    ds = store.put("t", x, tier=tier)
    ex = StreamingScanExecutor(_x_stages(), deadline=_Counting(3))
    out, _, stats = ex.execute(ds, 4)
    mask = torch.from_numpy(ex.last_mask)
    got = out.cpu() if tier == "device" else out.clone()
    torch.cuda.synchronize()
    clean, _, _ = StreamingScanExecutor(_x_stages()).execute(ds, 4)
    assert stats.deadline_hit and stats.batches == 3
    assert int(mask.sum()) == 3 * 4 * 32
    assert torch.equal(_bits(got[mask]), _bits(clean.cpu()[mask]))
    assert torch.isnan(got[~mask]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_a_stage_error_is_not_retried_on_the_card(tier, tmp_path):
    """A RuntimeError out of a stage (what a CUDA error is) is not in the
    policy's retryable set: one call, no retry counted."""
    _need_card()
    from repro_torch.db.executor import StreamingScanExecutor
    from repro_torch.obs import METRICS

    x = np.ones((256, 3), np.float32)
    store = TensorBlockStore(device="cuda", default_page_rows=32,
                             spill_dir=str(tmp_path))
    ds = store.put("t", x, tier=tier)
    from repro_torch.db.operators import Operator, split_into_stages
    calls = []

    def udf(state):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")

    before = METRICS.counter_values().get("scan.retries", 0)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        StreamingScanExecutor(
            split_into_stages([Operator("udf", udf, breaker=True)]),
            injector=_armed(), retry_policy=_fast()).execute(ds, 2)
    assert len(calls) == 1
    assert METRICS.counter_values().get("scan.retries", 0) == before


# -- the serving plane --------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm,plan", [
    ("predicated_pallas_fused", "udf"), ("hummingbird_pallas_fused", "udf"),
    ("quickscorer_pallas_fused", "udf"), ("predicated_pallas", "rel+reuse")])
def test_serve_tenant_matches_infer_rows_with_exact_launches(algorithm,
                                                             plan):
    """A tenant per fused kernel (and the raw predicated one under
    rel+reuse): every request's predictions bit for bit those of a direct
    ``infer_rows`` over the same padded bucket, and each tick launches its
    kernel once (n_parts times for rel+reuse) and nothing else."""
    _need_card()
    from repro_torch.serve.forest import ForestServeEngine
    from repro_torch.serve.router import TIER_BATCH

    forest, x = _case(T=37, depth=6, F=28, B=40, seed=31,
                      integer_leaves=False, device="cuda")
    eng = ForestServeEngine(TensorBlockStore(device="cuda"), buckets=(8, 32))
    eng.register_model("m", forest, algorithm=algorithm, plan=plan)
    base = algorithm.split("_")[0]
    wrappers = KERNEL_WRAPPERS if algorithm.endswith("_fused") \
        else RAW_KERNEL_WRAPPERS
    sizes = [1, 3, 4, 2, 4, 1, 2, 3]          # 20 rows: one tick of 32
    before = {w: w.launches for w in (*KERNEL_WRAPPERS.values(),
                                      *RAW_KERNEL_WRAPPERS.values())}
    reqs, off = [], 0
    for k in sizes:
        reqs.append(eng.submit("m", x[off:off + k], priority=TIER_BATCH))
        off += k
    eng.drain()
    torch.cuda.synchronize()
    launched = {w: w.launches - n for w, n in before.items()}
    st = eng.stats("m")
    assert (st["ticks"], st["padding_rows"], st["plan_misses"]) == (1, 12, 0)
    n_parts = 1 if plan == "udf" else eng.qe._resolve_n_parts(
        forest, algorithm, None)
    assert launched[wrappers[base]] == n_parts
    assert sum(launched.values()) == n_parts
    xp = np.zeros((32, 28), np.float32)
    xp[:off] = x[:off]
    mask = np.arange(32) < off
    want = eng.qe.infer_rows(forest, xp, row_mask=mask, algorithm=algorithm,
                             plan=plan).predictions.cpu()
    got = torch.from_numpy(np.concatenate([r.wait(5.0) for r in reqs]))
    assert torch.equal(_bits(got), _bits(want[:off]))


@pytest.mark.gpu
def test_serve_ticker_flushes_a_lone_request_at_its_deadline():
    """With the ticker running, a lone interactive request is served no
    earlier than the interactive deadline (it never fills a bucket), and
    the tick launches the fused kernel once."""
    _need_card()
    from repro_torch.serve.forest import ForestServeEngine
    from repro_torch.serve.router import TIER_INTERACTIVE

    forest, x = _case(T=37, depth=8, F=28, B=8, seed=32,
                      integer_leaves=True, device="cuda")
    eng = ForestServeEngine(TensorBlockStore(device="cuda"),
                            interactive_deadline_s=0.002,
                            algorithm="predicated_pallas_fused")
    eng.register_model("m", forest)
    kernel = KERNEL_WRAPPERS["predicated"]
    before = kernel.launches
    with eng:
        req = eng.submit("m", x[1], priority=TIER_INTERACTIVE)
        out = req.wait(10.0)
    assert eng._ticker is None
    assert kernel.launches == before + 1
    assert eng.stats("m")["ticks"] == 1
    assert 0.002 <= req.finished_at - req.submitted_at < 1.0
    direct = eng.qe.infer_rows(forest, np.pad(x[1:2], ((0, 7), (0, 0))),
                               row_mask=np.arange(8) < 1,
                               algorithm="predicated_pallas_fused")
    assert torch.equal(_bits(torch.from_numpy(out)),
                       _bits(direct.predictions[:1].cpu()))


# -- the cost-based optimizer ---------------------------------------------------


@pytest.mark.gpu
def test_calibration_on_the_card_is_pinned_and_positive():
    """The card's peaks table: every key positive, the H2D source pinned,
    keyed by the device (a CPU table is another table), cached."""
    _need_card()
    from repro_torch.launch import roofline

    assert roofline.h2d_source("cuda").is_pinned()
    peaks = roofline.calibrate_peaks("cuda")
    for k in ("peak_flops_bf16", "hbm_bandwidth", "ici_bandwidth",
              "gather_bandwidth", "h2d_bandwidth", "dispatch_s"):
        assert peaks[k] > 0, k
    assert peaks["backend"].startswith("cuda") and peaks["measured"]
    assert roofline.resolve_peaks(torch.device("cuda")) is peaks
    assert roofline.calibrate_peaks("cpu") is not peaks


def _auto_case(tier="device"):
    forest, x = _case(T=64, depth=6, F=28, B=4096, seed=41,
                      integer_leaves=True, device="cuda")
    store = TensorBlockStore(device="cuda", default_page_rows=256)
    store.put("t", x, tier=tier)
    return forest, store, ForestQueryEngine(store)


@pytest.mark.gpu
def test_auto_query_on_the_card_probes_and_runs_only_kernels(monkeypatch):
    """On a CUDA store the candidates are the six kernels: no eager
    algorithm is probed (it would raise here) or chosen, and the repeat
    launches only the decided cell's kernel, bit for bit its static run."""
    _need_card()
    from repro_torch.core import algorithms as algs
    from repro_torch.db.optimizer import CUDA_ALGORITHMS

    def eager(*a, **k):
        raise AssertionError("an eager algorithm ran on the card")

    monkeypatch.setattr(algs, "predict_raw", eager)
    forest, store, eng = _auto_case()
    assert eng.optimizer.algorithms == CUDA_ALGORITHMS
    first = eng.infer("t", forest, plan="auto", algorithm="auto")
    d = first.decision
    assert d.algorithm in CUDA_ALGORITHMS and d.source == "measured"
    assert d.cells_scored == 12 and d.cells_measured >= 2
    (key,) = store.decision_catalog()
    assert key[4] == CUDA_ALGORITHMS
    wrappers = {**{f"{k}_pallas_fused": w for k, w in KERNEL_WRAPPERS.items()},
                **{f"{k}_pallas": w for k, w in RAW_KERNEL_WRAPPERS.items()}}
    before = {n: w.launches for n, w in wrappers.items()}
    again = eng.infer("t", forest, plan="auto", algorithm="auto")
    torch.cuda.synchronize()
    launched = {n: w.launches - before[n] for n, w in wrappers.items()}
    want = (d.n_parts or 1) * again.scan.batches
    assert launched == {n: (want if n == d.algorithm else 0)
                        for n in wrappers}
    static = eng.infer("t", forest, **d.overrides())
    assert torch.equal(_bits(again.predictions), _bits(static.predictions))


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["infer", "infer_rows", "register_model"])
def test_plan_auto_without_an_algorithm_chooses_a_kernel_on_the_card(
        entry, monkeypatch):
    """``plan="auto"`` with no algorithm named: the reference's default
    argument pins ``"predicated"``, but on a CUDA store the axis stays
    free, so the decision is over the six kernels and no eager algorithm
    is probed (it would raise here) or chosen, at every entry point."""
    _need_card()
    from repro_torch.core import algorithms as algs
    from repro_torch.db.optimizer import CUDA_ALGORITHMS
    from repro_torch.serve.forest import ForestServeEngine

    def eager(*a, **k):
        raise AssertionError("an eager algorithm ran on the card")

    monkeypatch.setattr(algs, "predict_raw", eager)
    forest, store, eng = _auto_case()
    if entry == "infer":
        chosen = eng.infer("t", forest, plan="auto").algorithm
    elif entry == "infer_rows":
        x = np.random.default_rng(5).standard_normal((64, 28)).astype(
            np.float32)
        chosen = eng.infer_rows(forest, x, plan="auto").algorithm
    else:
        serve = ForestServeEngine(store, buckets=(8, 32))
        chosen = serve.register_model("m", forest, plan="auto").algorithm
    assert chosen in CUDA_ALGORITHMS
    (key,) = store.decision_catalog()
    assert key[4] == CUDA_ALGORITHMS


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["device", "host"])
def test_a_probe_wall_covers_its_stages_device_time(tier):
    """The autotune's probes time ``_infer`` on the host clock; every
    stage ends in a device synchronise, so each probe's wall is at least
    the CUDA-event seconds of its stages."""
    _need_card()
    forest, store, eng = _auto_case(tier)
    calls = []
    infer = eng._infer

    def timed(*a, **k):
        t0 = time.perf_counter()
        res = infer(*a, **k)
        calls.append((time.perf_counter() - t0,
                      sum(r.seconds for r in res.stage_reports)))
        return res

    eng._infer = timed
    d = eng.optimizer.decide("t", forest)
    assert d.source == "measured" and len(calls) >= 2 * d.cells_measured
    for wall, device_s in calls:
        assert device_s > 0 and wall >= device_s


# -- in-database training on the card (db/train.py) ---------------------------


def _train_case(tier, tmp_path, *, n=3000, f=9, seed=0):
    from repro_torch.core.train import TrainConfig, quantile_bin_edges
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, f)).astype(np.float32)
    y = (np.nan_to_num(x) @ r.normal(size=f) > 0).astype(np.float32)
    x[r.random(x.shape) < 0.1] = np.nan
    budgets = dict(device=dict(), host=dict(device_budget_bytes=16 << 10),
                   disk=dict(device_budget_bytes=16 << 10,
                             host_budget_bytes=8 << 10))[tier]
    store = TensorBlockStore(default_page_rows=64, spill_dir=str(tmp_path),
                             **budgets)
    store.put("d", x, labels=y, tier="auto")
    assert store.get("d").tier == tier
    cfg = TrainConfig(num_trees=3, max_depth=4, num_bins=32)
    return store, x, y, cfg, quantile_bin_edges(x, cfg.num_bins)


@pytest.mark.gpu
@pytest.mark.parametrize("model_type", ["randomforest", "xgboost",
                                        "lightgbm"])
@pytest.mark.parametrize("tier", ["host", "device"])
def test_streamed_train_on_the_card_equals_resident(tier, model_type,
                                                    tmp_path):
    """Routing and binning on the card, histograms on the host: the
    streamed forest equals the resident ``train_forest`` on the card (and
    on the CPU) bit for bit."""
    _need_card()
    from repro_torch.core.train import train_forest
    store, x, y, cfg, edges = _train_case(tier, tmp_path)
    cfg = dataclasses.replace(cfg, model_type=model_type, colsample=0.6)
    res = ForestQueryEngine(store).train("d", cfg, edges=edges,
                                         batch_pages=5)
    assert res.forest.device.type == "cuda"
    ref = train_forest(x, y, cfg, edges=edges)
    cpu = train_forest(x, y, cfg, edges=edges, device="cpu")
    for name, arr in ref.arrays().items():
        assert torch.equal(getattr(res.forest, name), arr), name
        assert torch.equal(arr.cpu(), getattr(cpu, name)), name
    assert store.get("d::bins").data.is_pinned() == (tier == "host")
    assert all(st.max_in_flight <= 2 for st in res.scan_stats)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_on_batch_sees_row_order_at_depth_two_on_the_card(tier, tmp_path):
    """The hook runs on the stages' thread in plan order, each batch once,
    while the next batch's pages are in flight (and, on the disk tier,
    the reader thread reads ahead)."""
    _need_card()
    from repro_torch.db.executor import StreamingScanExecutor
    from repro_torch.db.operators import Operator, split_into_stages
    store, x, _, _, _ = _train_case(tier, tmp_path)
    ds = store.get("d")
    seen = []

    def op(state):
        state = dict(state)
        state["node_of"] = state["k"] * 2
        return state

    def on_batch(first, n, state):
        seen.append((first, state["x"][:, 0].cpu(),
                     state["node_of"][:1].item()))

    out, _, st = StreamingScanExecutor(
        split_into_stages([Operator("op", op)]), prefetch_depth=2,
        result_key="node_of").execute(
        ds, 4, on_batch=on_batch,
        extras=lambda first, n: {"k": torch.full(
            (n * 64,), first, dtype=torch.int32, device="cuda")})
    firsts = [f for f, _, _ in seen]
    assert firsts == list(range(0, ds.num_pages, 4))
    assert [v for *_, v in seen] == [2 * f for f in firsts]
    got = torch.cat([c for _, c, _ in seen])[: x.shape[0]].numpy()
    np.testing.assert_array_equal(got, x[:, 0])
    assert out.dtype == torch.int32 and out.is_pinned()
    assert st.max_in_flight == 2 and st.batches == len(seen)


@pytest.mark.gpu
def test_router_trains_and_routes_on_the_card():
    _need_card()
    from repro_torch.serve.router import ForestRouter, synth_router_trace
    router = ForestRouter()
    assert router.forest.device.type == "cuda"
    cpu = ForestRouter(device="cpu")
    for name, arr in cpu.forest.arrays().items():
        assert torch.equal(getattr(router.forest, name).cpu(), arr), name
    x, y = synth_router_trace(1000, seed=3)
    tiers = router.route(x)
    np.testing.assert_array_equal(tiers, cpu.route(x))
    assert (tiers == y.astype(int)).mean() > 0.8


# -- the mesh on the card -------------------------------------------------------

MESH_ALGORITHMS = ("predicated_pallas_fused", "hummingbird_pallas_fused",
                   "quickscorer_pallas_fused", "predicated_pallas",
                   "hummingbird_pallas", "quickscorer_pallas")


def _mesh_case(device, mesh=None):
    fe, th, dl, lv = random_forest_arrays(None, T=24, depth=6, F=16,
                                          seed=31)
    forest = make_forest(fe, th, lv, default_left=dl, n_features=16,
                         device=device)
    x = np.random.default_rng(32).normal(size=(4000, 16)).astype(np.float32)
    store = TensorBlockStore(device=device, mesh=mesh, default_page_rows=256)
    store.put("d", x)
    store.put_sparse("c", x)
    return forest, ForestQueryEngine(store)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", MESH_ALGORITHMS)
@pytest.mark.parametrize("plan", ["udf", "rel"])
def test_repeated_card_mesh_equals_meshless(plan, algorithm):
    """Eight positions on cuda:0: every kernel, udf and rel, dense and
    CSR, bit for bit the mesh-less run at n_parts = n_model, with one
    launch a data shard (udf) or a position (rel) a batch."""
    _need_card()
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(2, 4, devices=["cuda:0"] * 8)
    forest, em = _mesh_case("cuda", mesh)
    _, es = _mesh_case("cuda")
    wrappers = {**{f"{k}_pallas_fused": w for k, w in KERNEL_WRAPPERS.items()},
                **{f"{k}_pallas": w for k, w in RAW_KERNEL_WRAPPERS.items()}}
    for fmt in ("d", "c"):
        w = wrappers[algorithm]
        w.launches = 0
        got = em.infer(fmt, forest, algorithm=algorithm, plan=plan,
                       batch_pages=4)
        torch.cuda.synchronize()
        per = 2 if plan == "udf" else 8
        assert w.launches == per * got.scan.batches
        want = es.infer(fmt, forest, algorithm=algorithm, plan=plan,
                        batch_pages=4, n_parts=None if plan == "udf" else 4)
        assert torch.equal(got.predictions, want.predictions), fmt


@pytest.mark.gpu
def test_replicated_pages_are_held_once_on_the_card():
    """A (2, 4) mesh of one card holds a device-tier table once: the put
    allocates one padded copy, and a query allocates no replica of it."""
    _need_card()
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(2, 4, devices=["cuda:0"] * 8)
    store = TensorBlockStore(mesh=mesh)
    x = torch.randn((1 << 20, 28), device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ds = store.put("d", x)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    assert ds.nbytes <= grown < ds.nbytes + (4 << 20)
    fe, th, dl, lv = random_forest_arrays(None, T=16, depth=6, F=28,
                                          seed=33)
    forest = make_forest(fe, th, lv, default_left=dl, n_features=28,
                         device="cuda")
    engine = ForestQueryEngine(store)
    engine.infer("d", forest, algorithm="predicated_pallas_fused",
                 plan="rel")
    torch.cuda.synchronize()
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine.infer("d", forest, algorithm="predicated_pallas_fused",
                 plan="rel")
    torch.cuda.synchronize()
    # a query's working set is its [B] outputs, never a copy of the pages
    assert torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated() \
        < ds.nbytes // 2, peak_before


@pytest.mark.gpu
def test_distinct_card_mesh_equals_meshless():
    """A mesh over distinct cards: each shard computes on its own card."""
    _need_card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(2, 1) if n < 4 else make_local_mesh(2, 2)
    forest, em = _mesh_case("cuda:0", mesh)
    _, es = _mesh_case("cuda:0")
    for plan in ("udf", "rel"):
        got = em.infer("d", forest, algorithm="predicated_pallas_fused",
                       plan=plan)
        want = es.infer("d", forest, algorithm="predicated_pallas_fused",
                        plan=plan, n_parts=mesh.shape["model"]
                        if plan == "rel" else None)
        assert torch.equal(got.predictions.cpu(), want.predictions.cpu())


@pytest.mark.gpu
def test_make_local_mesh_refuses_more_cards_than_there_are():
    _need_card()
    from repro_torch.launch.mesh import make_local_mesh
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="distinct cards"):
        make_local_mesh(n + 1, 1)
    with pytest.raises(ValueError, match="cannot take a mesh"):
        TensorBlockStore(device="cpu",
                         mesh=make_local_mesh(1, 1, devices=["cuda:0"]))


# -- the LM serving path (repro_torch.models, serve/engine.py) ----------------


def _lm_case():
    """Reduced olmo-1b with f32 weights drawn on the CPU, and the same
    weights as numpy arrays for ``params_from_arrays``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm as LM
    cfg = reduced(get_config("olmo-1b"))
    params = LM.init_lm(cfg, torch.Generator().manual_seed(0),
                        dtype=torch.float32, device="cpu")

    def arrays(node):
        if isinstance(node, dict):
            return {k: arrays(v) for k, v in node.items()}
        return node.numpy()
    return cfg, params, arrays(params)


def _greedy_until_tie(cfg, params, prompt, bucket, max_new, ctx, gap):
    """The single-request greedy loop; stops where its top-two logits lie
    within ``gap`` (a near-tie that another batch width may flip)."""
    from repro_torch.models import lm as LM
    toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
    toks[0, bucket - len(prompt):] = torch.as_tensor(prompt)
    logits, caches = LM.lm_prefill(cfg, params, toks, ctx=ctx)
    out = []
    while len(out) < max_new:
        top2 = torch.topk(logits[0], 2).values
        if float(top2[0] - top2[1]) < gap:
            break
        out.append(int(torch.argmax(logits[0])))
        logits, caches = LM.lm_decode(
            cfg, params, caches, torch.tensor([[out[-1]]], device="cuda"))
    return out


@pytest.mark.gpu
def test_lm_on_cuda_equals_cpu():
    _need_card()
    from repro_torch.models import lm as LM
    cfg, params, arrays = _lm_case()
    cuda = LM.params_from_arrays(arrays, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)))
    want, wc = LM.lm_prefill(cfg, params, toks[:, :32], ctx=34)
    got, gc = LM.lm_prefill(cfg, cuda, toks[:, :32].cuda(), ctx=34)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    want, wc = LM.lm_decode(cfg, params, wc, toks[:, 32:])
    got, gc = LM.lm_decode(cfg, cuda, gc, toks[:, 32:].cuda())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gc["p0"]["k"].cpu().numpy(),
                               wc["p0"]["k"].numpy(), rtol=1e-4, atol=1e-4)
    assert gc["p0"]["k"].device.type == "cuda"


@pytest.mark.gpu
def test_lm_engine_on_cuda_equals_single_request_loop():
    _need_card()
    from repro_torch.models import lm as LM
    from repro_torch.serve.engine import ServeEngine
    cfg, _, arrays = _lm_case()
    cuda = LM.params_from_arrays(arrays, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 12) for _ in range(4)]
    engine = ServeEngine(cfg, cuda, slots=2, max_ctx=96,
                         prompt_buckets=(16,), dtype=torch.float32)
    uids = [engine.submit(p, max_new_tokens=8) for p in prompts]
    by_uid = {r.uid: r.tokens for r in engine.run_until_drained()}
    compared = 0
    for uid, p in zip(uids, prompts):
        want = _greedy_until_tie(cfg, cuda, p, 16, 8, 96, gap=1e-4)
        assert by_uid[uid][:len(want)] == want
        compared += len(want)
    assert compared >= 8


@pytest.mark.gpu
def test_lm_entry_points_default_to_cuda():
    _need_card()
    from repro_torch.models import lm as LM
    from repro_torch.serve.engine import ServeEngine
    cfg, _, arrays = _lm_case()
    params = LM.init_lm(cfg, torch.Generator(device="cuda").manual_seed(0))
    assert params["embed"].is_cuda
    assert params["embed"].dtype == torch.bfloat16
    assert LM.params_from_arrays(arrays)["embed"].is_cuda
    assert LM.init_caches(cfg, 2, 8)["p0"]["k"].is_cuda
    engine = ServeEngine(cfg, params)
    assert engine.device.type == "cuda"
    assert engine.caches["index"].is_cuda
    engine.submit(np.arange(5), max_new_tokens=3)
    (req,) = engine.run_until_drained()
    assert len(req.tokens) == 3
    assert all(0 <= t < cfg.vocab_padded for t in req.tokens)


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.to("cuda")


LM_FAMILIES = ["mamba2-2.7b", "zamba2-2.7b", "llama4-scout-17b-a16e",
               "llama4-maverick-400b-a17b"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_family_on_cuda_equals_cpu(arch):
    """The SSD, hybrid and MoE families at ``reduced()`` on the card
    against the port's CPU run on the same f32 weights: logits and every
    cache leaf (the SSD conv window and state, the shared K/V) after a prefill of 40 tokens (two SSD chunks, a padded tail) and
    two decode steps, within 1e-4; the engine on the card against the
    single-request loop up to its first near-tie."""
    _need_card()
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm as LM
    from repro_torch.serve.engine import ServeEngine
    cfg = reduced(get_config(arch))
    params = LM.init_lm(cfg, torch.Generator().manual_seed(1),
                        dtype=torch.float32, device="cpu")
    cuda = _to_cuda(params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 42)))
    want, wc = LM.lm_prefill(cfg, params, toks[:, :40], ctx=44)
    got, gc = LM.lm_prefill(cfg, cuda, toks[:, :40].cuda(), ctx=44)
    for step in range(3):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
        for name, c in wc.items():
            if name == "index":
                continue
            for leaf, t in c.items():
                assert gc[name][leaf].is_cuda
                assert gc[name][leaf].dtype == t.dtype
                np.testing.assert_allclose(gc[name][leaf].cpu().numpy(),
                                           t.numpy(), rtol=1e-4, atol=1e-4)
        if step < 2:
            tok = toks[:, 40 + step:41 + step]
            want, wc = LM.lm_decode(cfg, params, wc, tok)
            got, gc = LM.lm_decode(cfg, cuda, gc, tok.cuda())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (12, 5, 16)]
    engine = ServeEngine(cfg, cuda, slots=2, max_ctx=64,
                         prompt_buckets=(16,), dtype=torch.float32)
    uids = [engine.submit(p, max_new_tokens=6) for p in prompts]
    by_uid = {r.uid: r.tokens for r in engine.run_until_drained()}
    compared = 0
    for uid, p in zip(uids, prompts):
        want_toks = _greedy_until_tie(cfg, cuda, p, 16, 6, 64, gap=1e-4)
        assert by_uid[uid][:len(want_toks)] == want_toks
        compared += len(want_toks)
    assert compared >= 6


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_leaves(tree[k])]
    return [tree]


LM_TRAIN_ARCHS = ["olmo-1b", "llama4-scout-17b-a16e", "mamba2-2.7b",
                  "zamba2-2.7b", "seamless-m4t-large-v2"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_TRAIN_ARCHS)
def test_lm_train_step_on_cuda_equals_cpu(arch):
    """One AdamW step at ``reduced()`` on the card against the CPU from
    the same state (``state_from_arrays``), in f32: loss, gnorm, the new
    parameters and ``mu`` (0.1 x the gradients) within 1e-4.  The default
    optimizer's first step moves a parameter by at most 6e-6, so AdamW's
    ``g / (|g| + eps)`` cannot magnify the gradients' rounding past it."""
    _need_card()
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import (init_state, make_train_step,
                                           state_from_arrays)
    cfg = reduced(get_config(arch))
    opt = make_optimizer(OptimizerConfig())
    arrays = _host(init_state(cfg, opt, torch.Generator().manual_seed(0),
                              dtype=torch.float32, device="cpu"))
    batch = batch_for(cfg, ShapeConfig("t", 48, 2, "train"), 0, seed=1)
    step = make_train_step(cfg, opt)
    got, gm = step(state_from_arrays(arrays, device="cuda"), batch)
    want, wm = step(state_from_arrays(arrays, device="cpu"), batch)
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   rtol=1e-4, atol=1e-4)
    for part in ("params", "opt"):
        for a, b in zip(_tree_leaves(got[part]), _tree_leaves(want[part])):
            assert a.is_cuda and a.dtype == b.dtype
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=0, atol=1e-4)
    assert int(got["step"]) == 1


@pytest.mark.gpu
def test_lm_train_loop_restores_bit_for_bit_on_cuda(tmp_path):
    """TrainLoop on the card, deterministic steps: a failure at step 7, a
    restore from step 5 and 5 more steps equal an uninterrupted 10-step run
    bit for bit."""
    _need_card()
    from repro_torch.configs import get_config, reduced
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.fault import FailureInjector, TrainLoop
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import init_state, make_train_step
    cfg = reduced(get_config("olmo-1b"))
    opt = make_optimizer(OptimizerConfig(lr=1e-3, warmup_steps=2))
    dc = DataConfig(seed=5, vocab_size=cfg.vocab_size, batch=4, seq_len=32)

    def fresh():
        return init_state(cfg, opt, torch.Generator(device="cuda")
                          .manual_seed(0), dtype=torch.float32)

    def loop(ckpt_dir=None, **kw):
        return TrainLoop(make_train_step(cfg, opt),
                         lambda k: synthetic_batch(dc, k),
                         ckpt_dir=ckpt_dir, ckpt_every=5, **kw)
    straight, _ = loop().run(fresh(), 10)
    faulty = loop(str(tmp_path), injector=FailureInjector(fail_at=7))
    with pytest.raises(RuntimeError, match="injected node failure"):
        faulty.run(fresh(), 10)
    restored, step = faulty.restore(fresh())
    assert step == 5 and restored["params"]["embed"].is_cuda
    resumed, _ = faulty.run(restored, 5, start_step=step)
    for a, b in zip(_tree_leaves(resumed), _tree_leaves(straight)):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


@pytest.mark.gpu
def test_encdec_on_cuda_equals_cpu():
    """Reduced seamless in f32: prefill and token-by-token decode on the
    card against the CPU within 1e-4; the self cache stays on the card."""
    _need_card()
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import encdec as ED
    cfg = reduced(get_config("seamless-m4t-large-v2"))
    params = ED.init_encdec(cfg, torch.Generator().manual_seed(2),
                            dtype=torch.float32, device="cpu")
    cuda = _to_cuda(params)
    r = np.random.default_rng(3)
    frames = torch.from_numpy(r.normal(size=(2, 40, cfg.d_model))
                              .astype(np.float32))
    toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (2, 6)))
    want, _ = ED.encdec_prefill(cfg, params, frames, toks)
    got, _ = ED.encdec_prefill(cfg, cuda, frames.cuda(), toks.cuda())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    caches = ED.init_encdec_caches(cfg, 2, 8, mem_frames=40,
                                   dtype=torch.float32)
    assert caches["self"]["k"].is_cuda
    caches["memory"] = ED.encode(cfg, cuda, frames.cuda())
    for i in range(6):
        got, caches = ED.encdec_decode(cfg, cuda, caches,
                                       toks[:, i:i + 1].cuda())
        want, _ = ED.encdec_prefill(cfg, params, frames, toks[:, :i + 1])
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert caches["self"]["k"].is_cuda and int(caches["index"]) == 6


@pytest.mark.gpu
def test_train_entry_points_default_to_cuda():
    _need_card()
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as train_cli
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import init_state
    cfg = reduced(get_config("seamless-m4t-large-v2"))
    state = init_state(cfg, make_optimizer(OptimizerConfig()),
                       torch.Generator(device="cuda").manual_seed(0))
    assert all(t.is_cuda for t in _tree_leaves(state))
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["opt"]["mu"]["embed"].dtype == torch.float32
    out = train_cli.main(["--arch", "olmo-1b", "--steps", "2", "--batch",
                          "2", "--seq", "32"])
    assert np.isfinite(out["last_loss"])


# -- the LM on a mesh of card positions (dist/sharding.py's LM half) ----------


@pytest.mark.gpu
def test_lm_mesh_ep_on_cuda_equals_cpu():
    """llama4-scout at ``reduced()`` on a (data 2, model 4) mesh of card
    positions against the same mesh of CPU positions, in f32: the EP
    prefill at the config's capacity (drops included) and one EP decode
    step, logits within 1e-4."""
    _need_card()
    from repro_torch.configs import get_config, reduced
    from repro_torch.dist.sharding import make_plan
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.models import get_bundle
    from repro_torch.models import lm as LM
    cfg = reduced(get_config("llama4-scout-17b-a16e"))
    pairs = (("data", 2), ("model", 4))
    params = get_bundle(cfg).init(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.float32, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        splan = make_plan(cfg, make_position_mesh(pairs, dev),
                          decode_batch=2)
        p = LM.params_from_arrays(_host(params), device=dev)
        t = toks.to(dev)
        pre, caches = LM.lm_prefill(cfg, p, t[:, :16], splan=splan, ctx=20)
        dec, _ = LM.lm_decode(cfg, p, caches, t[:, 16:], splan=splan)
        out[dev] = (pre.cpu(), dec.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.gpu
def test_lm_mesh_train_step_on_cuda_is_the_twin_over_compressed_grads():
    """olmo at ``reduced()`` on (pod 2, data 2, model 2) card positions with
    ``grad_compress``: the loss bit for bit the mesh-less step's, the new
    parameters bit for bit the twin's update over its int8-round-tripped
    gradients."""
    _need_card()
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.dist.compression import compress_grads_crosspod
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.models import get_bundle
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import (deterministic_algorithms,
                                           init_state, jit_train_step)
    from repro_torch.train.tree import tree_unflatten
    cfg = reduced(get_config("olmo-1b"))
    opt = make_optimizer(OptimizerConfig())
    state = init_state(cfg, opt, torch.Generator(device="cuda").manual_seed(0),
                       dtype=torch.float32)
    batch = batch_for(cfg, ShapeConfig("t", 64, 4, "train"), 0, seed=1)
    mesh = make_position_mesh((("pod", 2), ("data", 2), ("model", 2)),
                              "cuda:0")
    step, _ = jit_train_step(cfg, opt, mesh, grad_compress=True)
    new, m = step(state, batch)
    with deterministic_algorithms():
        leaves = [t.detach().requires_grad_() for t in
                  _tree_leaves(state["params"])]
        tb = {k: torch.from_numpy(v).long().cuda() for k, v in batch.items()}
        loss = get_bundle(cfg).loss(
            cfg, tree_unflatten(state["params"], leaves), tb, None)
        grads = tree_unflatten(state["params"],
                               list(torch.autograd.grad(loss, leaves)))
        want, _ = opt.update(compress_grads_crosspod(grads, None),
                             state["opt"], state["params"], state["step"])
    assert torch.equal(m["loss"], loss.detach())
    for a, b in zip(_tree_leaves(new["params"]), _tree_leaves(want)):
        assert a.is_cuda and torch.equal(a, b)


def _spmd_against_held_once(cfg, own_mesh, held_mesh):
    """f32 prefill and two decode steps of ``cfg`` on an own-shards plan
    over ``own_mesh`` and a held-once plan over ``held_mesh``, on the same
    weights: (own logits, held-once logits) of each call."""
    from repro_torch.dist.sharding import make_plan, shard_params
    from repro_torch.models import get_bundle
    from repro_torch.models import lm as LM
    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0),
        dtype=torch.float32)
    held = make_plan(cfg, held_mesh, decode_batch=2)
    own = make_plan(cfg, own_mesh, decode_batch=2, own_shards=True)
    pieces = shard_params(params, own)
    toks = torch.randint(0, cfg.vocab_size, (2, 18), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    w, wc = LM.lm_prefill(cfg, params, toks[:, :16], splan=held, ctx=24)
    g, gc = LM.lm_prefill(cfg, pieces, toks[:, :16], splan=own, ctx=24)
    out = [(g, w)]
    for i in range(2):
        t = toks[:, 16 + i:17 + i]
        w, wc = LM.lm_decode(cfg, params, wc, t, splan=held)
        g, gc = LM.lm_decode(cfg, pieces, gc, t, splan=own)
        out.append((g, w))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-7b", "mamba2-2.7b",
                                  "zamba2-2.7b"])
def test_lm_spmd_on_card_positions_matches_held_once(arch):
    """``chip_smoke.py`` phase 20 (a), (e) and (f) at a reduced width whose
    MLP, SSD and embedding weights are sharded (d_model 256): eight
    ``cuda:0`` positions that own their pieces (olmo tp, qwen2 cp, the SSD
    heads over model, zamba2's shared block) against the held-once path on
    the same mesh, f32 logits within 1e-4."""
    _need_card()
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_position_mesh
    cfg = reduced(get_config(arch), d_model=256, vocab=2048)
    mesh = make_position_mesh((("data", 2), ("model", 4)), "cuda:0")
    for g, w in _spmd_against_held_once(cfg, mesh, mesh):
        assert g.is_cuda
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_lm_spmd_on_distinct_cards_matches_held_once():
    """Phase 20 (d): the same olmo over distinct cards ``make_local_mesh(1,
    n)``, each card's positions owning their pieces and exchanging them by
    peer copies, against the held-once path on one card."""
    _need_card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_local_mesh, make_position_mesh
    cfg = reduced(get_config("olmo-1b"), d_model=256, vocab=2048)
    held = make_position_mesh((("data", 1), ("model", n)), "cuda:0")
    for g, w in _spmd_against_held_once(cfg, make_local_mesh(1, n), held):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "llama4-scout-17b-a16e",
                                  "mamba2-2.7b"])
def test_lm_spmd_train_step_on_card_positions_matches_held_once(arch):
    """``chip_smoke.py`` phase 21 (b) at reduced(): one f32 AdamW step over
    eight ``cuda:0`` positions that own their pieces against the held-once
    step on the same mesh from the same state, loss and gnorm within 1e-4
    relative, the new state pieces on the card."""
    _need_card()
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.dist.sharding import Sharded, make_plan
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import (init_state, jit_train_step,
                                           make_train_step)
    cfg = reduced(get_config(arch))
    mesh = make_position_mesh((("data", 2), ("model", 4)), "cuda:0")
    opt = make_optimizer(OptimizerConfig(lr=1e-2, warmup_steps=1))
    state = init_state(cfg, opt, torch.Generator(device="cuda").manual_seed(0),
                       dtype=torch.float32)
    batch = batch_for(cfg, ShapeConfig("m", 32, 4, "train"), 0)
    _, want = make_train_step(cfg, opt, make_plan(cfg, mesh))(state, batch)
    new, got = jit_train_step(cfg, opt, mesh, own_shards=True)[0](state,
                                                                   batch)
    for key in ("loss", "gnorm"):
        assert abs(float(got[key]) - float(want[key])) <= \
            1e-4 * abs(float(want[key])), key
    leaves = _tree_leaves(new["params"])
    assert all(isinstance(x, Sharded) and x.first.is_cuda for x in leaves)


# -- the dry-run's count on the card (launch/hlo_cost.py) -----------------------


def _count_step(arch: str, device: str, pairs):
    """``hlo_cost.analyze`` of one AdamW train step at ``reduced()`` on a
    mesh of ``device`` positions (``pairs``), from a state made on the
    CPU."""
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.launch.hlo_cost import analyze
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import init_state, jit_train_step
    cfg = reduced(get_config(arch))
    opt = make_optimizer(OptimizerConfig())
    state = init_state(cfg, opt, torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")
    state = _to_device(state, device)
    batch = batch_for(cfg, ShapeConfig("t", 64, 4, "train"), 0, seed=1)
    step, _ = jit_train_step(cfg, opt, make_position_mesh(pairs, device),
                             grad_compress=True)
    return analyze(step, state, batch)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "llama4-scout-17b-a16e",
                                  "mamba2-2.7b", "seamless-m4t-large-v2"])
def test_dryrun_count_on_cuda_equals_meta(arch):
    """One compressed train step at ``reduced()`` on (pod 2, data 2, model
    2) positions, counted on the card and on meta: FLOPs, bytes, ops, the
    peak of live bytes, every op's count and the collective record equal
    (llama4's EP all_to_alls, forward and the backward's transposes, which
    the card's autograd thread records)."""
    _need_card()
    pairs = (("pod", 2), ("data", 2), ("model", 2))
    card = _count_step(arch, "cuda:0", pairs)
    meta = _count_step(arch, "meta", pairs)
    assert "cuda:0" in card["devices"]
    for k in ("flops", "bytes", "ops", "peak_live_bytes", "by_op",
              "collective_bytes", "collective_counts"):
        assert card[k] == meta[k], k
    if arch.startswith("llama4"):
        assert card["collective_counts"]["all-to-all"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["olmo-1b", "llama4-scout-17b-a16e",
                                  "mamba2-2.7b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_dryrun_own_shards_count_on_cuda_equals_meta(arch, kind):
    """``launch/dryrun.build_cell(..., own_shards=True)`` at ``reduced()``
    on (data 2, model 4) positions, 4 x 64 tokens, counted on ``cuda:0``
    positions and on meta (the cyclic collector off): every key of the
    count and every collective record equal, and on the card the bytes
    the moves copied equal to the records' ``received_bytes``."""
    import dataclasses
    import gc

    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.dist import collectives as C
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.hlo_cost import CostMode
    from repro_torch.launch.mesh import make_local_mesh
    _need_card()
    full = get_config(arch)
    red = reduced(full)
    over = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}
    got = {}
    gc.disable()
    try:
        for dev in ("cuda:0", "meta"):
            fn, args, *_ = build_cell(
                arch, ShapeConfig("t", 64, 4, kind),
                make_local_mesh(2, 4, devices=[dev] * 8), overrides=over,
                own_shards=True)
            moved = C.moved_bytes()
            with CostMode(held=args) as mode:
                fn(*args)
            torch.cuda.synchronize()
            got[dev] = (mode.summary(), mode.records,
                        C.moved_bytes() - moved)
    finally:
        gc.enable()
    (card, recs, moved), (meta, meta_recs, _) = got["cuda:0"], got["meta"]
    # a train step may make one CPU tensor on both (torch 2.11's checkpoint
    # stashes the CPU RNG state); every other result lies on its device
    assert "cuda:0" in card["devices"] and "meta" in meta["devices"]
    assert card["ops_by_device"].get("cpu") == \
        meta["ops_by_device"].get("cpu")
    for k in ("flops", "bytes", "ops", "by_op", "peak_live_bytes",
              "collective_bytes_by_kind", "collective_wire_bytes_by_kind",
              "collective_counts"):
        assert card[k] == meta[k], k
    assert recs == meta_recs and recs
    assert moved == sum(C.received_bytes(*r) for r in recs)
