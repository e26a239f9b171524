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

import numpy as np
import pytest
import torch

from repro_torch.core.forest import make_forest
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
        engine = ForestQueryEngine(TensorBlockStore(device=device))
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
    real = ex._StreamedScan.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        made.append(self)

    ex._StreamedScan.__init__ = spy
    try:
        res = ForestQueryEngine(store).infer(
            "csr", forest, algorithm="predicated_pallas_fused",
            batch_pages=3)
    finally:
        ex._StreamedScan.__init__ = real
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
