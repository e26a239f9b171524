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


@pytest.mark.gpu
@pytest.mark.parametrize("integer_leaves", [True, False],
                         ids=["integer", "float"])
@pytest.mark.parametrize("depth", [1, 3, 5, 8])
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
@pytest.mark.parametrize("depth", [1, 3, 5, 8])
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
    assert torch.equal(got, RAW_PLAIN[base](*args, depth=depth))


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
