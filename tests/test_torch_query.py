"""Port parity: the in-database query, ``infer(plan="udf")`` end to end.

The same stored rows (with NaN rows and page padding) and the same forest
go through the reference ``ForestQueryEngine.infer`` (fused kernels in
Pallas interpret mode) and the port's, on the CPU device: bit-identical on
small-integer leaves (a regression forest, so phase 2 is exact), within
1e-6 otherwise.  Plus the plan cache, its sweeps, batching and the store.
"""

import numpy as np
import pytest
import torch

from repro.core.forest import make_forest as jmake_forest
from repro.core.reuse import ModelReuseCache as JCache
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.store import TensorBlockStore as JStore
from repro_torch.core.reuse import (GLOBAL_CACHE, GLOBAL_PLAN_CACHE,
                                    ModelReuseCache, mesh_signature)
from repro_torch.db.executor import MAX_IN_FLIGHT, StreamingScanExecutor
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.store import TensorBlockStore

from conftest import random_forest_arrays
from test_torch_forest import port_forest

ALGORITHMS = ["predicated_pallas_fused", "hummingbird_pallas_fused",
              "quickscorer_pallas_fused", "predicated"]
N, F, PAGE = 150, 9, 32


def _rows(seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(N, F)).astype(np.float32)
    x[r.random(x.shape) < 0.1] = np.nan
    x[::11] = np.nan                               # whole NaN rows
    return x


def _forest(*, integer_leaves, seed=3, T=10, depth=5):
    fe, th, dl, lv = random_forest_arrays(None, T=T, depth=depth, F=F,
                                          seed=seed)
    if integer_leaves:
        lv = np.random.default_rng(seed).integers(-8, 9, lv.shape).astype(
            np.float32)
        return jmake_forest(fe, th, lv, default_left=dl, n_features=F,
                            model_type="xgboost", task="regression",
                            base_score=0.5)
    return jmake_forest(fe, th, lv, default_left=dl, n_features=F)


def _port_engine(x, **kw):
    """A store holding ``x`` as ``"t"`` and an engine over it, with caches
    of its own unless ``kw`` passes some (the tests count its hits and
    entries from empty caches)."""
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put("t", x)
    kw.setdefault("reuse_cache", ModelReuseCache())
    kw.setdefault("plan_cache", ModelReuseCache())
    return store, ForestQueryEngine(store, **kw)


@pytest.mark.parametrize("integer_leaves", [False, True],
                         ids=["float", "integer"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_udf_infer_matches_reference(algorithm, integer_leaves):
    x = _rows()
    jf = _forest(integer_leaves=integer_leaves)
    jstore = JStore(default_page_rows=PAGE)
    jstore.put("t", x)
    want = JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache()).infer(
        "t", jf, algorithm=algorithm, plan="udf")
    _, engine = _port_engine(x)
    got = engine.infer("t", port_forest(jf), algorithm=algorithm,
                       plan="udf")
    w, g = np.asarray(want.predictions), got.predictions.numpy()
    assert g.shape == (N,) and np.isfinite(g).all()
    if integer_leaves:
        assert np.array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert got.num_stages == want.num_stages == 1
    assert got.scan.batches == want.scan.batches == 1


def test_repeated_query_hits_plan_cache_and_drop_sweeps():
    x = _rows(1)
    tf = port_forest(_forest(integer_leaves=False))
    store, engine = _port_engine(x, plan_cache=ModelReuseCache())
    kw = dict(algorithm="hummingbird_pallas_fused", plan="udf")
    r1 = engine.infer("t", tf, **kw)
    r2 = engine.infer("t", tf, **kw)
    assert not r1.plan_reuse_hit and r2.plan_reuse_hit and r2.reuse_hit
    assert torch.equal(r1.predictions, r2.predictions)
    assert engine.plan_cache.stats.hits == 1 and len(engine.plan_cache) == 1
    key = next(iter(engine.plan_cache._entries))
    assert key[0] == "udf-plan" and key[2] == "t"
    assert key[-1] == mesh_signature() == 1
    # dropping the dataset sweeps its plan; a re-put misses again
    assert store.drop("t") == 1 and len(engine.plan_cache) == 0
    store.put("t", x)
    assert not engine.infer("t", tf, **kw).plan_reuse_hit


@pytest.mark.parametrize("plan", ["udf", "rel+reuse"])
def test_a_second_engine_reuses_the_first_ones_model_and_plan(plan):
    """Engines built without caches share the process-global ones, in both
    packages: over one store and forest, the second engine's first query
    hits the model and the plan the first one built (the reference's
    ``GLOBAL_CACHE`` / ``GLOBAL_PLAN_CACHE``; the port's on the CPU).  The
    forest's leaves are drawn for this test alone, so the first engine's
    first query misses."""
    x = _rows(21)
    jf = _forest(integer_leaves=False, seed=2100 + len(plan))
    kw = dict(algorithm="predicated_pallas", plan=plan)
    jstore = JStore(default_page_rows=PAGE)
    jstore.put("t", x)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put("t", x)
    tf = port_forest(jf)
    for make, s, f in ((JEngine, jstore, jf), (ForestQueryEngine, store, tf)):
        first, second = make(s), make(s)
        a, b = first.infer("t", f, **kw), second.infer("t", f, **kw)
        assert not a.plan_reuse_hit and b.plan_reuse_hit
        assert b.reuse_hit and (plan == "udf" or not a.reuse_hit)
        assert second.cache is first.cache
        assert second.plan_cache is first.plan_cache
    assert ForestQueryEngine(store).cache is GLOBAL_CACHE
    assert ForestQueryEngine(store).plan_cache is GLOBAL_PLAN_CACHE


def test_invalidate_sweeps_one_model():
    x = _rows(2)
    store, engine = _port_engine(x)
    a = port_forest(_forest(integer_leaves=False, seed=4))
    b = port_forest(_forest(integer_leaves=False, seed=5))
    engine.infer("t", a, model_id="a")
    engine.infer("t", b, model_id="b")
    assert engine.invalidate("a") == 1 and len(engine.plan_cache) == 1
    assert engine.infer("t", b, model_id="b").plan_reuse_hit
    # re-pinning a model name sweeps the replaced forest's plans
    store.put_model("m", a)
    engine.infer("t", a)
    store.put_model("m", b)
    assert not engine.infer("t", a).plan_reuse_hit
    assert store.get_model("m") is b and store.model_catalog()["m"][
        "trees"] == b.num_trees


@pytest.mark.parametrize("algorithm", ALGORITHMS[:3])
def test_batch_pages_give_identical_results(algorithm):
    x = _rows(3)
    tf = port_forest(_forest(integer_leaves=False))
    _, engine = _port_engine(x)
    whole = engine.infer("t", tf, algorithm=algorithm)
    assert whole.scan.batches == 1
    for pages in (1, 2, 3):
        res = engine.infer("t", tf, algorithm=algorithm, batch_pages=pages)
        assert res.scan.batches == -(-5 // pages)
        assert res.scan.max_in_flight <= MAX_IN_FLIGHT
        assert torch.equal(res.predictions, whole.predictions)
    sync = engine.infer("t", tf, algorithm=algorithm, batch_pages=2,
                        prefetch_depth=1)
    assert sync.scan.max_in_flight == 1
    assert torch.equal(sync.predictions, whole.predictions)


def test_store_pads_pages_with_nan_rows_and_writes_results():
    x = _rows(4)
    store, engine = _port_engine(x)
    ds = store.get("t")
    assert ds.num_pages == 5 and ds.data.shape == (160, F)
    assert torch.isnan(ds.data[N:]).all()
    view = ds.page_slice(1, 2)                     # a view, not a copy
    assert view.shape == (64, F)
    assert view.data_ptr() == ds.data[32:].data_ptr()
    res = engine.infer("t", port_forest(_forest(integer_leaves=False)),
                       write_as="t:pred")
    out = store.get("t:pred")
    assert out.num_rows == N and torch.equal(out.data[:, 0],
                                             res.predictions)
    assert store.catalog()["t"] == dict(rows=N, features=F, pages=5,
                                        page_rows=PAGE, bytes=160 * F * 4,
                                        task="classification",
                                        format="dense", tier="device")
    assert [s.name for s in res.stage_reports] == ["stage0:write"]


def test_unported_plans_and_tiers_raise(monkeypatch):
    """``"auto"`` resolves as the reference's does (one injected peaks
    table, decisions from the model alone); unknown plans, algorithms,
    tiers and datasets raise."""
    import repro.db.optimizer as jopt
    import repro_torch.db.optimizer as topt
    from test_torch_optimizer import inject_peaks

    inject_peaks(monkeypatch)
    x = _rows(5)
    store, engine = _port_engine(x)
    jf = _forest(integer_leaves=True)
    tf = port_forest(jf)
    jstore = JStore(default_page_rows=PAGE)
    jstore.put("t", x)
    jengine = JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache())
    engine.optimizer = topt.CostBasedOptimizer(engine, uncertainty_band=1.0)
    jengine.optimizer = jopt.CostBasedOptimizer(jengine,
                                                uncertainty_band=1.0)
    for kw in (dict(plan="auto"), dict(algorithm="auto", plan="rel")):
        got, want = engine.infer("t", tf, **kw), jengine.infer("t", jf, **kw)
        assert (got.algorithm, got.plan, got.n_parts) == \
            (want.algorithm, want.plan, want.n_parts)
        assert got.decision.source == want.decision.source == "model"
        assert np.array_equal(got.predictions.numpy(),
                              np.asarray(want.predictions), equal_nan=True)
    rows = np.nan_to_num(x[:8])
    got = engine.infer_rows(tf, rows, plan="auto")
    want = jengine.infer_rows(jf, rows, plan="auto")
    assert (got.algorithm, got.plan) == (want.algorithm, want.plan)
    assert np.array_equal(got.predictions.numpy(),
                          np.asarray(want.predictions))
    with pytest.raises(ValueError, match="unknown plan"):
        engine.infer("t", tf, plan="nope")
    with pytest.raises(ValueError, match="unknown algorithm"):
        engine.infer("t", tf, algorithm="nope")
    with pytest.raises(ValueError, match="unknown tier"):
        store.put("h", x, tier="tape")
    with pytest.raises(KeyError):
        engine.infer("missing", tf)


def test_executor_batch_plan_is_deterministic():
    plan = list(StreamingScanExecutor.batch_plan(7, 3))
    assert plan == [(0, 0, 3), (1, 3, 3), (2, 6, 1)]
    with pytest.raises(ValueError):
        StreamingScanExecutor([], prefetch_depth=3)

