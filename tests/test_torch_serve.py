"""Port parity: the forest serving plane (``repro_torch.serve``) against the
reference's ``repro.serve`` on the CPU.

Every claim of the reference's ``tests/test_serve_forest.py`` is held for
the port on ``device="cpu"``, and, where both can run, against the
reference engine itself: the same requests, made with numpy from a seed,
go through ``repro.serve.forest.ForestServeEngine`` and the port's, with
the ticks driven by ``tick(now=...)`` / ``drain()`` so that timing cannot
differ.  Predictions are bitwise on XGBoost regression forests with
small-integer leaves and within rtol = atol = 1e-6 on the reference's
trained RandomForest forests (the reference's jitted mean is 1 ulp off a
division; ``tests/test_torch_algorithms.py`` pins it).  ``stats()``
counts, shed order, the model catalog, ``synth_router_trace`` and the
router's tiers equal the reference's.

Beyond the reference's claims: tenants registered and unregistered while
the ticker serves another (the engine lock), ``ForestRouter()``'s trained
default forest against the reference's, ``"auto"`` resolved as the
reference's, and the card default of ``ForestServeEngine()``.
"""

import dataclasses
import functools
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.forest import make_forest as jmake_forest
from repro.core.train import TrainConfig, train_forest
from repro.obs import METRICS as JMETRICS
from repro.serve import router as jrouter
from repro.serve.forest import ForestServeEngine as JServe
from repro_torch.core.postprocess import predict_proba
from repro_torch.db.store import TensorBlockStore
from repro_torch.obs import METRICS
from repro_torch.serve import router
from repro_torch.serve.forest import (DEFAULT_BUCKETS, ForestRequest,
                                      ForestServeEngine)
from repro_torch.serve.router import (QUEUE_DEPTH_METRIC, TIER_BATCH,
                                      TIER_INTERACTIVE, ForestRouter,
                                      live_queue_depth, request_features)

from conftest import random_forest_arrays
from test_torch_forest import port_forest

F = 6
KINDS = ("xgboost", "randomforest")
STATS_KEYS = ("requests", "ticks", "shed", "padding_rows", "plan_hits",
              "plan_misses", "pending")


@functools.lru_cache(maxsize=None)
def _forest(kind: str, seed: int, trees: int = 6, depth: int = 3):
    """A reference forest: the reference tests' trained RandomForest, or an
    XGBoost regression forest with small-integer leaves (exact sums)."""
    if kind == "randomforest":
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(256, F)).astype(np.float32)
        y = (x[:, seed % F] + x[:, (seed + 1) % F] > 0).astype(np.float32)
        return train_forest(x, y, TrainConfig(
            model_type="randomforest", num_trees=trees, max_depth=depth,
            seed=seed))
    fe, th, dl, lv = random_forest_arrays(None, T=trees, depth=depth, F=F,
                                          seed=seed)
    lv = np.random.default_rng(seed).integers(-8, 9, lv.shape).astype(
        np.float32)
    return jmake_forest(fe, th, lv, default_left=dl, n_features=F,
                        model_type="xgboost", task="regression",
                        base_score=0.5)


def _rows(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(100 + seed).normal(
        size=(n, F)).astype(np.float32)


def _port(**kw) -> ForestServeEngine:
    return ForestServeEngine(TensorBlockStore(device="cpu"), **kw)


def _pair(**kw) -> tuple[JServe, ForestServeEngine]:
    return JServe(**kw), _port(**kw)


def _register(engines, name: str, jf, **kw) -> None:
    jeng, eng = engines
    jeng.register_model(name, jf, **kw)
    eng.register_model(name, port_forest(jf), **kw)


def _same(got, want, kind: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if kind == "randomforest":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(got, want)


def _direct(eng: ForestServeEngine, model: str, x: np.ndarray) -> np.ndarray:
    """The port's direct eager predict, as the reference tests' ``_ref``."""
    return predict_proba(eng._get(model).forest, torch.from_numpy(x),
                         algorithm="predicated").numpy()


def _same_stats(engines, model: str) -> dict:
    jeng, eng = engines
    want = {k: jeng.stats(model)[k] for k in STATS_KEYS}
    got = {k: eng.stats(model)[k] for k in STATS_KEYS}
    assert got == want
    return got


def _both(engines, fn):
    """``fn(engine)`` on the reference engine, then on the port's."""
    return fn(engines[0]), fn(engines[1])


# ---------------------------------------------------------------------------
# coalescer correctness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_row_order_preserved_across_coalesce(kind):
    """Mixed-size requests coalesced into one padded tick come back in
    request-row order, equal to the reference engine's and to the port's
    direct predict."""
    engines = _pair(buckets=(8,), interactive_deadline_s=0.001)
    _register(engines, "m0", _forest(kind, 0))
    x = _rows(0, 7)
    sizes = [1, 3, 1, 2]

    def serve(eng):
        reqs, off = [], 0
        for k in sizes:
            reqs.append(eng.submit("m0", x[off:off + k]))
            off += k
        eng.drain()
        return np.concatenate([r.wait(5.0) for r in reqs])

    want, got = _both(engines, serve)
    _same(got, want, kind)
    assert np.array_equal(got, _direct(engines[1], "m0", x))
    _same_stats(engines, "m0")


@pytest.mark.parametrize("algorithm,plan", [
    ("predicated_pallas_fused", "udf"), ("quickscorer_pallas_fused", "udf"),
    ("predicated_pallas", "rel+reuse")])
def test_kernel_tenants_match_the_reference(algorithm, plan):
    """The slice as a whole: tenants on the kernel algorithms (the
    reference's in Pallas interpret mode, the port's plain versions on the
    CPU) serve the same predictions over every rung of the ladder."""
    engines = _pair(buckets=(4, 8), interactive_deadline_s=0.001)
    jf = _forest("xgboost", 5, trees=9, depth=4)
    _register(engines, "k", jf, algorithm=algorithm, plan=plan)
    x = _rows(5, 12)
    sizes = [1, 2, 3, 2, 4]

    def serve(eng):
        reqs, off = [], 0
        for k in sizes:
            reqs.append(eng.submit("k", x[off:off + k],
                                   priority=TIER_BATCH))
            off += k
        eng.drain()
        return np.concatenate([r.wait(5.0) for r in reqs])

    want, got = _both(engines, serve)
    _same(got, want, "xgboost")
    assert _same_stats(engines, "k")["ticks"] == 2      # 8 rows, then 4
    assert engines[1].models()["k"]["algorithm"] == algorithm


@pytest.mark.parametrize("kind", KINDS)
def test_padding_never_leaks(kind):
    """3 rows into an 8-bucket: exactly 3 predictions, none NaN."""
    engines = _pair(buckets=(8,))
    _register(engines, "m0", _forest(kind, 0))
    x = _rows(1, 3)

    def serve(eng):
        req = eng.submit("m0", x)
        eng.drain()
        return req.wait(5.0)

    want, got = _both(engines, serve)
    assert got.shape == (3,) and not np.isnan(got).any()
    _same(got, want, kind)
    assert _same_stats(engines, "m0")["padding_rows"] == 5


def test_steady_state_zero_plan_misses():
    """After registration warmup every tick hits a resident plan, on both
    engines, with no plan.cache_misses."""
    engines = _pair(buckets=(8,))
    _register(engines, "m0", _forest("xgboost", 0))
    st0 = engines[1].stats("m0")
    misses0 = (JMETRICS.counter("plan.cache_misses").value,
               METRICS.counter("plan.cache_misses").value)

    def serve(eng):
        reqs = [eng.submit("m0", _rows(2 + i, 1 + i % 4)) for i in range(6)]
        eng.drain()
        return np.concatenate([r.wait(5.0) for r in reqs])

    want, got = _both(engines, serve)
    _same(got, want, "xgboost")
    st1 = _same_stats(engines, "m0")
    assert st1["plan_misses"] == st0["plan_misses"] == 0
    assert st1["plan_hits"] > st0["plan_hits"]
    assert (JMETRICS.counter("plan.cache_misses").value,
            METRICS.counter("plan.cache_misses").value) == misses0


def test_oversized_request_rejected():
    engines = _pair(buckets=(8,))
    _register(engines, "m0", _forest("xgboost", 0))
    for eng in engines:
        with pytest.raises(ValueError, match="largest"):
            eng.submit("m0", _rows(9, 16))
        with pytest.raises(ValueError, match="features"):
            eng.submit("m0", np.zeros((1, F + 2), np.float32))
        with pytest.raises(KeyError, match="not registered"):
            eng.submit("nope", _rows(9, 1))


def test_deadline_flush_fires_on_lone_request():
    """A lone interactive request is flushed by the ticker at the
    interactive deadline, not held for a full bucket."""
    jf = _forest("xgboost", 0)
    eng = _port(buckets=(8,), interactive_deadline_s=0.001)
    eng.register_model("m0", port_forest(jf))
    x = _rows(10, 1)
    with eng:
        req = eng.submit("m0", x, priority=TIER_INTERACTIVE)
        out = req.wait(5.0)
    assert eng._ticker is None
    assert out.shape == (1,)
    assert req.finished_at - req.submitted_at < 1.0
    jeng = JServe(buckets=(8,))
    jeng.register_model("m0", jf)
    assert np.array_equal(out, jeng.predict("m0", x))


def test_batch_tier_waits_for_deadline():
    """TIER_BATCH work waits for a full bucket; the batch deadline bounds
    the wait of a queue that never fills one.  Both engines serve the same
    rows at the same ticks."""
    engines = _pair(buckets=(8,), batch_deadline_s=0.05)
    _register(engines, "m", _forest("xgboost", 3))

    def serve(eng):
        req = eng.submit("m", _rows(11, 2), priority=TIER_BATCH)
        # read the clock after the submit: the wait is then measured from
        # no earlier than the request's own stamp, however slow the submit
        now = time.perf_counter()
        served = [eng.tick(now=now)]
        assert not req.done.is_set()
        served.append(eng.tick(now=now + 0.051))
        assert req.done.is_set()
        reqs = [eng.submit("m", _rows(12 + i, 2), priority=TIER_BATCH)
                for i in range(4)]
        served.append(eng.tick(now=time.perf_counter()))
        assert all(r.done.is_set() for r in reqs)
        return served, np.concatenate([r.wait(1.0) for r in [req] + reqs])

    (jserved, want), (served, got) = _both(engines, serve)
    assert served == jserved == [0, 2, 8]
    _same(got, want, "xgboost")
    _same_stats(engines, "m")


@pytest.mark.parametrize("kind", KINDS)
def test_admission_timeout_sheds_to_batch_tier(kind):
    """An interactive request queued past its timeout is demoted to the
    batch tier (flagged, counted, queued at the back in the reference's
    order) instead of forcing an early flush; the batch deadline still
    bounds it."""
    engines = _pair(buckets=(8,), interactive_deadline_s=0.001,
                    batch_deadline_s=0.05)
    _register(engines, "m", _forest(kind, 4))

    def serve(eng):
        reqs = [eng.submit("m", _rows(13, 1), priority=TIER_INTERACTIVE,
                           timeout_s=0.0),
                eng.submit("m", _rows(14, 1), priority=TIER_INTERACTIVE),
                eng.submit("m", _rows(15, 2), priority=TIER_INTERACTIVE,
                           timeout_s=0.0),
                eng.submit("m", _rows(16, 1), priority=TIER_BATCH)]
        now = time.perf_counter()
        eng._shed_timed_out(eng._get("m"), now + 0.0005)
        order = [r.uid for r in eng._get("m").pending]
        shed = [(r.shed, r.priority) for r in reqs]
        eng.tick(now=now + 0.0005)      # not due: the interactive one is
        assert not any(r.done.is_set() for r in reqs)   # younger than 1 ms
        eng.tick(now=now + 0.06)        # the batch deadline bounds them
        return order, shed, np.concatenate([r.wait(1.0) for r in reqs])

    (jorder, jshed, want), (order, shed, got) = _both(engines, serve)
    assert order == jorder == [2, 4, 3, 1]
    assert shed == jshed == [(True, TIER_BATCH), (False, TIER_INTERACTIVE),
                             (True, TIER_BATCH), (False, TIER_BATCH)]
    _same(got, want, kind)
    assert _same_stats(engines, "m")["shed"] == 2


def test_queue_depth_counter_roundtrip():
    """The process-global arrival-load gauge: +1 a submit, -1 a coalesced
    admission, back to its baseline after a drain, on both packages."""
    engines = _pair(buckets=(8,))
    _register(engines, "m0", _forest("xgboost", 0))
    for eng, metrics in zip(engines, (JMETRICS, METRICS)):
        base = metrics.counter(QUEUE_DEPTH_METRIC).value
        reqs = [eng.submit("m0", _rows(20 + i, 1)) for i in range(5)]
        assert metrics.counter(QUEUE_DEPTH_METRIC).value == base + 5
        eng.drain()
        for r in reqs:
            r.wait(5.0)
        assert metrics.counter(QUEUE_DEPTH_METRIC).value == base


@pytest.mark.parametrize("kind", KINDS)
def test_predict_blocks_without_ticker(kind):
    engines = _pair(buckets=(8,))
    _register(engines, "m0", _forest(kind, 0))
    x = _rows(30, 2)
    want, got = _both(engines, lambda eng: eng.predict("m0", x))
    _same(got, want, kind)
    assert np.array_equal(got, _direct(engines[1], "m0", x))


# ---------------------------------------------------------------------------
# tenancy + LRU eviction
# ---------------------------------------------------------------------------

def test_multi_model_interleaved_traffic_never_collides():
    """Interleaved traffic over 3 tenants: every request gets ITS model's
    predictions, the same as the reference engine's."""
    engines = _pair(buckets=(8,))
    for i in range(3):
        _register(engines, f"t{i}", _forest("xgboost", 10 + i))
    x = _rows(40, 12)

    def serve(eng):
        reqs = [eng.submit(f"t{i % 3}", x[i:i + 1]) for i in range(12)]
        eng.drain()
        return [r.wait(5.0) for r in reqs]

    want, got = _both(engines, serve)
    for i in range(12):
        _same(got[i], want[i], "xgboost")
        assert np.array_equal(got[i], _direct(engines[1], f"t{i % 3}",
                                              x[i:i + 1])), i
    port = engines[1]
    assert not np.array_equal(_direct(port, "t0", x), _direct(port, "t1", x))
    for i in range(3):
        _same_stats(engines, f"t{i}")
    assert engines[1].models() == engines[0].models()


@pytest.mark.parametrize("kind", KINDS)
def test_lru_eviction_and_bit_identical_reserve(kind):
    """More tenants than the plan cache holds: the coldest model's plan
    ages out (a plan MISS on its next request), the catalog pin keeps it
    servable, and it re-serves bit for bit; both engines count alike."""
    engines = _pair(buckets=(8,), max_plans=3)
    x = _rows(50, 4)
    _register(engines, "a", _forest(kind, 20))
    first = _both(engines, lambda eng: eng.predict("a", x))
    for i in range(3):
        _register(engines, f"b{i}", _forest(kind, 21 + i))
    miss0 = (JMETRICS.counter("plan.cache_misses").value,
             METRICS.counter("plan.cache_misses").value)
    again = _both(engines, lambda eng: eng.predict("a", x))
    assert JMETRICS.counter("plan.cache_misses").value == miss0[0] + 1
    assert METRICS.counter("plan.cache_misses").value == miss0[1] + 1
    assert _same_stats(engines, "a")["plan_misses"] == 1
    assert np.array_equal(first[1], again[1])
    _same(again[1], again[0], kind)
    # warm again: the next serve is a hit
    hits = _same_stats(engines, "a")["plan_hits"]
    third = _both(engines, lambda eng: eng.predict("a", x))
    assert np.array_equal(third[1], first[1])
    assert _same_stats(engines, "a")["plan_hits"] == hits + 1


def test_unregister_then_reregister_serves_identically():
    engines = _pair(buckets=(8,))
    jf = _forest("xgboost", 30)
    _register(engines, "m", jf)
    x = _rows(60, 3)
    first = _both(engines, lambda eng: eng.predict("m", x))
    swept = _both(engines, lambda eng: eng.unregister_model("m"))
    assert swept[1] == swept[0] > 0
    for eng in engines:
        with pytest.raises(KeyError):
            eng.submit("m", x)
        with pytest.raises(KeyError):
            eng.store.get_model("m")
    assert engines[1].models() == engines[0].models() == {}
    _register(engines, "m", jf)
    again = _both(engines, lambda eng: eng.predict("m", x))
    assert np.array_equal(again[1], first[1])
    _same(again[1], again[0], "xgboost")


def _catalog(store) -> dict:
    return {n: {k: v for k, v in e.items() if k != "created_at"}
            for n, e in store.model_catalog().items()}


def test_store_model_catalog_roundtrip():
    """``register_model(warmup=False)`` pins the forest; the catalog (less
    its timestamps), fingerprints included, and ``models()`` equal the
    reference's."""
    engines = _pair(buckets=(8,))
    jf = _forest("randomforest", 31)
    _register(engines, "cat", jf, warmup=False)
    jeng, eng = engines
    assert eng.store.get_model("cat").num_trees == jf.num_trees
    cat = eng.store.model_catalog()
    assert "cat" in cat and "forest" not in cat["cat"]
    assert cat["cat"]["trees"] == jf.num_trees
    assert _catalog(eng.store) == _catalog(jeng.store)
    assert eng.models() == jeng.models()
    assert eng.models()["cat"]["algorithm"] == "predicated"


def test_register_from_catalog_and_drop_model():
    """The trainer's handoff: a forest pinned with its algorithm / plan is
    served from the catalog with those defaults; ``drop_model`` unpins
    only, and the catalogs follow the reference's at every step."""
    engines = _pair(buckets=(4, 8))
    jf = _forest("xgboost", 32)
    jeng, eng = engines
    jeng.store.put_model("pinned", jf, algorithm="predicated_pallas_fused",
                         plan="udf")
    eng.store.put_model("pinned", port_forest(jf),
                        algorithm="predicated_pallas_fused", plan="udf")
    _both(engines, lambda e: e.register_from_catalog("pinned"))
    assert eng.models() == jeng.models()
    assert eng.models()["pinned"]["algorithm"] == "predicated_pallas_fused"
    assert _catalog(eng.store) == _catalog(jeng.store)
    x = _rows(61, 3)
    want, got = _both(engines, lambda e: e.predict("pinned", x))
    _same(got, want, "xgboost")
    plans = len(eng.qe.plan_cache)
    assert _both(engines, lambda e: e.store.drop_model("pinned")) == (
        True, True)
    assert _both(engines, lambda e: e.store.drop_model("pinned")) == (
        False, False)
    assert _catalog(eng.store) == _catalog(jeng.store) == {}
    assert len(eng.qe.plan_cache) == plans == 2     # the pin only
    swept = _both(engines, lambda e: e.unregister_model("pinned"))
    assert swept[1] == swept[0] == 2
    assert eng.models() == jeng.models() == {}


def test_register_model_refuses_auto(monkeypatch):
    """``register_model(..., "auto")`` resolves as the reference engine's
    does (one injected peaks table, decisions from the model alone): the
    same cell, the same ``#rows`` decision at the largest bucket, the same
    catalogs, and requests served bit for bit."""
    import repro.db.optimizer as jopt
    import repro_torch.db.optimizer as topt
    from test_torch_optimizer import inject_peaks

    inject_peaks(monkeypatch)
    engines = _pair(buckets=(8,))
    for e, mod in zip(engines, (jopt, topt)):
        e.qe.optimizer = mod.CostBasedOptimizer(e.qe, uncertainty_band=1.0)
    jf = _forest("xgboost", 0)
    for i, kw in enumerate((dict(algorithm="auto"), dict(plan="auto"),
                            dict(algorithm="auto", plan="rel+reuse"))):
        _register(engines, f"m{i}", jf, **kw)
    jeng, eng = engines
    assert eng.models() == jeng.models()
    assert _catalog(eng.store) == _catalog(jeng.store)
    assert {k[:3] + k[4:]: v for k, v in
            eng.store.decision_catalog().items()} == \
        {k[:3] + k[4:]: v for k, v in jeng.store.decision_catalog().items()}
    assert {k[1:3] for k in eng.store.decision_catalog()} == {("#rows",
                                                               (8, F))}
    x = _rows(0, 5)
    for i in range(3):
        _same(eng.predict(f"m{i}", x), jeng.predict(f"m{i}", x), "xgboost")


def test_engine_without_a_device_is_the_card():
    """``ForestServeEngine()`` builds ``TensorBlockStore()``: the card, or
    an error without one; never a quiet CPU engine."""
    if torch.cuda.is_available():
        assert ForestServeEngine().store.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            ForestServeEngine()
    assert DEFAULT_BUCKETS == (8, 32, 128)
    assert _port().buckets == DEFAULT_BUCKETS


def test_tenants_churn_while_the_ticker_serves():
    """The engine lock: tenants registered (warmup runs ``infer_rows``),
    replaced and unregistered (``invalidate``) on this thread while the
    ticker serves another tenant's traffic, through a plan cache small
    enough to evict on every registration.  Every request comes back with
    its tenant's predictions and the ticker never fails."""
    eng = _port(buckets=(4, 8), max_plans=2, interactive_deadline_s=0.0005)
    fa = port_forest(_forest("xgboost", 40))
    eng.register_model("a", fa)
    x = _rows(70, 64)
    want = _direct(eng, "a", x)
    others = [port_forest(_forest("xgboost", 41 + i)) for i in range(3)]
    reqs: list = []
    stop = threading.Event()

    def traffic():
        i = 0
        while not stop.is_set():
            reqs.append((i % 64, eng.submit("a", x[i % 64])))
            i += 1
            time.sleep(0.0002)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    sender = threading.Thread(target=traffic)
    try:
        with eng:
            sender.start()
            for rnd in range(6):
                for j, f in enumerate(others):
                    eng.register_model(f"t{j}", f)
                eng.register_model("t0", others[(rnd + 1) % 3])  # replace
                for j in range(3):
                    assert eng.unregister_model(f"t{j}") >= 0
            stop.set()
            sender.join(timeout=10)
            assert not sender.is_alive()
            for i, r in reqs:
                assert np.array_equal(r.wait(10.0), want[i:i + 1]), i
    finally:
        stop.set()
        sys.setswitchinterval(old)
    assert eng._ticker is None and eng.last_error is None
    assert len(reqs) > 10
    assert eng.models().keys() == {"a"}
    st = eng.stats("a")
    assert st["requests"] == len(reqs) and st["pending"] == 0
    assert st["plan_misses"] > 0        # the churn evicted "a"'s plans


# ---------------------------------------------------------------------------
# router: live arrival-load feature + named tier defaults
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def routers():
    jr = jrouter.ForestRouter(seed=0)
    return jr, ForestRouter(forest=port_forest(jr.forest))


def test_router_constants_and_trace_equal_the_reference():
    assert (TIER_INTERACTIVE, TIER_BATCH, QUEUE_DEPTH_METRIC) == (
        jrouter.TIER_INTERACTIVE, jrouter.TIER_BATCH,
        jrouter.QUEUE_DEPTH_METRIC)
    assert router.FEATURES == jrouter.FEATURES
    assert router.RouterConfig() == router.RouterConfig(
        **dataclasses.asdict(jrouter.RouterConfig()))
    for n, seed in ((4096, 0), (97, 5)):
        gx, gy = router.synth_router_trace(n, seed)
        wx, wy = jrouter.synth_router_trace(n, seed)
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    assert np.array_equal(request_features(4, 2, 3.0, 1, 9.5),
                          jrouter.request_features(4, 2, 3.0, 1, 9.5))


def test_live_queue_depth_reads_metric_and_clamps():
    c = METRICS.counter(QUEUE_DEPTH_METRIC)
    old = c.value
    try:
        c.set(7)
        assert live_queue_depth() == 7.0
        assert request_features(4, 2)[2] == 7.0
        c.set(-3)          # a transient mid-reset skew must not go negative
        assert live_queue_depth() == 0.0
    finally:
        c.set(old)


def test_route_tiers_equal_the_reference(routers):
    """On a router forest carried from the reference's, every tier equals
    the reference's, one row at a time and as a batch."""
    jr, tr = routers
    x, _ = router.synth_router_trace(512, seed=3)
    assert np.array_equal(tr.route(x), jr.route(x))
    for row in x[:6]:
        got = tr.route(row)
        assert isinstance(got, int) and got == jr.route(row)


def test_routing_shifts_with_live_load(routers):
    """The same request routes interactive when the process is idle and
    batch when the live gauge reports load, as in the reference."""
    jr, tr = routers
    grid = [(plen, mnt) for plen in range(40, 520, 40)
            for mnt in range(10, 260, 25)]
    idle = np.stack([request_features(p, m, 0.0) for p, m in grid])
    busy = np.stack([request_features(p, m, 60.0) for p, m in grid])
    got = (tr.route(idle), tr.route(busy))
    assert np.array_equal(got[0], jr.route(idle))
    assert np.array_equal(got[1], jr.route(busy))
    flips = [g for g, i, b in zip(grid, *got)
             if i == TIER_INTERACTIVE and b == TIER_BATCH]
    flip = flips[0] if flips else None
    assert flip is not None, "no load-sensitive request in the grid"
    plen, mnt = flip
    c = METRICS.counter(QUEUE_DEPTH_METRIC)
    old = c.value
    try:
        c.set(0)
        assert tr.route(request_features(plen, mnt)) == TIER_INTERACTIVE
        c.set(60)
        assert tr.route(request_features(plen, mnt)) == TIER_BATCH
    finally:
        c.set(old)


def test_router_gates_unprioritized_submits(routers):
    """``priority=None`` goes through the router on both engines, with the
    same tiers."""
    jr, tr = routers
    jf = _forest("xgboost", 0)
    jeng = JServe(buckets=(8,), router=jr)
    eng = _port(buckets=(8,), router=tr)
    jeng.register_model("m", jf)
    eng.register_model("m", port_forest(jf))
    tiers = []
    for e in (jeng, eng):
        for k in (1, 8, 2):
            tiers.append(e.submit("m", _rows(80 + k, k)).priority)
        e.drain()
    assert tiers[:3] == tiers[3:]


def test_untrained_router_is_refused():
    """No longer refused: ``ForestRouter()`` trains its RandomForest on
    ``synth_router_trace``, the reference's forest bit for bit (the
    RandomForest gradients take no sigmoid), and routes as the
    reference's does."""
    jr = jrouter.ForestRouter(seed=0)
    tr = ForestRouter(device="cpu")
    for name, arr in jr.forest.arrays().items():
        got = getattr(tr.forest, name).numpy()
        assert got.dtype == np.asarray(arr).dtype, name
        assert np.array_equal(got, np.asarray(arr)), name
    x, _ = router.synth_router_trace(256, seed=5)
    assert np.array_equal(tr.route(x), jr.route(x))


def test_default_priority_is_named_batch_tier():
    from repro.serve.forest import ForestRequest as JRequest
    for cls in (ForestRequest, JRequest):
        priority = next(fl for fl in dataclasses.fields(cls)
                        if fl.name == "priority")
        assert priority.default == TIER_BATCH


# -- the mesh half --------------------------------------------------------------


def test_mesh_buckets_round_to_the_data_axis_and_serve_alike():
    """Each rung rounds up to the data axis (the reference's rule), and a
    mesh tenant serves the mesh-less tenant's predictions."""
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(4, 2, devices=["cpu"] * 8)
    eng = ForestServeEngine(TensorBlockStore(device="cpu", mesh=mesh),
                            buckets=(1, 6, 8, 30),
                            interactive_deadline_s=0.001)
    assert eng.buckets == (4, 8, 32)
    flat = _port(buckets=(4, 8, 32), interactive_deadline_s=0.001)
    jf = _forest("xgboost", 5, trees=9, depth=4)
    for e in (eng, flat):
        e.register_model("k", port_forest(jf),
                         algorithm="predicated_pallas_fused",
                         plan="rel+reuse")
    x = _rows(6, 13)

    def serve(e):
        reqs = [e.submit("k", x[i:i + 1], priority=TIER_BATCH)
                for i in range(len(x))]
        e.drain()
        return np.concatenate([r.wait(5.0) for r in reqs])

    assert np.array_equal(serve(eng), serve(flat))
