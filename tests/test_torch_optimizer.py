"""Port parity: the cost-based optimizer (``repro_torch.db.optimizer``) and
the calibration half of ``repro_torch.launch.roofline``, against the
reference's ``repro.db.optimizer`` / ``repro.launch.roofline`` on the CPU.

  * ``_forest_flop_bytes`` equal float for float for every algorithm name,
    kernel names included, over a grid of rows, trees and depth;
  * ``score_cell`` equal for every plan, tier, ``n_parts`` and
    ``batch_pages`` under one injected peaks table;
  * ``dataset_signature`` equal for dense and CSR on all three tiers;
  * with the same injected peaks and ``uncertainty_band=1.0`` (decisions
    from the model only, so deterministic): equal decisions, and ``infer`` /
    ``infer_rows`` / ``register_model`` with ``"auto"`` bit for bit the
    reference's on XGBoost and LightGBM regression forests;
  * the ``optimizer.*`` counter deltas equal over a sequence of queries and
    sweeps, an autotune pass included (counts only: its winner is timed);
  * the decision catalog equal (the mesh slot set aside: the reference's
    ``mesh_signature(None)`` is 0, the port's 1) after each sweep;
  * every test of ``tests/test_optimizer.py``, repeated against the port;
  * the CPU's calibrated peaks: measured once, positive, cached, resolved.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.db.optimizer as jopt
import repro_torch.db.optimizer as topt
from repro.core.forest import make_forest as jmake_forest
from repro.core.reuse import ModelReuseCache as JCache
from repro.core.train import TrainConfig, train_forest
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.store import TensorBlockStore as JStore
from repro.obs import METRICS as JMETRICS
from repro_torch.db.optimizer import (CUDA_ALGORITHMS, DEFAULT_ALGORITHMS,
                                      CostBasedOptimizer, Decision, _Cell,
                                      _forest_flop_bytes, dataset_signature)
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.store import TensorBlockStore
from repro_torch.launch import roofline
from repro_torch.obs import METRICS

from conftest import random_forest_arrays
from test_torch_forest import port_forest

ROOT = Path(__file__).resolve().parents[1]
F, PAGE, N = 8, 32, 150
TIERS = ("device", "host", "disk")
ALL_NAMES = (*DEFAULT_ALGORITHMS, *CUDA_ALGORITHMS, "naive", "compiled",
             "unknown")
#: one peaks table injected into both packages' optimizers
PEAKS = {"peak_flops_bf16": 8e10, "hbm_bandwidth": 2.5e10,
         "ici_bandwidth": 2.5e10, "gather_bandwidth": 6e9,
         "h2d_bandwidth": 1.2e10, "dispatch_s": 1.5e-5,
         "backend": "injected", "measured": False}
OPT_COUNTERS = ("optimizer.decisions", "optimizer.decision_cache_hits",
                "optimizer.decision_cache_misses", "optimizer.autotune_runs",
                "optimizer.measurements")


def inject_peaks(monkeypatch) -> dict:
    """Both packages' optimizers rank with ``PEAKS`` (the parity tests of
    other files use this too)."""
    for mod in (jopt, topt):
        monkeypatch.setattr(mod, "resolve_peaks", lambda *a, **k: PEAKS)
    return PEAKS


@pytest.fixture
def peaks(monkeypatch):
    return inject_peaks(monkeypatch)


def _rows(seed=0, n=N):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, F)).astype(np.float32)
    x[r.random(x.shape) < 0.1] = np.nan
    return x


def _forest(model_type="xgboost", seed=3, T=10, depth=5):
    """A regression forest with small-integer leaves: every sum exact."""
    fe, th, dl, lv = random_forest_arrays(None, T=T, depth=depth, F=F,
                                          seed=seed)
    lv = np.random.default_rng(seed).integers(-8, 9, lv.shape).astype(
        np.float32)
    return jmake_forest(fe, th, lv, default_left=dl, n_features=F,
                        model_type=model_type, task="regression",
                        base_score=0.5)


def _trained(model_type: str):
    """The reference trainer's forest, leaves rounded to 1/64 and its task
    set to regression, so that every sum is exact."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(256, F)).astype(np.float32)
    y = (x @ rng.normal(size=F).astype(np.float32) > 0).astype(np.float32)
    jf = train_forest(x, y, TrainConfig(model_type=model_type, num_trees=8,
                                        max_depth=4))
    return dataclasses.replace(
        jf, task="regression",
        leaf_value=jnp.round(jf.leaf_value * 64) / 64,
        node_value=jnp.round(jf.node_value * 64) / 64)


FORESTS = {
    "xgboost": lambda: _forest("xgboost"),
    "lightgbm": lambda: _forest("lightgbm", seed=4),
    "xgboost-trained": lambda: _trained("xgboost"),
    "lightgbm-trained": lambda: _trained("lightgbm"),
}


def _engines(x=None, *, tiers=TIERS, band=1.0, **opt_kw):
    """The reference's engine and the port's over the same rows (one
    dataset a tier, named by it), each with the same optimizer settings."""
    x = _rows() if x is None else x
    jstore = JStore(default_page_rows=PAGE)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    for s in (jstore, store):
        for tier in tiers:
            s.put(tier, x, tier=tier)
    jeng = JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache())
    eng = ForestQueryEngine(store)
    for e, cls in ((jeng, jopt.CostBasedOptimizer),
                   (eng, CostBasedOptimizer)):
        e.optimizer = cls(e, uncertainty_band=band, **opt_kw)
    return jeng, eng


def _unmeshed(catalog: dict) -> dict:
    """A decision catalog with the mesh slot (key[3]) set aside."""
    return {k[:3] + k[4:]: v for k, v in catalog.items()}


def _same_catalogs(jstore, store) -> None:
    assert _unmeshed(store.decision_catalog()) == \
        _unmeshed(jstore.decision_catalog())


def _opt_counters(metrics) -> dict:
    vals = metrics.counter_values()
    return {k: vals.get(k, 0) for k in OPT_COUNTERS}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


# -- the analytic model -------------------------------------------------------


@pytest.mark.parametrize("algorithm", ALL_NAMES)
def test_forest_flop_bytes_equal_the_reference(algorithm):
    for rows in (1, 128, 16_384, 1_000_448):
        for trees in (1, 10, 500, 1600):
            for depth in (1, 4, 5, 8, 10):
                kw = dict(rows=rows, trees=trees, depth=depth, f_used=28)
                assert _forest_flop_bytes(algorithm, **kw) == \
                    jopt._forest_flop_bytes(algorithm, **kw), kw


@pytest.mark.parametrize("plan", ["udf", "rel", "rel+reuse"])
def test_score_cell_equals_the_reference(plan):
    jeng, eng = _engines(tiers=("device",))
    kw = dict(trees=500, depth=8, f_used=28, data_nbytes=112 << 20,
              num_pages=977, page_rows=1024, peaks=PEAKS)
    for algorithm in ALL_NAMES:
        for tier in TIERS:
            for n_parts in (None, 1, 3, 100):
                for bp in (None, 1, 7, 977):
                    for rows in (128, 1_000_448):
                        cell = dict(algorithm=algorithm, plan=plan,
                                    tier=tier, n_parts=n_parts,
                                    batch_pages=bp)
                        got = eng.optimizer.score_cell(_Cell(**cell),
                                                       rows=rows, **kw)
                        want = jeng.optimizer.score_cell(
                            jopt._Cell(**cell), rows=rows, **kw)
                        assert got == want, cell


@pytest.mark.parametrize("fmt", ["dense", "csr"])
def test_dataset_signature_equals_the_reference(fmt):
    x = _rows(1)
    jstore = JStore(default_page_rows=PAGE)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    for s in (jstore, store):
        for tier in TIERS:
            if fmt == "csr":
                s.put_sparse(tier, x, tier=tier)
            else:
                s.put(tier, x, tier=tier)
    for tier in TIERS:
        got = dataset_signature(store.get(tier))
        assert got == jopt.dataset_signature(jstore.get(tier))
        assert got[2:4] == (fmt, tier)
        assert store.get(tier).nbytes == jstore.get(tier).nbytes


def test_the_candidate_set_follows_the_store_device():
    class _Stub:
        def __init__(self, device):
            self.store = type("S", (), {"device": torch.device(device)})()

    cpu, cuda = _Stub("cpu"), _Stub("cuda")
    assert CostBasedOptimizer(cpu).algorithms == DEFAULT_ALGORITHMS \
        == jopt.DEFAULT_ALGORITHMS
    assert CostBasedOptimizer(cuda).algorithms == CUDA_ALGORITHMS == (
        "predicated_pallas_fused", "hummingbird_pallas_fused",
        "quickscorer_pallas_fused", "predicated_pallas",
        "hummingbird_pallas", "quickscorer_pallas")
    assert CostBasedOptimizer(cuda, algorithms=("predicated",)).algorithms \
        == ("predicated",)
    assert topt.DEFAULT_PLANS == jopt.DEFAULT_PLANS
    assert topt.ROW_DECISION_DATASET == jopt.ROW_DECISION_DATASET


# -- decisions and predictions against the reference --------------------------


AXES = [("auto", "auto"), ("auto", "rel+reuse"), ("hummingbird", "auto"),
        ("quickscorer", "auto"), ("auto", "rel")]


@pytest.mark.parametrize("kind", FORESTS)
@pytest.mark.parametrize("tier", TIERS)
def test_auto_infer_matches_the_reference(kind, tier, peaks):
    jeng, eng = _engines()
    jf = FORESTS[kind]()
    tf = port_forest(jf)
    for algorithm, plan in AXES:
        want = jeng.infer(tier, jf, algorithm=algorithm, plan=plan)
        got = eng.infer(tier, tf, algorithm=algorithm, plan=plan)
        assert dataclasses.asdict(got.decision) == \
            dataclasses.asdict(want.decision), (algorithm, plan)
        assert got.decision.source == "model"
        assert (got.algorithm, got.plan, got.n_parts, got.tier) == \
            (want.algorithm, want.plan, want.n_parts, want.tier)
        assert np.array_equal(got.predictions.numpy(),
                              np.asarray(want.predictions), equal_nan=True)
    _same_catalogs(jeng.store, eng.store)
    assert len(eng.store.decision_catalog()) == len(AXES)


@pytest.mark.parametrize("kind", ["xgboost", "lightgbm"])
def test_auto_move_matches_the_reference(kind, peaks):
    jeng, eng = _engines(tiers=("host", "disk"))
    jf = FORESTS[kind]()
    tf = port_forest(jf)
    for tier in ("host", "disk"):
        static = eng.infer(tier, tf, algorithm="predicated")
        want = jeng.infer(tier, jf, plan="auto", algorithm="auto",
                          auto_move=True)
        got = eng.infer(tier, tf, plan="auto", algorithm="auto",
                        auto_move=True)
        assert got.tier == want.tier == "device"
        assert eng.store.get(tier).tier == "device"
        assert dataclasses.asdict(got.decision) == \
            dataclasses.asdict(want.decision)
        assert np.array_equal(got.predictions.numpy(),
                              np.asarray(want.predictions), equal_nan=True)
        assert torch.equal(got.predictions, static.predictions)
    # two decisions a table: under the old tier's signature, then the new
    _same_catalogs(jeng.store, eng.store)
    assert len(eng.store.decision_catalog()) == 4


@pytest.mark.parametrize("kind", FORESTS)
def test_auto_infer_rows_and_register_model_match_the_reference(kind,
                                                                peaks):
    from repro.serve.forest import ForestServeEngine as JServe
    from repro_torch.serve.forest import ForestServeEngine

    jf = FORESTS[kind]()
    tf = port_forest(jf)
    jeng, eng = _engines(tiers=())
    x = np.nan_to_num(_rows(2, 16))
    for algorithm, plan in AXES[:4]:
        want = jeng.infer_rows(jf, x, algorithm=algorithm, plan=plan)
        got = eng.infer_rows(tf, x, algorithm=algorithm, plan=plan)
        assert (got.algorithm, got.plan) == (want.algorithm, want.plan)
        assert np.array_equal(got.predictions.numpy(),
                              np.asarray(want.predictions))
    _same_catalogs(jeng.store, eng.store)
    jserve = JServe(JStore(default_page_rows=PAGE), buckets=(8, 32))
    serve = ForestServeEngine(TensorBlockStore(device="cpu"), buckets=(8, 32))
    for s, cls in ((jserve, jopt.CostBasedOptimizer),
                   (serve, CostBasedOptimizer)):
        s.qe.optimizer = cls(s.qe, uncertainty_band=1.0)
    jm = jserve.register_model("m", jf, algorithm="auto", plan="auto")
    m = serve.register_model("m", tf, algorithm="auto", plan="auto")
    assert (m.algorithm, m.plan, m.model_id) == \
        (jm.algorithm, jm.plan, jm.model_id)
    _same_catalogs(jserve.store, serve.store)
    assert next(iter(serve.store.decision_catalog()))[1:3] == ("#rows",
                                                               (32, F))
    assert np.array_equal(serve.predict("m", x[:5]),
                          np.asarray(jserve.predict("m", x[:5])))


def test_autotune_counters_match_the_reference(peaks):
    """An autotune pass on both sides (band 16, no hillclimb, a budget no
    probe exhausts): the optimizer's counter deltas are equal step by step
    through queries, repeats and sweeps."""
    jeng, eng = _engines(tiers=("device", "host"), band=16.0,
                         hillclimb=False, measure_budget_s=600.0,
                         max_measurements=6, probe_iters=1)
    jf = _forest()
    tf = port_forest(jf)
    x = np.nan_to_num(_rows(3, 16))
    steps = [
        lambda e, f: e.infer("device", f, plan="auto", algorithm="auto"),
        lambda e, f: e.infer("device", f, plan="auto", algorithm="auto"),
        lambda e, f: e.infer("host", f, plan="auto", algorithm="auto"),
        lambda e, f: e.infer_rows(f, x, plan="auto", algorithm="auto"),
        lambda e, f: e.infer_rows(f, x, plan="auto", algorithm="auto"),
        lambda e, f: e.infer("device", f, plan="rel+reuse",
                             algorithm="auto"),
        lambda e, f: e.store.drop("device"),
        lambda e, f: e.infer("host", f, plan="auto", algorithm="auto"),
        lambda e, f: e.invalidate(e._model_key(f, None)),
        lambda e, f: e.infer("host", f, plan="auto", algorithm="auto"),
        lambda e, f: e.infer_rows(f, x, plan="auto", algorithm="auto"),
    ]
    autotuned = 0
    for i, step in enumerate(steps):
        jb, b = _opt_counters(JMETRICS), _opt_counters(METRICS)
        step(jeng, jf)
        step(eng, tf)
        got = _delta(_opt_counters(METRICS), b)
        assert got == _delta(_opt_counters(JMETRICS), jb), i
        autotuned += got["optimizer.autotune_runs"]
        assert set(_unmeshed(eng.store.decision_catalog())) == \
            set(_unmeshed(jeng.store.decision_catalog())), i
    assert autotuned >= 4
    for d in eng.store.decision_catalog().values():
        assert d["source"] == "measured" and d["cells_measured"] >= 2


# -- the sweeps ---------------------------------------------------------------


def _sweep_script(store, engine, forest, x):
    """Decisions on two datasets and a row batch, then the eight sweeps;
    yields after each so that both catalogs are compared there."""
    def decide_all():
        for name in ("a", "b"):
            engine.infer(name, forest, plan="auto", algorithm="auto")
        engine.infer_rows(forest, np.nan_to_num(x[:8]), plan="auto",
                          algorithm="auto")

    mid = engine._model_key(forest, None)
    store.put("a", x)
    store.put_sparse("b", x, tier="host")
    decide_all()
    yield "decided"
    store.drop("a")
    yield "drop"
    store.put("a", x)
    decide_all()
    store.put("a", x[:64])
    yield "re-put"
    store.put_sparse("b", x[:64], tier="host")
    yield "re-put_sparse"
    decide_all()
    w = store.stream_writer("a", num_rows=32, num_features=F)
    yield "stream_writer"
    w.write(x[:32])
    w.close()
    decide_all()
    store.put_model("m", forest)
    store.put_model("m", dataclasses.replace(forest, base_score=0.25))
    yield "put_model"
    decide_all()
    engine.invalidate(mid)
    yield "invalidate(model)"
    decide_all()
    engine.invalidate_dataset("b")
    yield "invalidate_dataset"
    engine.invalidate()
    yield "invalidate()"


def test_every_sweep_leaves_the_reference_catalog(peaks):
    x = _rows(4)
    jf = _forest()
    jstore = JStore(default_page_rows=PAGE)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    jeng = JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache())
    eng = ForestQueryEngine(store)
    for e, cls in ((jeng, jopt.CostBasedOptimizer),
                   (eng, CostBasedOptimizer)):
        e.optimizer = cls(e, uncertainty_band=1.0)
    sizes = []
    for (jstep, step) in zip(_sweep_script(jstore, jeng, jf, x),
                             _sweep_script(store, eng, port_forest(jf), x)):
        assert step == jstep
        _same_catalogs(jstore, store)
        sizes.append(len(store.decision_catalog()))
    assert sizes == [3, 2, 2, 1, 2, 0, 0, 2, 0]


# -- tests/test_optimizer.py, repeated against the port -----------------------


def _counter(name: str) -> int:
    return METRICS.counter_values().get(name, 0)


def _tight(engine) -> CostBasedOptimizer:
    """Test-sized budgets: tiny probes, no minutes-long autotunes."""
    opt = CostBasedOptimizer(engine, measure_budget_s=2.0,
                             max_measurements=6, probe_iters=1)
    engine.optimizer = opt
    return opt


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    w = rng.normal(size=8).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    jf = train_forest(x, y, TrainConfig(model_type="xgboost", num_trees=12,
                                        max_depth=4))
    return port_forest(jf), x


def _store(x) -> TensorBlockStore:
    store = TensorBlockStore(device="cpu", default_page_rows=64)
    store.put("ds", x)
    return store


def test_auto_matches_static_bit_identically(setup):
    forest, x = setup
    engine = ForestQueryEngine(_store(x))
    _tight(engine)
    res = engine.infer("ds", forest, plan="auto", algorithm="auto")
    assert res.decision is not None
    assert res.algorithm in DEFAULT_ALGORITHMS
    assert res.plan in ("udf", "rel+reuse")
    static = engine.infer("ds", forest, plan=res.plan,
                          algorithm=res.algorithm, n_parts=res.n_parts)
    assert torch.equal(res.predictions, static.predictions)


def test_repeat_auto_is_a_lookup_not_an_autotune(setup):
    forest, x = setup
    engine = ForestQueryEngine(_store(x))
    _tight(engine)
    first = engine.infer("ds", forest, plan="auto", algorithm="auto")
    runs0, hits0 = _counter("optimizer.autotune_runs"), \
        _counter("optimizer.decision_cache_hits")
    again = engine.infer("ds", forest, plan="auto", algorithm="auto")
    assert _counter("optimizer.autotune_runs") == runs0     # zero re-runs
    assert _counter("optimizer.decision_cache_hits") == hits0 + 1
    assert again.decision == first.decision
    assert (again.algorithm, again.plan) == (first.algorithm, first.plan)


def test_pinned_axis_constrains_the_decision(setup):
    forest, x = setup
    engine = ForestQueryEngine(_store(x))
    _tight(engine)
    res = engine.infer("ds", forest, plan="rel+reuse", algorithm="auto")
    assert res.plan == "rel+reuse"
    assert res.algorithm in DEFAULT_ALGORITHMS
    res2 = engine.infer("ds", forest, plan="auto", algorithm="hummingbird")
    assert res2.algorithm == "hummingbird"
    assert res2.plan in ("udf", "rel+reuse")


def test_decision_persists_in_store_catalog(setup):
    forest, x = setup
    store = _store(x)
    engine = ForestQueryEngine(store)
    _tight(engine)
    engine.infer("ds", forest, plan="auto", algorithm="auto")
    cat = store.decision_catalog()
    assert len(cat) == 1
    (key, entry), = cat.items()
    assert key[0] == engine._model_key(forest, None)     # fingerprint
    assert key[1] == "ds"                                # dataset name
    assert key[2] == dataset_signature(store.get("ds"))
    assert key[3] == engine.mesh_id == 1
    assert entry["source"] in ("measured", "model")
    assert entry["plan"] in ("udf", "rel+reuse")


def test_invalidate_model_sweeps_decisions(setup):
    forest, x = setup
    store = _store(x)
    engine = ForestQueryEngine(store)
    _tight(engine)
    engine.infer("ds", forest, plan="auto", algorithm="auto")
    assert len(store.decision_catalog()) == 1
    swept = engine.invalidate(engine._model_key(forest, None))
    assert swept >= 1                       # plans + the decision
    assert store.decision_catalog() == {}
    misses0 = _counter("optimizer.decision_cache_misses")
    engine.infer("ds", forest, plan="auto", algorithm="auto")
    assert _counter("optimizer.decision_cache_misses") == misses0 + 1


def test_store_drop_sweeps_decisions(setup):
    forest, x = setup
    store = _store(x)
    engine = ForestQueryEngine(store)
    _tight(engine)
    engine.infer("ds", forest, plan="auto", algorithm="auto")
    assert len(store.decision_catalog()) == 1
    assert store.drop("ds") >= 1
    assert store.decision_catalog() == {}


def test_invalidate_dataset_sweeps_decisions(setup):
    forest, x = setup
    store = _store(x)
    engine = ForestQueryEngine(store)
    _tight(engine)
    engine.infer("ds", forest, plan="auto", algorithm="auto")
    assert engine.invalidate_dataset("ds") >= 1
    assert store.decision_catalog() == {}


def test_stale_decision_swept_after_re_put(setup):
    forest, x = setup
    store = _store(x)
    engine = ForestQueryEngine(store)
    _tight(engine)
    engine.infer("ds", forest, plan="auto", algorithm="auto")
    assert len(store.decision_catalog()) == 1
    store.put("ds", x[:128])                 # reshaped re-put
    assert store.decision_catalog() == {}
    misses0 = _counter("optimizer.decision_cache_misses")
    engine.infer("ds", forest, plan="auto", algorithm="auto")
    assert _counter("optimizer.decision_cache_misses") == misses0 + 1


def test_signature_conditions_on_tier_and_shape(setup):
    forest, x = setup
    store = _store(x)
    sig = dataset_signature(store.get("ds"))
    assert sig[3] == "device"
    store.move("ds", "host")
    assert dataset_signature(store.get("ds"))[3] == "host"
    assert dataset_signature(store.get("ds")) != sig


def test_cost_model_ranks_the_paper_asymptotics():
    kw = dict(rows=4096, trees=100, depth=8, f_used=32)
    hb_flops = _forest_flop_bytes("hummingbird", **kw)[0]
    qs_flops = _forest_flop_bytes("quickscorer", **kw)[0]
    pr_flops = _forest_flop_bytes("predicated", **kw)[0]
    assert hb_flops > qs_flops > pr_flops
    f2 = _forest_flop_bytes("predicated", rows=8192, trees=100, depth=8,
                            f_used=32)[0]
    assert f2 == pytest.approx(2 * pr_flops, rel=0.01)


def test_score_cell_orders_by_work(setup):
    forest, x = setup
    engine = ForestQueryEngine(_store(x))
    opt = _tight(engine)
    peaks = roofline.resolve_peaks(engine.store.device)
    kw = dict(trees=100, depth=8, f_used=32, data_nbytes=1 << 20,
              num_pages=16, page_rows=256, peaks=peaks)
    small = opt.score_cell(_Cell("predicated", "udf", "device"),
                           rows=1024, **kw)
    big = opt.score_cell(_Cell("predicated", "udf", "device"),
                         rows=65536, **kw)
    assert 0 < small < big
    host = opt.score_cell(_Cell("predicated", "udf", "host"),
                          rows=1024, **kw)
    assert host > small


def test_calibrated_peaks_measured_once_and_positive():
    p1 = roofline.calibrate_peaks("cpu")
    assert p1["measured"] is True and p1["backend"] == "cpu"
    for k in ("peak_flops_bf16", "hbm_bandwidth", "ici_bandwidth",
              "gather_bandwidth", "h2d_bandwidth", "dispatch_s"):
        assert p1[k] > 0
    assert roofline.calibrate_peaks("cpu") is p1          # cached
    assert roofline.calibrate_peaks(torch.device("cpu")) is p1
    assert roofline.resolve_peaks("cpu") is p1
    assert not roofline.h2d_source("cpu").is_pinned()
    # no default peak: every caller names its table
    with pytest.raises(TypeError):
        roofline.roofline_terms(flops_per_chip=1.0, bytes_per_chip=1.0,
                                coll_bytes_per_chip=0.0)
    terms = roofline.roofline_terms(
        flops_per_chip=p1["peak_flops_bf16"], bytes_per_chip=1.0,
        coll_bytes_per_chip=0.0, peak=p1)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["dominant"] == "compute_s"


def test_roofline_terms_equal_the_reference():
    from repro.launch.roofline import roofline_terms as jterms
    for flops, nbytes, coll in ((1e12, 1e9, 0.0), (1.0, 1e12, 5e8),
                                (0.0, 0.0, 1e10)):
        kw = dict(flops_per_chip=flops, bytes_per_chip=nbytes,
                  coll_bytes_per_chip=coll)
        assert roofline.roofline_terms(**kw, peak=PEAKS) == \
            jterms(**kw, peak=PEAKS)


def test_serve_register_model_resolves_auto(setup):
    from repro_torch.serve.forest import ForestServeEngine
    forest, x = setup
    se = ForestServeEngine(TensorBlockStore(device="cpu"), buckets=(8, 32))
    _tight(se.qe)
    m = se.register_model("m", forest, algorithm="auto", plan="auto")
    assert m.algorithm in DEFAULT_ALGORITHMS
    assert m.plan in ("udf", "rel+reuse")
    cat = se.store.decision_catalog()
    assert len(cat) == 1
    (key, _), = cat.items()
    assert key[1] == "#rows"
    assert se.store.drop_decisions(dataset="ds") == 0
    assert se.qe.invalidate(m.model_id) >= 1
    assert se.store.decision_catalog() == {}


def test_infer_rows_auto_routes_through_row_decision(setup):
    forest, x = setup
    engine = ForestQueryEngine(_store(x))
    _tight(engine)
    batch = np.zeros((16, forest.n_features), np.float32)
    res = engine.infer_rows(forest, batch, algorithm="auto", plan="auto")
    assert res.algorithm in DEFAULT_ALGORITHMS
    assert res.plan in ("udf", "rel+reuse")
    runs0 = _counter("optimizer.autotune_runs")
    engine.infer_rows(forest, batch, algorithm="auto", plan="auto")
    assert _counter("optimizer.autotune_runs") == runs0


def test_launch_import_is_side_effect_free():
    """Importing the calibration module measures nothing (the table is
    made at the first decision) and sets no environment."""
    code = ("import os; env = dict(os.environ); "
            "import repro_torch.launch.roofline as r; "
            "assert r._CALIBRATED == {}; assert dict(os.environ) == env")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr


def test_decision_overrides_round_trip():
    d = Decision(algorithm="quickscorer", plan="rel+reuse", tier="device",
                 n_parts=3, batch_pages=None, predicted_s=1e-3,
                 measured_s=None, source="model")
    assert d.overrides() == dict(algorithm="quickscorer",
                                 plan="rel+reuse", n_parts=3,
                                 batch_pages=None)
    assert dataclasses.asdict(d) == dataclasses.asdict(jopt.Decision(
        **dataclasses.asdict(d)))


# -- the mesh half --------------------------------------------------------------


def _mesh_store(x, shape=(2, 4)) -> TensorBlockStore:
    from repro_torch.launch.mesh import make_local_mesh
    store = TensorBlockStore(device="cpu", default_page_rows=64,
                             mesh=make_local_mesh(*shape,
                                                  devices=["cpu"] * 8))
    store.put("ds", x)
    return store


@pytest.mark.parametrize("plan", ["udf", "rel", "rel+reuse"])
def test_mesh_score_cell_adds_the_reference_collective_term(plan):
    """On a model mesh rel cells pay ``4 * rows`` collective bytes, as the
    reference's do (its engine given a model-axis plan)."""
    from repro.dist.sharding import ForestShardingPlan as JPlan
    jeng, _ = _engines(tiers=("device",))
    jeng.fplan = JPlan(mesh=None, data_axis="data", model_axis="model",
                       n_data=2, n_model=4)
    eng = ForestQueryEngine(_mesh_store(_rows()))
    flat = ForestQueryEngine(_store(_rows()))
    kw = dict(trees=500, depth=8, f_used=28, data_nbytes=112 << 20,
              num_pages=977, page_rows=1024, peaks=PEAKS, rows=1_000_448)
    for algorithm in ALL_NAMES:
        cell = dict(algorithm=algorithm, plan=plan, tier="device",
                    n_parts=4, batch_pages=None)
        got = eng.optimizer.score_cell(_Cell(**cell), **kw)
        assert got == jeng.optimizer.score_cell(jopt._Cell(**cell), **kw)
        meshless = flat.optimizer.score_cell(_Cell(**cell), **kw)
        assert got >= meshless
        assert got == meshless or plan.startswith("rel")


def test_mesh_auto_fixes_n_parts_and_keys_by_mesh(setup):
    from repro_torch.core.reuse import mesh_signature
    forest, x = setup
    store = _mesh_store(x)
    engine = ForestQueryEngine(store)
    _tight(engine)
    res = engine.infer("ds", forest, plan="rel+reuse", algorithm="auto")
    assert res.n_parts == 4 and res.decision.n_parts == 4
    static = engine.infer("ds", forest, plan="rel+reuse",
                          algorithm=res.algorithm)
    assert torch.equal(res.predictions, static.predictions)
    flat = ForestQueryEngine(_store(x)).infer(
        "ds", forest, plan="rel+reuse", algorithm=res.algorithm, n_parts=4)
    assert torch.equal(res.predictions, flat.predictions)
    (key,) = store.decision_catalog()
    assert key[3] == mesh_signature(store.mesh) != 1
    rows = engine.infer_rows(forest, x[:64], plan="auto", algorithm="auto")
    assert rows.plan != "rel+reuse" or \
        engine.optimizer.decide_rows(forest, 64).n_parts == 4
