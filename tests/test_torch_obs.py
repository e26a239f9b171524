"""Port parity: the observability plane (``repro_torch.obs``) and its spans
and counters through the store, the scan, the stages, the query and the
loaders.

Both packages run in one process, on the CPU (the reference as its own
``tests/test_obs.py`` runs it, with the fused kernel in interpret mode),
and each package's ``TRACER`` and ``METRICS`` are reset around every test.

  * the metrics primitives give the reference's values, percentiles and
    snapshots on one operation script;
  * the tracer: ``NULL_SPAN`` when disabled, nesting, cross-thread
    parenting that survives the parent's close, orphan events, and an
    ``export_chrome`` of the reference's structure; the port's device
    spans get a lane of their own;
  * for udf and rel+reuse x {device, host, disk} x {dense, CSR}, a query's
    ``TraceSummary`` span counts, event counts and counter deltas equal the
    reference's, a repeat's too, and tracing changes no prediction;
  * the store's and the loaders' spans and counters match the reference's
    on the same calls and files;
  * the catalog: the port's names are the reference's minus exactly the
    pending set below, and ``docs/torch_observability.md`` lists each.
"""

import json
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.reuse import ModelReuseCache as JCache
from repro.db import loader as jloader
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.store import TensorBlockStore as JStore
from repro.obs import METRICS as JMETRICS
from repro.obs import TRACER as JTRACER
from repro.obs import Counter as JCounter
from repro.obs import Histogram as JHistogram
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.obs import names as jnames
from repro_torch.db import loader
from repro_torch.core.reuse import ModelReuseCache
from repro_torch.db.executor import StreamingScanExecutor
from repro_torch.db.operators import Operator, split_into_stages
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.store import TensorBlockStore
from repro_torch.obs import (METRICS, NULL_SPAN, TRACER, Counter, Histogram,
                             MetricsRegistry, Tracer, names)

from test_torch_forest import port_forest
from test_torch_query import PAGE, _forest, _rows

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import validate_chrome_trace  # noqa: E402
FUSED = "predicated_pallas_fused"
TIERS = ("device", "host", "disk")

#: the reference's names the port does not emit yet, each with the ROADMAP
#: queue 1 item (or "Work left" entry) that brings it
PENDING = {
    # the port has no tracing compiler: plan.traces returns as the count of
    # the serving plane's CUDA-graph captures
    "plan.traces": "work left: CUDA graphs",
}


@pytest.fixture(autouse=True)
def _clean_planes():
    """Every test starts and ends with both tracers disarmed and empty and
    both registries zeroed."""
    for tracer, metrics in ((TRACER, METRICS), (JTRACER, JMETRICS)):
        tracer.disable()
        tracer.reset()
        metrics.reset()
    yield
    for tracer, metrics in ((TRACER, METRICS), (JTRACER, JMETRICS)):
        tracer.disable()
        tracer.reset()
        metrics.reset()


def _traced(tracer, fn):
    tracer.reset()
    tracer.enable()
    try:
        return fn()
    finally:
        tracer.disable()


def _catalog(mod) -> set[str]:
    return set(mod.SPAN_NAMES) | set(mod.EVENT_NAMES) | set(mod.METRIC_NAMES)


def _assert_cataloged(spans, counters=()) -> None:
    """Every span, event and counter the port emitted is in its catalog."""
    for s in spans:
        assert (s.name in names.SPAN_NAMES
                or s.name.startswith(names.SPAN_PREFIXES)), s.name
        for ev in s.events:
            assert ev.name in names.EVENT_NAMES, ev.name
    for c in counters:
        assert c in names.METRIC_NAMES, c


# -- metrics ------------------------------------------------------------------


def _metrics_script(counter_cls, hist_cls, registry_cls):
    """One operation script over a package's three metric classes; returns
    everything it can read back."""
    c = counter_cls("c")
    c.inc()
    c.inc(4)
    c.inc(0.5)
    h = hist_cls("h", bounds=(0.001, 0.01, 0.1, 1.0))
    empty = h.summary()
    for v in (0.002, 0.003, 0.004, 0.05, 0.5, 7.0, 0.0005, 0.01):
        h.record(v)
    pct = [h.percentile(q) for q in (0, 1, 25, 50, 75, 90, 99, 100)]
    d = hist_cls("d")                      # the default latency bounds
    for v in np.random.default_rng(0).lognormal(-6, 2, 200):
        d.record(v)
    reg = registry_cls()
    r1 = reg.counter("a")
    r1.inc(3)
    same = reg.counter("a") is r1
    reg.histogram("lat").record(0.25)
    reg.histogram("lat", bounds=(1.0,)).record(0.75)   # get: bounds kept
    snap = reg.snapshot()
    vals = reg.counter_values()
    reg.reset()
    kept = (reg.counter("a") is r1 and r1.value == 0
            and reg.histogram("lat").count == 0)
    c.reset()
    return dict(c=c.value, empty=empty, counts=h.counts, pct=pct,
                summary=h.summary(), mean=h.mean, d=d.summary(),
                d_counts=d.counts, bounds=d.bounds, same=same, snap=snap,
                vals=vals, kept=kept, after=reg.snapshot())


def test_metrics_match_the_reference_on_one_script():
    got = _metrics_script(Counter, Histogram, MetricsRegistry)
    want = _metrics_script(JCounter, JHistogram, JRegistry)
    assert got == want
    assert got["same"] and got["kept"] and got["c"] == 0
    assert np.isnan(Histogram("e").percentile(50))
    with pytest.raises(ValueError, match="at least one bucket"):
        Histogram("e", bounds=())


def _counter_set_script(counter_cls):
    c = counter_cls("g")
    seen = []
    for op, v in (("set", 7), ("inc", 2), ("set", -3), ("inc", 0.5),
                  ("set", 0), ("inc", -1), ("reset", None), ("set", 2.25)):
        getattr(c, op)(*(() if v is None else (v,)))
        seen.append(c.value)
    return seen


def test_counter_set_matches_the_reference():
    """``Counter.set`` overwrites the value under the counter's lock, as
    the reference's does (the serving plane's gauge is set directly)."""
    assert _counter_set_script(Counter) == _counter_set_script(JCounter) \
        == [7, 9, -3, -2.5, 0, -1, 0, 2.25]
    c = Counter("g")
    threads = [threading.Thread(target=lambda: [c.inc() for _ in
                                                range(2000)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 8000
    c.set(5)
    assert c.value == 5


# -- the tracer ---------------------------------------------------------------


def test_disabled_tracer_returns_the_null_span_singleton():
    assert not TRACER.enabled
    s1, s2 = TRACER.span("anything", attr=1), TRACER.span("else")
    assert s1 is NULL_SPAN and s2 is NULL_SPAN     # no allocation
    with s1 as s:
        s.set(x=1).event("noop")
        assert s.duration_s == 0.0
    TRACER.event("orphan")
    assert TRACER._device_span("d", None, 0, 1, "cuda:drain") is None
    assert TRACER.finished() == []
    assert TRACER.export_chrome()["traceEvents"][-1]["ph"] == "M"


def test_span_nesting_attrs_and_summary():
    TRACER.enable()
    with TRACER.span("root", kind="test") as root:
        with TRACER.span("child") as child:
            TRACER.event("ping", n=1)
        with TRACER.span("child"):
            pass
        root.set(late=True)
    assert child.parent_id == root.span_id and root.parent_id is None
    assert root.attrs == {"kind": "test", "late": True}
    summ = TRACER.summarize(root)
    assert summ.num_spans == 3
    assert summ.span_counts == {"root": 1, "child": 2}
    assert summ.event_counts == {"ping": 1}
    assert summ.phase("child") <= summ.wall_s and summ.phase("x") == 0.0


def test_cross_thread_parenting_survives_parent_close():
    TRACER.enable()
    with TRACER.span("query") as root:
        with TRACER.span("batch") as batch:
            pass

    def worker():
        with TRACER.span("read", parent=batch):
            pass

    t = threading.Thread(target=worker, name="scan-reader")
    t.start()
    t.join(10)
    assert not t.is_alive()
    read = next(s for s in TRACER.finished() if s.name == "read")
    assert read.parent_id == batch.span_id and read.tid != batch.tid
    summ = TRACER.summarize(root)
    assert summ.num_spans == 3 and summ.span_counts["read"] == 1
    shape = validate_chrome_trace(TRACER.export_chrome())
    assert shape["cross_thread"] == 1 and shape["threads"] == 2


def test_null_parent_means_no_parent_and_orphan_events_export():
    parent = TRACER.span("captured-disabled")          # NULL_SPAN
    TRACER.enable()
    with TRACER.span("child", parent=parent) as ch:
        pass
    assert ch.parent_id is None
    TRACER.event("free-standing", why="no open span")
    inst = [e for e in TRACER.export_chrome()["traceEvents"]
            if e["ph"] == "i"]
    assert [e["name"] for e in inst] == ["free-standing"]


def _span_script(tracer):
    """The same spans, events and threads on a package's fresh tracer."""
    tracer.enable()
    with tracer.span("query", plan="udf") as root:
        with tracer.span("batch", index=0) as batch:
            tracer.event("plan.cache", hit=False)
            with tracer.span("compute"):
                pass
        root.set(tier="host", obj=object())

    def worker():
        with tracer.span("write", parent=batch, first_page=0):
            pass

    t = threading.Thread(target=worker, name="worker")
    t.start()
    t.join(10)
    tracer.event("orphan", n=2)
    return tracer.export_chrome()


def _normalised(payload: dict) -> list[dict]:
    out = []
    for ev in json.loads(json.dumps(payload))["traceEvents"]:
        ev.pop("ts", None)
        ev.pop("dur", None)
        if ev["name"] == "query":       # object() reprs carry an address
            ev["args"]["obj"] = "<object>"
        out.append(ev)
    return out


def test_export_chrome_has_the_reference_structure(tmp_path):
    got = _span_script(Tracer())
    want = _span_script(JTracer())
    assert _normalised(got) == _normalised(want)
    out = tmp_path / "trace.json"
    tracer = Tracer()
    payload = _span_script(tracer)
    assert tracer.export_chrome(str(out)) == payload
    assert json.loads(out.read_text()) == json.loads(json.dumps(payload))


def test_device_spans_get_their_own_lane_and_join_the_summary():
    TRACER.enable()
    with TRACER.span("scan.execute") as root:
        with TRACER.span("scan.batch") as batch:
            t0 = root.start_ns
        TRACER._device_span("scan.drain_write", batch, t0 + 1000, t0 + 5000,
                            "cuda:drain", first_page=0, num_pages=1)
        TRACER._device_span("scan.drain_write", NULL_SPAN, t0, t0 + 1,
                            "cuda:drain")
    dev = [s for s in TRACER.finished() if s.name == "scan.drain_write"]
    assert dev[0].parent_id == batch.span_id and dev[1].parent_id is None
    assert dev[0].duration_s == 4e-6 and dev[0].track == "cuda:drain"
    assert dev[0] not in TRACER._stack()
    summ = TRACER.summarize(root)
    assert summ.span_counts == {"scan.execute": 1, "scan.batch": 1,
                                "scan.drain_write": 1}
    assert summ.phase("scan.drain_write") == 4e-6
    payload = TRACER.export_chrome()
    lanes = {e["args"]["name"]: e["tid"] for e in payload["traceEvents"]
             if e["name"] == "thread_name"}
    assert set(lanes) == {"MainThread", "cuda:drain"}
    writes = [e for e in payload["traceEvents"]
              if e["name"] == "scan.drain_write"]
    assert {e["tid"] for e in writes} == {lanes["cuda:drain"]}
    assert writes[0]["dur"] == 4.0 and writes[0]["ts"] == pytest.approx(
        (t0 + 1000 - TRACER._epoch_ns) / 1e3)
    assert validate_chrome_trace(payload)["cross_thread"] == 1


# -- the query ----------------------------------------------------------------


def _stores(x, fmt: str):
    jstore = JStore(default_page_rows=PAGE)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    for tier in TIERS:
        for s in (jstore, store):
            if fmt == "csr":
                s.put_sparse(tier, x, tier=tier)
            else:
                s.put(tier, x, tier=tier)
    return (JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache()),
            ForestQueryEngine(store, reuse_cache=ModelReuseCache(),
                              plan_cache=ModelReuseCache()))


@pytest.fixture(scope="module")
def engines():
    x = _rows(5)
    jf = _forest(integer_leaves=True)
    return {fmt: _stores(x, fmt) for fmt in ("dense", "csr")}, jf


def _ref_counters(summary) -> dict:
    """The reference's counter deltas without the pending names."""
    out = {k: v for k, v in summary.counters.items() if k not in PENDING}
    assert set(summary.counters) - set(out) <= {"plan.traces"}
    return out


@pytest.mark.parametrize("fmt", ["dense", "csr"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("plan", ["udf", "rel+reuse"])
def test_query_trace_matches_the_reference(engines, plan, tier, fmt):
    (jengine, engine), jf = engines[0][fmt], engines[1]
    tf = port_forest(jf)
    kw = dict(algorithm=FUSED, plan=plan, batch_pages=2, n_parts=3)
    results = []
    for run in ("first", "repeat"):
        want = _traced(JTRACER, lambda: jengine.infer(tier, jf, **kw))
        got = _traced(TRACER, lambda: engine.infer(tier, tf, **kw))
        w, g = want.trace, got.trace
        assert g.root == w.root == "query.infer", run
        assert g.span_counts == w.span_counts, run
        assert g.event_counts == w.event_counts, run
        assert g.counters == _ref_counters(w), run
        assert g.num_spans == w.num_spans, run
        assert got.scan.batches == want.scan.batches == 3
        assert got.reuse_hit == want.reuse_hit
        assert np.array_equal(got.predictions.numpy(),
                              np.asarray(want.predictions))
        _assert_cataloged(TRACER.finished(), g.counters)
        results.append(got)
    assert g.counters["plan.cache_hits"] == 1         # the repeat hit
    assert "plan.partition" not in g.span_counts
    assert "plan.build" not in g.span_counts
    mark = TRACER.mark()
    plain = engine.infer(tier, tf, **kw)        # disabled: no trace, and
    assert plain.trace is None and TRACER.mark() == mark    # tracing
    for got in results:                         # changed no prediction
        assert torch.equal(got.predictions, plain.predictions)
    assert g.span_counts["scan.batch"] == g.span_counts["scan.compute"] \
        == g.span_counts["scan.drain_write"] == 3


#: one case a fault ladder: the injector's arming and the query's keywords
#: (each site's 2nd call transient; three failed transfers halve the first
#: batch; three failed reads re-enqueue it; the drain's first batch
#: degrades it, over five batches; a deadline that expires at its third
#: check)
LADDERS = {
    "transient": ({site: dict(fail_at=2) for site in (
        "page_dma_in", "kernel_launch", "drain_copy_out")}, {}),
    "halving": ({"page_dma_in": dict(fail_at=1, times=3)},
                dict(batch_pages=4)),
    "reenqueue": ({"disk_page_read": dict(fail_at=1, times=3)}, {}),
    "degrade": ({"drain_worker": dict(fail_at=1)}, dict(batch_pages=1)),
    "deadline": ({}, dict(deadline_s=1.0)),
}


@pytest.mark.parametrize("ladder,tier", [
    (ladder, tier) for ladder in LADDERS for tier in ("host", "disk")
    if (ladder, tier) != ("reenqueue", "host")])
def test_fault_ladder_trace_matches_the_reference(engines, monkeypatch,
                                                  ladder, tier):
    """Each ladder's query: the span and event counts and the counter
    deltas equal the reference's, the events fired on the disk tier's
    reader thread included."""
    from repro.db import faults as jfaults
    from repro.db import query as jquery
    from repro_torch.db import faults
    from repro_torch.db import query as query_mod

    from test_torch_faults import _counting
    (jengine, engine), jf = engines[0]["dense"], engines[1]
    arming, kw = LADDERS[ladder]
    if tier == "disk" and ladder == "transient":
        arming = dict(arming, disk_page_read=dict(fail_at=2))
    if ladder == "deadline":
        jc, c = _counting(jfaults.Deadline), _counting(faults.Deadline)
        monkeypatch.setattr(jquery, "Deadline", lambda b, start=None: jc(2))
        monkeypatch.setattr(query_mod, "Deadline",
                            lambda b, start=None: c(2))
    kw = dict(dict(algorithm=FUSED, batch_pages=2), **kw)

    def armed(mod):
        inj = mod.FaultInjector()
        for site, a in arming.items():
            inj.inject(site, **a)
        return dict(injector=inj, retry_policy=mod.RetryPolicy(
            backoff_base_s=0.0, max_backoff_s=0.0)) if arming else {}

    want = _traced(JTRACER, lambda: jengine.infer(
        tier, jf, **armed(jfaults), **kw))
    got = _traced(TRACER, lambda: engine.infer(
        tier, port_forest(jf), **armed(faults), **kw))
    w, g = want.trace, got.trace
    assert g.event_counts == w.event_counts
    assert g.counters == _ref_counters(w)
    assert g.span_counts == w.span_counts
    assert np.array_equal(got.predictions.numpy(),
                          np.asarray(want.predictions), equal_nan=True)
    _assert_cataloged(TRACER.finished(), g.counters)
    fault_names = {"fault.injected", "retry", "batch.resubmit",
                   "degrade.sync_drain", "deadline.hit"}
    assert fault_names & set(g.event_counts)


@pytest.mark.parametrize("fmt", ["dense", "csr"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("mode", ["model", "autotune"])
def test_auto_query_trace_matches_the_reference(mode, tier, fmt,
                                                monkeypatch):
    """A traced ``plan="auto"`` query (a decision-catalog miss, then the
    repeat's hit) on both packages under one injected peaks table: span
    counts (``optimizer.decide``, and ``optimizer.autotune`` with its probes'
    spans when three udf cells are measured), event counts
    (``optimizer.decision``) and the ``optimizer.*`` counter deltas equal
    the reference's."""
    import repro.db.optimizer as jopt
    import repro_torch.db.optimizer as topt
    from test_torch_optimizer import inject_peaks

    inject_peaks(monkeypatch)
    jengine, engine = _stores(_rows(5), fmt)
    band = 1.0 if mode == "model" else 16.0
    for e, mod in ((jengine, jopt), (engine, topt)):
        e.optimizer = mod.CostBasedOptimizer(
            e, uncertainty_band=band, hillclimb=False, max_measurements=6,
            measure_budget_s=600.0, probe_iters=1)
    jf = _forest(integer_leaves=True)
    tf = port_forest(jf)
    kw = dict(plan="auto" if mode == "model" else "udf", algorithm="auto")
    for run in ("miss", "hit"):
        want = _traced(JTRACER, lambda: jengine.infer(tier, jf, **kw))
        got = _traced(TRACER, lambda: engine.infer(tier, tf, **kw))
        w, g = want.trace, got.trace
        assert g.span_counts == w.span_counts, run
        assert g.event_counts == w.event_counts, run
        assert g.counters == _ref_counters(w), run
        assert g.num_spans == w.num_spans, run
        assert np.array_equal(got.predictions.numpy(),
                              np.asarray(want.predictions))
        _assert_cataloged(TRACER.finished(), g.counters)
        if run == "miss":
            assert g.span_counts["optimizer.decide"] == 1
            assert g.event_counts["optimizer.decision"] == 1
            assert g.counters["optimizer.decision_cache_misses"] == 1
            assert g.span_counts.get("optimizer.autotune", 0) == \
                (mode == "autotune")
            assert g.counters.get("optimizer.measurements", 0) == \
                (3 if mode == "autotune" else 0)
    assert "optimizer.decide" not in g.span_counts
    assert g.counters["optimizer.decision_cache_hits"] == 1


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_depth_one_trace_matches_the_reference(engines, tier):
    (jengine, engine), jf = engines[0]["dense"], engines[1]
    kw = dict(algorithm=FUSED, batch_pages=2, prefetch_depth=1)
    want = _traced(JTRACER, lambda: jengine.infer(tier, jf, **kw)).trace
    got = _traced(TRACER, lambda: engine.infer(tier, port_forest(jf),
                                               **kw)).trace
    assert got.span_counts == want.span_counts
    assert got.counters == _ref_counters(want)


def test_rel_query_and_write_match_the_reference(engines):
    (jengine, engine), jf = engines[0]["dense"], engines[1]
    kw = dict(algorithm=FUSED, plan="rel", batch_pages=2, n_parts=3)
    want = _traced(JTRACER, lambda: jengine.infer(
        "host", jf, write_as="out-rel", **kw)).trace
    got = _traced(TRACER, lambda: engine.infer(
        "host", port_forest(jf), write_as="out-rel", **kw)).trace
    assert got.span_counts == want.span_counts
    assert got.event_counts == want.event_counts == {}   # no cache lookup
    assert got.counters == _ref_counters(want)
    assert got.span_counts["query.write"] == 1
    assert got.span_counts["plan.partition"] == 1


def test_scan_spans_nest_as_the_reference_says(engines):
    """Disk tier at depth 2: the reader thread's disk reads and page copies
    sit under ``scan.execute``, each drain write under its batch, each
    stage span under ``scan.compute``; the export validates."""
    (_, engine), jf = engines[0]["dense"], engines[1]
    res = _traced(TRACER, lambda: engine.infer("disk", port_forest(jf),
                                               algorithm=FUSED,
                                               batch_pages=2))
    spans = TRACER.finished()
    by_id = {s.span_id: s for s in spans}

    def parent(s):
        return by_id[s.parent_id].name

    for s in spans:
        if s.name in ("scan.disk_read", "scan.dma_in"):
            assert parent(s) == "scan.execute"
            assert s.thread_name == "scan-reader"
        elif s.name == "scan.drain_write":
            assert parent(s) == "scan.batch"
        elif s.name.startswith("stage:"):
            assert parent(s) == "scan.compute"
            assert "device_s" not in s.attrs           # a CPU store
    assert res.trace.span_counts["scan.disk_read"] == res.scan.batches
    execute = next(s for s in spans if s.name == "scan.execute")
    assert execute.attrs["batches"] == res.scan.batches
    shape = validate_chrome_trace(TRACER.export_chrome())
    assert shape["cross_thread"] >= 2 * res.scan.batches


@pytest.mark.parametrize("tier", ["device", "host", "disk"])
def test_scan_counters_count_a_failed_scan(tier):
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    ds = store.put("t", _rows(6), tier=tier)
    calls = []

    def udf(state):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("stage failed")
        return {**state, "pred": state["x"][:, 0]}

    stages = split_into_stages([Operator("udf", udf, breaker=True)])
    TRACER.enable()
    with pytest.raises(RuntimeError, match="stage failed"):
        StreamingScanExecutor(stages).execute(ds, 2)
    TRACER.disable()
    counters = METRICS.counter_values()
    execute = next(s for s in TRACER.finished() if s.name == "scan.execute")
    assert execute.attrs["error"] == "RuntimeError"
    assert counters["scan.batches"] == execute.attrs["batches"] == 1
    # the pages loaded before the failure: batch 0's, batch 1's and, when
    # loaded ahead in time, batch 2's
    assert counters["scan.bytes_streamed"] == \
        execute.attrs["bytes_streamed"]
    assert counters["scan.bytes_streamed"] in (
        (0,) if tier == "device" else (4 * PAGE * 9 * 4, 5 * PAGE * 9 * 4))


def test_disabled_infer_leaves_no_trace(engines):
    (_, engine), jf = engines[0]["csr"], engines[1]
    res = engine.infer("disk", port_forest(jf), algorithm=FUSED,
                       batch_pages=2)
    assert res.trace is None and TRACER.finished() == []
    assert METRICS.counter_values()["scan.batches"] == 3   # counted anyway


@pytest.mark.parametrize("plan", ["udf", "rel+reuse"])
def test_infer_rows_spans_and_cache_counters_match_the_reference(plan):
    x = _rows(7)[:32]
    x = np.nan_to_num(x)
    jf = _forest(integer_leaves=True)
    tf = port_forest(jf)
    jengine = JEngine(JStore(default_page_rows=PAGE), reuse_cache=JCache(),
                      plan_cache=JCache())
    engine = ForestQueryEngine(TensorBlockStore(device="cpu"))
    kw = dict(algorithm=FUSED, plan=plan, n_parts=2)
    for _ in range(2):
        want = _traced(JTRACER, lambda: jengine.infer_rows(jf, x, **kw))
        wspans = JTRACER.finished()
        got = _traced(TRACER, lambda: engine.infer_rows(tf, x, **kw))
        gspans = TRACER.finished()
        assert sorted(s.name for s in gspans) == sorted(
            s.name for s in wspans)
        assert sorted(ev.name for s in gspans for ev in s.events) == \
            sorted(ev.name for s in wspans for ev in s.events)
        assert got.plan_reuse_hit == want.plan_reuse_hit
        _assert_cataloged(gspans)
    assert _nonzero(METRICS) == _nonzero(JMETRICS) == {
        "plan.cache_hits": 1, "plan.cache_misses": 1}
    rows = next(s for s in gspans if s.name == "query.infer_rows")
    assert rows.attrs["reuse_hit"] and rows.attrs["batch_rows"] == 32


def _serve_script(eng, x):
    """One shed interactive request and five batch ones, ticked once past
    the shed and once more by ``drain``."""
    reqs = [eng.submit("m", x[:1], priority=0, timeout_s=0.0)]
    off = 1
    for k in (2, 3, 1, 4, 2):
        reqs.append(eng.submit("m", x[off:off + k], priority=1))
        off += k
    eng.tick(now=time.perf_counter() + 0.0005)
    eng.drain()
    return [r.wait(5.0) for r in reqs]


@pytest.mark.parametrize("algorithm,plan", [
    ("predicated", "udf"), (FUSED, "udf"), (FUSED, "rel+reuse")])
def test_serve_tick_trace_matches_the_reference(algorithm, plan):
    """The same drained requests through the reference's serving engine and
    the port's, traced: the spans and events by name (``serve.tick``,
    ``serve.coalesce``, ``query.infer_rows``, ``plan.cache``,
    ``serve.shed``), the ``METRICS`` deltas and the per-model and engine
    registries' counters are equal."""
    from repro.serve.forest import ForestServeEngine as JServe
    from repro_torch.serve.forest import ForestServeEngine

    jf = _forest(integer_leaves=True)
    kw = dict(buckets=(4, 8), interactive_deadline_s=0.001,
              batch_deadline_s=0.05)
    jeng = JServe(JStore(default_page_rows=PAGE), **kw)
    eng = ForestServeEngine(TensorBlockStore(device="cpu"), **kw)
    jeng.register_model("m", jf, algorithm=algorithm, plan=plan)
    eng.register_model("m", port_forest(jf), algorithm=algorithm, plan=plan)
    x = np.nan_to_num(_rows(9))
    jbefore, before = JMETRICS.counter_values(), METRICS.counter_values()
    want = _traced(JTRACER, lambda: _serve_script(jeng, x))
    got = _traced(TRACER, lambda: _serve_script(eng, x))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    wspans, gspans = JTRACER.finished(), TRACER.finished()
    names_ = sorted(s.name for s in gspans)
    assert names_ == sorted(s.name for s in wspans)
    events = sorted([ev.name for s in gspans for ev in s.events]
                    + [ev.name for ev in TRACER._orphan_events])
    assert events == sorted([ev.name for s in wspans for ev in s.events]
                            + [ev.name for ev in JTRACER._orphan_events])
    assert (names_.count("serve.tick"), names_.count("serve.coalesce"),
            names_.count("query.infer_rows"), names_.count("plan.build")) \
        == (2, 2, 2, 0)
    assert (events.count("plan.cache"), events.count("serve.shed")) == (2, 1)
    delta = {k: v - before.get(k, 0)
             for k, v in METRICS.counter_values().items()
             if v != before.get(k, 0)}
    jdelta = {k: v - jbefore.get(k, 0)
              for k, v in JMETRICS.counter_values().items()
              if v != jbefore.get(k, 0) and k not in PENDING}
    assert delta == jdelta == {"plan.cache_hits": 2}
    m, jm = eng._get("m"), jeng._get("m")
    assert m.metrics.counter_values() == jm.metrics.counter_values()
    assert eng.metrics.counter_values() == jeng.metrics.counter_values()
    assert m.metrics.counter_values() == {
        "serve.requests": 6, "serve.shed": 1, "serve.ticks": 2,
        "serve.padding_rows": 3, "serve.plan_hits": 2}
    serve_spans = [s for s in gspans if s.name.startswith("serve.")]
    _assert_cataloged(serve_spans, m.metrics.counter_values())
    assert set(m.metrics.snapshot()) <= set(names.METRIC_NAMES)


# -- the store and the loaders ------------------------------------------------


def _store_script(store, x):
    """Ingests, a streamed ingest and moves, the same on both packages."""
    store.put("a", x)
    store.put("b", x, tier="host")
    store.put_sparse("s", x, tier="disk")
    w = store.stream_writer("w", num_rows=x.shape[0],
                            num_features=x.shape[1], tier="disk")
    w.write(x[:40])
    w.write(x[40:])
    w.close()
    store.put_stream("p", iter((x[:64], x[64:])), num_rows=x.shape[0],
                     num_features=x.shape[1])
    store.move("b", "disk")
    store.move("b", "device")
    store.move("a", "device")                  # a no-op move counts too
    with pytest.raises(ValueError):
        store.move("s", "hbm")                 # a failed move counts too


def _spans_of(tracer) -> list[tuple]:
    return [(s.name, s.attrs) for s in tracer.finished()]


def _nonzero(metrics) -> dict:
    return {k: v for k, v in metrics.counter_values().items()
            if v and k not in PENDING}


def test_store_spans_and_counters_match_the_reference():
    x = _rows(8)
    _traced(JTRACER, lambda: _store_script(JStore(default_page_rows=PAGE),
                                           x))
    _traced(TRACER, lambda: _store_script(
        TensorBlockStore(device="cpu", default_page_rows=PAGE), x))
    want, got = _spans_of(JTRACER), _spans_of(TRACER)
    assert got == want
    assert ("store.move", {"dataset": "b", "src": "host",
                           "dst": "disk"}) in got
    assert _nonzero(METRICS) == _nonzero(JMETRICS) == {"store.puts": 5,
                                                       "store.moves": 4}
    _assert_cataloged(TRACER.finished(), _nonzero(METRICS))


def _load_all(mod, tmp_path, tag: str, **kw):
    """Each loader over the same files (written once, by the port)."""
    csv, svm, arr = (str(tmp_path / f) for f in ("t.csv", "t.svm", "t.arr"))
    mod.load_csv_external(csv, **kw)
    mod.load_libsvm_external(svm, 12, **kw)
    for tier in TIERS:
        spill = tmp_path / f"{tag}-{tier}"
        spill.mkdir()
        csr_kw = {} if mod is jloader else kw
        mod.load_libsvm_csr_external(svm, 12, page_rows=16, tier=tier,
                                     spill_dir=str(spill), **csr_kw)
    mod.load_array_rows_external(arr, **kw)


def test_loader_spans_and_counter_match_the_reference(tmp_path):
    r = np.random.default_rng(9)
    x = r.normal(size=(40, 12)).astype(np.float32)
    x[r.random(x.shape) < 0.3] = np.nan
    y = (r.random(40) < 0.5).astype(np.float32)
    loader.write_csv(str(tmp_path / "t.csv"), np.nan_to_num(x))
    loader.write_libsvm(str(tmp_path / "t.svm"), x, y)
    loader.write_array_rows(str(tmp_path / "t.arr"), np.nan_to_num(x))
    _traced(JTRACER, lambda: _load_all(jloader, tmp_path, "ref"))
    _traced(TRACER, lambda: _load_all(loader, tmp_path, "port",
                                      device="cpu"))
    want, got = _spans_of(JTRACER), _spans_of(TRACER)
    assert got == want
    assert [a for n, a in got if n == "load.parse"] == [
        {"format": f} for f in ("csv", "libsvm", "libsvm-csr", "libsvm-csr",
                                "libsvm-csr", "array-rows")]
    assert sum(n == "load.transfer" for n, _ in got) == 4
    assert _nonzero(METRICS) == _nonzero(JMETRICS) == {
        "load.external_loads": 6}
    _assert_cataloged(TRACER.finished(), _nonzero(METRICS))


# -- the catalog --------------------------------------------------------------


def test_catalog_is_the_reference_minus_the_pending_set():
    assert set(names.SPAN_NAMES) <= set(jnames.SPAN_NAMES)
    assert set(names.EVENT_NAMES) <= set(jnames.EVENT_NAMES)
    assert set(names.METRIC_NAMES) <= set(jnames.METRIC_NAMES)
    assert names.SPAN_PREFIXES == jnames.SPAN_PREFIXES
    assert _catalog(jnames) - _catalog(names) == set(PENDING)
    for cat in (names.SPAN_NAMES, names.EVENT_NAMES, names.METRIC_NAMES):
        assert len(set(cat)) == len(cat)


def test_docs_list_every_cataloged_name_in_backticks():
    doc = (ROOT / "docs" / "torch_observability.md").read_text()
    quoted = set(re.findall(r"`([^`\n]+)`", doc))
    for name in (_catalog(names) | set(names.SPAN_PREFIXES)
                 | {"cuda:drain", "device_s"}):
        assert name in quoted, name
