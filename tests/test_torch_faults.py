"""Port parity: the fault plane (``db/faults.py``) through the store, the
scan, the query and the loaders.

The port's counterpart of ``tests/test_faults.py`` (without its two mesh
tests), at its shapes: N 384, F 16, 24 depth-4 trees trained by the
reference's ``train_forest``, pages of 32 rows, ``batch_pages=2``, the
``FAST`` policy.  The trained forest's leaves are rounded to multiples of
1/64 and its task set to regression, so that every sum is exact and both
packages' predictions compare bit for bit (a sigmoid would differ in an
ulp).  Each case runs the reference engine and the port's, on the CPU, on
the same arrays with the same arming, and checks:

  * predictions bit-identical (NaN where a partial left rows unscored);
  * the ``ScanStats`` fault fields equal, and ``injector.calls`` per site
    (except where the reference's drain thread makes a site's count
    depend on timing: then the faulted site's);
  * a ``ScanFault``'s site, attempts, rows completed and cause type, and
    a partial's ``DegradedReport``, equal.

Cases: the site x tier x plan x format matrix of transient faults, the
armed-but-silent injector, both ladders and their exhaustion, the sites
with no ladder, deadlines (counting, zero, generous), ``move``'s rollback
in both directions, the loaders' transient fault, and the primitives.
"""

import dataclasses
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.reuse import ModelReuseCache as JCache
from repro.core.train import TrainConfig, train_forest
from repro.db import faults as jfaults
from repro.db import loader as jld
from repro.db import operators as jops
from repro.db import query as jquery
from repro.db import store as jstore_mod
from repro.db.executor import StreamingScanExecutor as JExecutor
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.store import TensorBlockStore as JStore
from repro_torch.db import faults
from repro_torch.db import loader as ld
from repro_torch.db import query as query_mod
from repro_torch.db import store as store_mod
from repro_torch.db.executor import StreamingScanExecutor
from repro_torch.db.faults import (FAULT_SITES, Deadline, DeadlineExceeded,
                                   FaultInjector, InjectedFault, RetryPolicy,
                                   ScanFault)
from repro_torch.db.operators import Operator, split_into_stages
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.store import TensorBlockStore

from test_torch_forest import port_forest

N, F, T, PAGE = 384, 16, 24, 32
FUSED = "predicated_pallas_fused"
SPARSE_ALGO = "hummingbird_pallas_fused"
TIERS = ("device", "host", "disk")

#: retry semantics identical to the default, backoff sleeps zeroed
FAST = RetryPolicy(backoff_base_s=0.0, max_backoff_s=0.0)
JFAST = jfaults.RetryPolicy(backoff_base_s=0.0, max_backoff_s=0.0)

STAT_FIELDS = ("batches", "retries", "faults_injected", "degraded_to_sync",
               "batch_resubmits", "deadline_hit")


@pytest.fixture(scope="module")
def env():
    """Both packages' stores (every format x tier) and engines over the
    same rows, and the trained forest in both."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, F)).astype(np.float32)
    w = rng.normal(size=F).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    trained = train_forest(x, y, TrainConfig(model_type="xgboost",
                                             num_trees=T, max_depth=4))
    jf = dataclasses.replace(
        trained, task="regression",
        leaf_value=jnp.round(trained.leaf_value * 64) / 64,
        node_value=jnp.round(trained.node_value * 64) / 64)
    xs = x.copy()
    xs[rng.random(x.shape) < 0.7] = np.nan
    jstore = JStore(default_page_rows=PAGE)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    for s in (jstore, store):
        for tier in TIERS:
            s.put(f"dense@{tier}", x, tier=tier)
            s.put_sparse(f"csr@{tier}", xs, tier=tier)
    jengine = JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache())
    return jengine, ForestQueryEngine(store), jf, port_forest(jf)


def _arm(injector, arming):
    for site, kw in arming.items():
        injector.inject(site, **kw)
    return injector


def _run_both(env, dataset, *, arming=None, algo=FUSED, plan="udf",
              batch_pages=2, **kw):
    """The same query on both engines, each with a fresh injector armed
    alike.  Returns (reference result, its injector, port result, its
    injector)."""
    jengine, engine, jf, tf = env
    jinj = inj = None
    if arming is not None:
        jinj = _arm(jfaults.FaultInjector(), arming)
        inj = _arm(FaultInjector(), arming)
    want = jengine.infer(dataset, jf, algorithm=algo, plan=plan,
                         batch_pages=batch_pages, injector=jinj,
                         retry_policy=JFAST if arming else None, **kw)
    got = engine.infer(dataset, tf, algorithm=algo, plan=plan,
                       batch_pages=batch_pages, injector=inj,
                       retry_policy=FAST if arming else None, **kw)
    return want, jinj, got, inj


def _assert_same(want, jinj, got, inj, *, what=""):
    assert np.array_equal(got.predictions.numpy(),
                          np.asarray(want.predictions), equal_nan=True), what
    for f in STAT_FIELDS:
        assert getattr(got.scan, f) == getattr(want.scan, f), (what, f)
    if inj is not None:
        assert inj.calls == jinj.calls, what
    if want.degraded is None:
        assert got.degraded is None, what
    else:
        g, w = got.degraded, want.degraded
        assert (g.rows_scored, g.rows_missing, g.cause, g.deadline_s) == \
            (w.rows_scored, w.rows_missing, w.cause, w.deadline_s), what
        assert np.array_equal(g.row_mask, np.asarray(w.row_mask)), what


def _faults_of_both(env, dataset, arming, *, same_rows=True, **kw):
    """The same failing query on both engines: (reference ScanFault, its
    injector, port ScanFault, its injector).  ``same_rows=False`` where
    the reference's drain thread makes its ``rows_completed`` depend on
    timing."""
    jengine, engine, jf, tf = env
    jinj = _arm(jfaults.FaultInjector(), arming)
    inj = _arm(FaultInjector(), arming)
    kw = dict(dict(algorithm=FUSED, plan="udf", batch_pages=2), **kw)
    with pytest.raises(jfaults.ScanFault) as jinfo:
        jengine.infer(dataset, jf, injector=jinj, retry_policy=JFAST, **kw)
    with pytest.raises(ScanFault) as info:
        engine.infer(dataset, tf, injector=inj, retry_policy=FAST, **kw)
    want, got = jinfo.value, info.value
    assert (got.site, got.attempts) == (want.site, want.attempts)
    assert not same_rows or got.rows_completed == want.rows_completed
    assert isinstance(got.cause, InjectedFault)
    assert isinstance(want.cause, jfaults.InjectedFault)
    return want, jinj, got, inj


def _reader_threads() -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.name == "scan-reader"]


# -- the fault matrix: transient faults recover bit-identically ---------------


@pytest.mark.parametrize("fmt,algo", [("dense", FUSED),
                                      ("csr", SPARSE_ALGO)])
@pytest.mark.parametrize("plan", ["udf", "rel"])
@pytest.mark.parametrize("site", FAULT_SITES)
def test_transient_fault_matches_the_reference(env, site, plan, fmt, algo):
    """One transient fault (the site's 2nd call) on every tier where the
    site exists: both engines recover with the same predictions, the same
    accounting and the same calls per site."""
    for tier in TIERS:
        if site == "disk_page_read" and tier != "disk":
            continue
        runs = _run_both(env, f"{fmt}@{tier}", algo=algo, plan=plan,
                         arming={site: dict(fail_at=2)})
        _assert_same(*runs, what=(site, tier))
        sc = runs[2].scan
        assert sc.faults_injected == 1, (site, tier)
        assert sc.degraded_to_sync == (site == "drain_worker")
        assert sc.retries == (site != "drain_worker")
        assert not sc.deadline_hit and runs[2].degraded is None


@pytest.mark.parametrize("tier", TIERS)
def test_armed_but_silent_injector_changes_nothing(env, tier):
    runs = _run_both(env, f"dense@{tier}",
                     arming={"kernel_launch": dict(fail_at=10_000)})
    _assert_same(*runs)
    got, inj = runs[2], runs[3]
    assert got.scan.faults_injected == 0 and got.scan.retries == 0
    assert inj.calls["kernel_launch"] == got.scan.batches == 6
    assert inj.calls["drain_worker"] == 6     # depth 2, six batches


@pytest.mark.parametrize("tier", TIERS)
def test_depth_one_has_no_drain_worker_site(env, tier):
    runs = _run_both(env, f"dense@{tier}", prefetch_depth=1,
                     arming={"drain_worker": dict(fail_at=1)})
    _assert_same(*runs)
    assert runs[3].calls["drain_worker"] == 0
    assert not runs[2].scan.degraded_to_sync


# -- the ladders --------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["dense", "csr"])
@pytest.mark.parametrize("tier", TIERS)
def test_dma_halving_ladder_matches_the_reference(env, tier, fmt):
    """Transfer faults past the retries split the batch in halves, which
    land at the same slots."""
    runs = _run_both(env, f"{fmt}@{tier}", batch_pages=4,
                     algo=FUSED if fmt == "dense" else SPARSE_ALGO,
                     arming={"page_dma_in": dict(fail_at=1,
                                                 times=FAST.max_attempts)})
    _assert_same(*runs)
    sc = runs[2].scan
    assert sc.batch_resubmits == 1 and sc.batches == 4
    assert sc.faults_injected == FAST.max_attempts
    assert sc.retries == FAST.max_attempts - 1
    assert sc.max_in_flight <= 2


@pytest.mark.parametrize("tier", TIERS)
def test_dma_ladder_floor_raises_the_reference_scanfault(env, tier):
    want, jinj, got, inj = _faults_of_both(
        env, f"dense@{tier}", {"page_dma_in": dict(fail_at=1, times=10_000)})
    assert got.site == "page_dma_in" and got.attempts == FAST.max_attempts
    assert got.rows_completed == 0 and inj.calls == jinj.calls
    assert not _reader_threads()


@pytest.mark.parametrize("fmt", ["dense", "csr"])
def test_disk_reenqueue_ladder_matches_the_reference(env, fmt):
    runs = _run_both(env, f"{fmt}@disk",
                     algo=FUSED if fmt == "dense" else SPARSE_ALGO,
                     arming={"disk_page_read": dict(
                         fail_at=1, times=FAST.max_attempts)})
    _assert_same(*runs)
    sc = runs[2].scan
    assert sc.batch_resubmits == 1
    assert sc.faults_injected == FAST.max_attempts


@pytest.mark.parametrize("depth", [2, 1])
def test_disk_reenqueue_exhaustion_raises_the_reference_scanfault(env, depth):
    want, jinj, got, inj = _faults_of_both(
        env, "dense@disk", {"disk_page_read": dict(fail_at=1, times=10**6)},
        prefetch_depth=depth)
    assert got.attempts == 2 * FAST.max_attempts and got.rows_completed == 0
    assert inj.calls == jinj.calls
    assert not _reader_threads()


@pytest.mark.parametrize("depth,fail_at", [(2, 1), (1, 3)])
@pytest.mark.parametrize("site", ["kernel_launch", "drain_copy_out"])
def test_unladdered_site_exhaustion_raises_the_reference_scanfault(
        env, site, depth, fail_at):
    """No rung below the retries.  At depth 1 (the reference drains on
    its caller's thread) two batches have landed first."""
    want, jinj, got, inj = _faults_of_both(
        env, "dense@host", {site: dict(fail_at=fail_at, times=10**6)},
        prefetch_depth=depth)
    assert got.rows_completed == (fail_at - 1) * 2 * PAGE
    assert inj.calls[site] == jinj.calls[site] == FAST.max_attempts \
        + fail_at - 1
    if depth == 1 or site == "kernel_launch":
        assert inj.calls == jinj.calls


@pytest.mark.parametrize("tier", TIERS)
def test_a_store_answers_after_a_scanfault(env, tier):
    """A ScanFault mid-scan leaves no reader thread, and the next clean
    query on the same store gives the full result."""
    got = _faults_of_both(env, f"dense@{tier}",
                          {"kernel_launch": dict(fail_at=3, times=10**6)},
                          same_rows=False)[2]
    assert got.rows_completed == 2 * 2 * PAGE      # two batches drained
    assert not _reader_threads()
    _assert_same(*_run_both(env, f"dense@{tier}"))


def test_faults_injected_counts_a_raising_scan(env):
    """A kept divergence: the port counts ``scan.faults_injected`` on a
    raising exit too, where the reference counts it only when the scan
    returns."""
    from repro.obs import METRICS as JMETRICS
    from repro_torch.obs import METRICS

    def count() -> tuple[int, int]:
        return tuple(m.counter_values().get("scan.faults_injected", 0)
                     for m in (METRICS, JMETRICS))

    before = count()
    _faults_of_both(env, "dense@host",
                    {"kernel_launch": dict(fail_at=1, times=10**6)})
    after = count()
    assert after[0] - before[0] == FAST.max_attempts
    assert after[1] - before[1] == 0


def test_a_stage_error_is_not_retried():
    """Only (InjectedFault, OSError) are retried: a RuntimeError out of
    a stage (what a CUDA error is) propagates at once, unretried."""
    store = TensorBlockStore(device="cpu", default_page_rows=16)
    ds = store.put("t", np.ones((64, 3), np.float32), tier="host")
    calls = []

    def udf(state):
        calls.append(1)
        raise RuntimeError("device-side assert")

    ex = StreamingScanExecutor(
        split_into_stages([Operator("udf", udf, breaker=True)]),
        injector=FaultInjector(), retry_policy=FAST)
    with pytest.raises(RuntimeError, match="device-side assert"):
        ex.execute(ds, 1)
    assert len(calls) == 1


# -- deadlines ----------------------------------------------------------------


def _counting(base):
    """A ``base`` Deadline subclass that expires after N checks: a
    mid-scan deadline with no wall clock."""

    class Counting(base):
        def __init__(self, checks_allowed: int):
            super().__init__(None)
            self.checks_allowed = checks_allowed
            self.checks = 0

        @property
        def expired(self) -> bool:
            self.checks += 1
            return self.checks > self.checks_allowed

    return Counting


def _sum_executor(executor_cls, ops, split, total, *, deadline):
    """The reference test's plan (a sum over F), in either package."""

    def udf(state):
        state = dict(state)
        state["pred"] = total(state["x"])
        return state

    return executor_cls(split([ops.Operator("udf", udf),
                               ops.Operator("write", lambda s: s,
                                            breaker=True)]),
                        deadline=deadline)


@pytest.mark.parametrize("tier", TIERS)
def test_counting_deadline_partial_matches_the_reference(tier):
    """Three of eight batches: the scored rows exact, the rest NaN, the
    mask whole batches, on every tier."""
    x = np.arange(256 * 5, dtype=np.float32).reshape(256, 5)
    jds = JStore(default_page_rows=16).put("p", x, tier=tier)
    ds = TensorBlockStore(device="cpu", default_page_rows=16).put(
        "p", x, tier=tier)
    jex = _sum_executor(JExecutor, jops, lambda o: jops.split_into_stages(
        o, jit=False), lambda a: jnp.sum(a, axis=1),
        deadline=_counting(jfaults.Deadline)(3))
    from repro_torch.db import operators as tops
    ex = _sum_executor(StreamingScanExecutor, tops, split_into_stages,
                       lambda a: torch.sum(a, dim=1),
                       deadline=_counting(Deadline)(3))
    want, _, jst = jex.execute(jds, 2)
    got, _, st = ex.execute(ds, 2)
    assert st.deadline_hit and jst.deadline_hit and st.batches == 3
    assert ex.deadline.checks == jex.deadline.checks == 4
    assert np.array_equal(ex.last_mask, jex.last_mask)
    assert ex.last_mask.sum() == 3 * 2 * 16
    assert np.array_equal(got.numpy(), np.asarray(want), equal_nan=True)
    assert np.isnan(got.numpy()[~ex.last_mask]).all()


@pytest.mark.parametrize("plan", ["udf", "rel"])
@pytest.mark.parametrize("tier", TIERS)
def test_query_deadline_partial_matches_the_reference(env, monkeypatch,
                                                      tier, plan):
    """``infer(deadline_s=)`` through a counting deadline: the same partial
    and ``DegradedReport`` from both engines."""
    jc, c = _counting(jfaults.Deadline), _counting(Deadline)
    monkeypatch.setattr(jquery, "Deadline", lambda b, start=None: jc(2))
    monkeypatch.setattr(query_mod, "Deadline", lambda b, start=None: c(2))
    runs = _run_both(env, f"dense@{tier}", plan=plan, deadline_s=1.0)
    _assert_same(*runs)
    d = runs[2].degraded
    assert runs[2].scan.batches == 2 and d.rows_scored == 4 * PAGE
    assert d.rows_missing == N - 4 * PAGE and d.cause == "deadline"


@pytest.mark.parametrize("tier", TIERS)
def test_zero_and_generous_deadlines_match_the_reference(env, tier):
    runs = _run_both(env, f"dense@{tier}", deadline_s=0.0)
    _assert_same(*runs)
    d = runs[2].degraded
    assert d and d.rows_scored == 0 and d.rows_missing == N
    assert d.deadline_s == 0.0 and not d.row_mask.any()
    assert torch.isnan(runs[2].predictions).all()
    assert runs[2].predictions.device.type == "cpu"
    runs = _run_both(env, f"dense@{tier}", deadline_s=3600.0)
    _assert_same(*runs)
    assert not runs[2].scan.deadline_hit and runs[2].degraded is None
    assert not torch.isnan(runs[2].predictions).any()


@pytest.mark.parametrize("tier", TIERS)
def test_deadline_inside_a_retry_is_a_partial(env, monkeypatch, tier):
    """A deadline that expires while a site retries ends the scan there
    as a partial, not a ScanFault, in both engines."""
    jc, c = _counting(jfaults.Deadline), _counting(Deadline)
    monkeypatch.setattr(jquery, "Deadline", lambda b, start=None: jc(2))
    monkeypatch.setattr(query_mod, "Deadline", lambda b, start=None: c(2))
    runs = _run_both(env, f"dense@{tier}", deadline_s=1.0,
                     arming={"kernel_launch": dict(fail_at=2, times=10)})
    _assert_same(*runs)
    assert runs[2].scan.deadline_hit and runs[2].scan.batches == 1
    assert runs[2].degraded.rows_scored == 2 * PAGE


# -- store.move ---------------------------------------------------------------


@pytest.mark.parametrize("fmt,fail_at", [("dense", 1), ("csr", 2)])
def test_move_off_disk_rolls_back_as_the_reference(fmt, fail_at, tmp_path):
    """An exhausted disk read in ``move`` (one guarded read an array: the
    CSR move's second array fails) rolls the move back (catalog, tier
    bytes and spill files unchanged) and raises the reference's
    ScanFault; the injector disarmed, the retried move works."""
    x = np.arange(128 * 4, dtype=np.float32).reshape(128, 4)
    x[::5, 1] = np.nan
    arming = {"disk_page_read": dict(fail_at=fail_at,
                                     times=FAST.max_attempts)}
    jinj = _arm(jfaults.FaultInjector(), arming)
    inj = _arm(FaultInjector(), arming)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    jstore = JStore(default_page_rows=16, injector=jinj, retry_policy=JFAST,
                    spill_dir=str(tmp_path / "ref"))
    store = TensorBlockStore(device="cpu", default_page_rows=16,
                             injector=inj, retry_policy=FAST,
                             spill_dir=str(tmp_path / "port"))
    for s in (jstore, store):
        (s.put_sparse if fmt == "csr" else s.put)("d", x, tier="disk")
    files = sorted(os.listdir(store.spill_dir))
    disk0 = store.disk_nbytes
    with pytest.raises(jfaults.ScanFault) as jinfo:
        jstore.move("d", "host")
    with pytest.raises(ScanFault) as info:
        store.move("d", "host")
    want, got = jinfo.value, info.value
    assert (got.site, got.attempts, got.rows_completed, str(got)) == \
        (want.site, want.attempts, want.rows_completed, str(want))
    assert inj.calls == jinj.calls
    assert inj.calls["disk_page_read"] == fail_at - 1 + FAST.max_attempts
    assert store.get("d").tier == "disk" and store.host_nbytes == 0
    assert store.disk_nbytes == disk0
    assert sorted(os.listdir(store.spill_dir)) == files
    moved = store.move("d", "host")
    assert moved.tier == "host" and os.listdir(store.spill_dir) == []
    assert store.host_nbytes == moved.nbytes and store.disk_nbytes == 0


def test_move_onto_disk_rolls_back_and_raises_as_itself(monkeypatch):
    """A failed spill write is not a disk read: the move rolls back and
    the OSError reaches the caller as itself, in both packages."""
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    x[::3] = np.nan
    for mod, store in ((jstore_mod, JStore(default_page_rows=16)),
                       (store_mod, TensorBlockStore(
                           device="cpu", default_page_rows=16,
                           injector=FaultInjector()))):
        store.put_sparse("s", x, tier="host")
        real, cnt = mod.mmap_array, []

        def flaky(path, arr, real=real, cnt=cnt):
            cnt.append(1)
            if len(cnt) == 2:
                raise OSError("synthetic: disk full")
            return real(path, arr)

        monkeypatch.setattr(mod, "mmap_array", flaky)
        with pytest.raises(OSError, match="disk full"):
            store.move("s", "disk")
        assert store.get("s").tier == "host" and store.disk_nbytes == 0
        assert os.listdir(store.spill_dir) == []
        monkeypatch.setattr(mod, "mmap_array", real)
        assert store.move("s", "disk").tier == "disk"
        assert len(os.listdir(store.spill_dir)) == 3


# -- the loaders --------------------------------------------------------------


def _load(mod, kind, path, **kw):
    if kind == "csv":
        return mod.load_csv_external(path, **kw)[0]
    if kind == "libsvm":
        return mod.load_libsvm_external(path, 8, **kw)[0]
    pages = mod.load_libsvm_csr_external(path, 8, page_rows=16, **kw)[0]
    return pages.indptr, pages.indices, pages.values


@pytest.mark.parametrize("kind", ["csv", "libsvm", "libsvm-csr"])
def test_loader_transient_transfer_fault_matches_the_reference(tmp_path,
                                                               kind):
    r = np.random.default_rng(4)
    x = r.normal(size=(40, 8)).astype(np.float32)
    x[r.random(x.shape) < 0.3] = np.nan
    path = str(tmp_path / "t.txt")
    if kind == "csv":
        ld.write_csv(path, np.nan_to_num(x))
    else:
        ld.write_libsvm(path, x, (r.random(40) < 0.5).astype(np.float32))
    arming = {"page_dma_in": dict(fail_at=1)}
    jinj = _arm(jfaults.FaultInjector(), arming)
    inj = _arm(FaultInjector(), arming)
    want = _load(jld, kind, path, injector=jinj, retry_policy=JFAST)
    got = _load(ld, kind, path, device="cpu", injector=inj,
                retry_policy=FAST)
    clean = _load(ld, kind, path, device="cpu")
    for g, w, c in zip(*(a if isinstance(a, tuple) else (a,)
                         for a in (got, want, clean))):
        assert np.array_equal(g.numpy(), np.asarray(w), equal_nan=True)
        assert torch.equal(g.nan_to_num(7.0), c.nan_to_num(7.0))
    assert inj.calls == jinj.calls and inj.total_fired == 1
    exhausted = _arm(FaultInjector(), {"page_dma_in": dict(
        fail_at=1, times=FAST.max_attempts)})
    with pytest.raises(InjectedFault):
        _load(ld, kind, path, device="cpu", injector=exhausted,
              retry_policy=FAST)


# -- the primitives -----------------------------------------------------------


def test_injector_fail_at_and_times():
    inj = FaultInjector().inject("kernel_launch", fail_at=3, times=2)
    fired = []
    for i in range(1, 8):
        try:
            inj.fire("kernel_launch")
            fired.append(False)
        except InjectedFault as e:
            assert e.site == "kernel_launch" and e.call == i
            fired.append(True)
    assert fired == [False, False, True, True, False, False, False]
    assert inj.total_fired == 2 and inj.calls["kernel_launch"] == 7


@pytest.mark.parametrize("seed", [5, 6])
def test_probability_mode_fires_at_the_reference_calls(seed):
    """Seeded per (seed, site): replay-stable, seed-sensitive, and the
    reference's firing sequence exactly."""

    def trace(cls, exc) -> list[int]:
        inj = cls(seed=seed).inject("page_dma_in", probability=0.5,
                                    times=10**9)
        out = []
        for _ in range(64):
            try:
                inj.fire("page_dma_in")
                out.append(0)
            except exc:
                out.append(1)
        return out

    a = trace(FaultInjector, InjectedFault)
    assert a == trace(FaultInjector, InjectedFault)
    assert 0 < sum(a) < 64
    assert a == trace(jfaults.FaultInjector, jfaults.InjectedFault)


def test_probability_mode_is_seed_sensitive():
    def fires(seed):
        inj = FaultInjector(seed=seed).inject("page_dma_in", probability=0.5,
                                              times=10**9)
        out = []
        for _ in range(64):
            try:
                inj.fire("page_dma_in")
                out.append(0)
            except InjectedFault:
                out.append(1)
        return out

    assert fires(5) != fires(6)


def test_injector_validation():
    inj = FaultInjector()
    with pytest.raises(ValueError):
        inj.inject("bogus_site", fail_at=1)
    with pytest.raises(ValueError):
        inj.inject("kernel_launch")
    with pytest.raises(ValueError):
        inj.inject("kernel_launch", fail_at=1, probability=0.5)
    assert FAULT_SITES == jfaults.FAULT_SITES


def test_retry_policy_recovers_counts_and_refuses_bugs():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    retries = []
    assert FAST.run(flaky, site="disk_page_read",
                    on_retry=lambda: retries.append(1)) == "ok"
    assert calls["n"] == 3 and len(retries) == 2

    def always():
        raise OSError("permanent")

    with pytest.raises(OSError):
        FAST.run(always, site="disk_page_read")
    calls["n"] = 0

    def bug():
        calls["n"] += 1
        raise ValueError("a bug, not a fault")

    with pytest.raises(ValueError):
        FAST.run(bug, site="kernel_launch")
    assert calls["n"] == 1


def test_per_call_budget_stops_retries():
    calls = []

    def slow_fail():
        calls.append(1)
        threading.Event().wait(0.02)
        raise OSError("stuck")

    with pytest.raises(OSError):
        RetryPolicy(max_attempts=10, backoff_base_s=0.0, max_backoff_s=0.0,
                    per_call_budget_s=0.01).run(slow_fail, site="x")
    assert len(calls) == 1


def test_backoff_is_the_reference_and_capped():
    p, jp = RetryPolicy(), jfaults.RetryPolicy()
    for site in FAULT_SITES:
        for attempt in (1, 2, 3, 7, 30):
            assert p.backoff_s(site, attempt) == jp.backoff_s(site, attempt)
    assert p.backoff_s("page_dma_in", 1) != p.backoff_s("drain_copy_out", 1)
    assert p.backoff_s("page_dma_in", 30) \
        <= p.max_backoff_s * (1 + p.jitter_frac)


def test_retry_under_expired_deadline_raises_deadline_exceeded():
    def always():
        raise OSError("x")

    with pytest.raises(DeadlineExceeded):
        FAST.run(always, site="page_dma_in", deadline=Deadline(0.0))
    assert Deadline(None).remaining() == float("inf")
    assert not Deadline(None).expired and Deadline(0.0).expired


def test_scanfault_message_is_the_reference():
    cause = OSError("boom")
    kw = dict(attempts=3, rows_completed=64, cause=cause, detail="d")
    assert str(ScanFault("page_dma_in", **kw)) == \
        str(jfaults.ScanFault("page_dma_in", **kw))
    assert not faults.DegradedReport(rows_scored=4, rows_missing=0,
                                     cause="deadline")
