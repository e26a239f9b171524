"""Online forest serving plane: micro-batch coalescing onto the
compiled-plan cache (torch).

Mirrors ``repro/serve/forest.py``.  Request-serving deployments (fraud
gating, ranking, admission control) send single rows or tiny batches, and
pay for each request's latency under concurrent traffic.  Served one by
one, every request would pay a whole query; this plane coalesces them:

  * **Micro-batch coalescing.**  Requests for one registered model queue
    and flush together as ONE row batch padded to the smallest rung of a
    fixed BUCKET LADDER (default 8 / 32 / 128 rows) that holds them, and
    go through ``ForestQueryEngine.infer_rows``.  Every flushed batch has
    one of ``len(buckets)`` shapes, so after ``register_model``'s warmup
    every tick hits a compiled plan (``plan.cache_hits``; no
    ``plan.cache_misses``).  Padding rows are masked, come back NaN and are
    never handed to a caller.
  * **Latency tiers with deadline flush.**  A ticker thread flushes a
    model's queue when the largest bucket fills, when its oldest
    ``TIER_INTERACTIVE`` request has waited ``interactive_deadline_s``, or
    (a batch-only queue) when its oldest request has waited
    ``batch_deadline_s``.  With a ``ForestRouter``, an unprioritized submit
    is routed into a tier from request features whose load feature is the
    process-global ``serve.queue_depth`` gauge.  An interactive request
    still queued past its ``timeout_s`` is SHED to the batch tier
    (``shed=True``, counted) instead of forcing an early flush.
  * **Multi-model tenancy.**  ``register_model`` pins the forest in the
    store's model catalog; compiled plans live in the query engine's
    ``ModelReuseCache`` (LRU), so a cold tenant's plans age out under
    pressure while the pin keeps it servable, and an evicted tenant
    re-serves bit for bit after one plan miss.  Each tenant has its own
    ``MetricsRegistry``; ``stats()`` reads queue wait, coalesce width and
    end-to-end latency percentiles from its histograms.

The engine lock: the ticker thread runs ``infer_rows`` while the caller's
thread may register (warmup: ``infer_rows``), replace or unregister a
tenant (``invalidate``, and ``store.put_model``'s invalidator hook).  The
query engine's caches take no lock of their own, so the engine serialises
every use of its query engine under ``_engine_lock``; a flush holds it
from taking its requests off the queue until they are answered, so a
tenant cannot be swept from under a flush in flight.  Queues are guarded
by ``_lock`` (taken inside ``_engine_lock``, never around it).  Callers
that use ``engine.qe`` directly while the ticker runs must hold
``_engine_lock`` too.

Not ported yet: ``algorithm="auto"`` / ``plan="auto"`` (the optimizer,
ROADMAP queue 1 item 10) are refused at ``register_model``; the
reference's ``plan.traces`` has nothing to count without a tracing
compiler or a CUDA graph (docs/torch_serving.md).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any

import numpy as np

from repro_torch.core.reuse import ModelReuseCache, fingerprint_forest
from repro_torch.db.query import _AUTO_REFUSED, ForestQueryEngine
from repro_torch.db.store import TensorBlockStore
from repro_torch.obs import METRICS, TRACER, MetricsRegistry
from repro_torch.serve.router import (QUEUE_DEPTH_METRIC, TIER_BATCH,
                                      TIER_INTERACTIVE, ForestRouter,
                                      request_features)

__all__ = ["ForestRequest", "ServedModel", "ForestServeEngine",
           "DEFAULT_BUCKETS"]

#: the default bucket ladder: every coalesced batch is padded to the
#: smallest bucket that fits, so the compiled-plan cache sees at most
#: ``len(DEFAULT_BUCKETS)`` batch signatures per (model, plan)
DEFAULT_BUCKETS = (8, 32, 128)


@dataclasses.dataclass
class ForestRequest:
    """One in-flight serving request (a single row or a small batch)."""

    uid: int
    model: str
    rows: np.ndarray                   # [k, F] f32, k >= 1
    priority: int = TIER_BATCH         # router tier (named constants)
    timeout_s: float | None = None     # admission timeout: an interactive
    #                                    request still queued past this
    #                                    SHEDS to the batch tier
    shed: bool = False
    submitted_at: float = 0.0
    admitted_at: float = 0.0           # coalesced into a tick
    finished_at: float = 0.0
    predictions: np.ndarray | None = None   # [k] on completion
    error: BaseException | None = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    @property
    def num_rows(self) -> int:
        return int(self.rows.shape[0])

    def wait(self, timeout: float | None = None) -> np.ndarray:
        """Block until served; returns the [k] predictions (raises the
        tick's error if the flush that carried this request failed)."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"request {self.uid} not served within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.predictions


@dataclasses.dataclass
class ServedModel:
    """A registered tenant: the pinned forest, its serving config and its
    own ``MetricsRegistry`` (tenants' stats never mix)."""

    name: str
    forest: Any
    model_id: str                      # content fingerprint (cache keys)
    algorithm: str
    plan: str
    metrics: MetricsRegistry = dataclasses.field(
        default_factory=MetricsRegistry)
    pending: deque = dataclasses.field(default_factory=deque)
    registered_at: float = dataclasses.field(default_factory=time.time)


class ForestServeEngine:
    """Serves registered forest models behind a micro-batch coalescer.

    Construction wires (or accepts) a ``TensorBlockStore`` and a
    ``ForestQueryEngine`` with its own ``ModelReuseCache(max_plans)`` pair;
    the plan cache's LRU is the multi-model eviction policy.  With no
    store, ``TensorBlockStore()`` puts everything on the card and raises
    without one.  Use as a context manager (or ``start()`` / ``stop()``)
    to run the ticker thread; synchronous callers drive ``tick()`` /
    ``drain()`` directly.
    """

    def __init__(self, store: TensorBlockStore | None = None, *,
                 query_engine: ForestQueryEngine | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 interactive_deadline_s: float = 0.002,
                 batch_deadline_s: float = 0.02,
                 router: ForestRouter | None = None,
                 max_plans: int = 32,
                 tick_interval_s: float = 0.0005,
                 algorithm: str = "predicated",
                 plan: str = "udf"):
        self.store = store if store is not None else TensorBlockStore()
        self.qe = query_engine if query_engine is not None else \
            ForestQueryEngine(self.store,
                              reuse_cache=ModelReuseCache(max_plans),
                              plan_cache=ModelReuseCache(max_plans))
        # the reference rounds each rung up to the mesh data axis; the
        # port has one device, so the axis is 1
        self.buckets = tuple(sorted({int(b) for b in buckets if b > 0}))
        if not self.buckets:
            raise ValueError("bucket ladder must not be empty")
        self.interactive_deadline_s = interactive_deadline_s
        self.batch_deadline_s = batch_deadline_s
        self.router = router
        self.tick_interval_s = tick_interval_s
        self.default_algorithm = algorithm
        self.default_plan = plan
        self._models: dict[str, ServedModel] = {}
        self._lock = threading.Lock()          # queues and the tenant map
        self._engine_lock = threading.Lock()   # the query engine (module note)
        self._uid = 0
        self._ticker: threading.Thread | None = None
        self._running = threading.Event()
        self.last_error: BaseException | None = None
        # engine-level telemetry across tenants (per-model registries hold
        # each tenant's); queue depth is the process-global
        # serve.queue_depth gauge the router's load feature reads
        self.metrics = MetricsRegistry()
        self._width_bounds = tuple(float(b) for b in self.buckets)
        self._width_h = self.metrics.histogram(
            "serve.coalesce_width", bounds=self._width_bounds)

    # ------------------------------------------------------------------
    # tenancy
    # ------------------------------------------------------------------
    def register_model(self, name: str, forest, *,
                       algorithm: str | None = None,
                       plan: str | None = None,
                       warmup: bool = True) -> ServedModel:
        """Register (or replace) a served model.

        Pins the forest in the store's model catalog and, with ``warmup``
        (default), builds one plan per bucket rung, so the first real tick
        already hits the cache (and the kernels' first-use work, a build
        or a check, falls here).  Replacing a name sweeps the old model's
        plans first.  ``"auto"`` is refused until the optimizer is ported
        (ROADMAP queue 1, item 10)."""
        algorithm = algorithm or self.default_algorithm
        plan = plan or self.default_plan
        if algorithm == "auto" or plan == "auto":
            raise NotImplementedError(_AUTO_REFUSED)
        mid = fingerprint_forest(forest)
        m = ServedModel(name=name, forest=forest, model_id=mid,
                        algorithm=algorithm, plan=plan)
        with self._engine_lock:
            old = self._models.get(name)
            if old is not None and old.pending:
                raise RuntimeError(
                    f"model {name!r} has {len(old.pending)} pending requests")
            if old is not None:
                self.qe.invalidate(old.model_id)
            self.store.put_model(name, forest, fingerprint=mid,
                                 algorithm=algorithm, plan=plan)
            with self._lock:
                self._models[name] = m
        if warmup:
            self.warmup(name)
        return m

    def register_from_catalog(self, name: str, *,
                              algorithm: str | None = None,
                              plan: str | None = None,
                              warmup: bool = True) -> ServedModel:
        """Serve a model already pinned in the store's model catalog (the
        in-database trainer's handoff).  Catalog metadata supplies the
        algorithm / plan where recorded; explicit arguments win."""
        forest = self.store.get_model(name)
        meta = self.store.model_catalog().get(name, {})
        return self.register_model(
            name, forest,
            algorithm=algorithm or meta.get("algorithm"),
            plan=plan or meta.get("plan"),
            warmup=warmup)

    def warmup(self, name: str) -> int:
        """Build (or re-touch) one plan per bucket rung for ``name``.
        Returns the plan-cache MISSES the warmup paid: 0 means every rung
        was already resident."""
        m = self._get(name)
        misses = 0
        for b in self.buckets:
            x = np.zeros((b, m.forest.n_features), np.float32)
            with self._engine_lock:
                res = self.qe.infer_rows(m.forest, x, algorithm=m.algorithm,
                                         plan=m.plan, model_id=m.model_id)
            misses += int(not res.plan_reuse_hit)
        return misses

    def unregister_model(self, name: str) -> int:
        """Drop a tenant: unpin it from the store's catalog and sweep its
        plans and materializations.  Returns the entries swept.  Refuses
        while requests are pending."""
        with self._engine_lock:
            with self._lock:
                m = self._get(name)
                if m.pending:
                    raise RuntimeError(
                        f"model {name!r} has {len(m.pending)} pending "
                        f"requests")
                self._models.pop(name, None)
            self.store.drop_model(name)
            return self.qe.invalidate(m.model_id)

    def models(self) -> dict[str, dict[str, Any]]:
        """Tenant catalog view (mirrors ``store.model_catalog()``)."""
        return {n: dict(algorithm=m.algorithm, plan=m.plan,
                        fingerprint=m.model_id, pending=len(m.pending))
                for n, m in self._models.items()}

    def _get(self, name: str) -> ServedModel:
        try:
            return self._models[name]
        except KeyError:
            raise KeyError(f"model {name!r} not registered; "
                           f"have {sorted(self._models)}") from None

    def _tenants(self) -> list[ServedModel]:
        with self._lock:
            return list(self._models.values())

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------
    def submit(self, model: str, rows, *, priority: int | None = None,
               timeout_s: float | None = None) -> ForestRequest:
        """Queue a request ([F] single row or [k, F] small batch) for
        ``model``.  ``priority=None`` lets the ``ForestRouter`` (when
        configured) pick the tier from request features with the live
        ``serve.queue_depth`` load; without a router it is
        ``TIER_INTERACTIVE``.  ``req.wait()`` blocks for the predictions."""
        m = self._get(model)
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        if rows.shape[1] != m.forest.n_features:
            raise ValueError(
                f"request has {rows.shape[1]} features, model {model!r} "
                f"expects {m.forest.n_features}")
        if rows.shape[0] > self.buckets[-1]:
            raise ValueError(
                f"request of {rows.shape[0]} rows exceeds the largest "
                f"bucket ({self.buckets[-1]}); use infer() for scans")
        if priority is None:
            if self.router is not None:
                feats = request_features(
                    rows.shape[0], 1, None, len(self._models),
                    self._width_h.mean if self._width_h.count else 0.0)
                priority = int(self.router.route(feats))
            else:
                priority = TIER_INTERACTIVE
        with self._lock:
            if self._models.get(model) is not m:
                raise KeyError(f"model {model!r} was unregistered")
            self._uid += 1
            req = ForestRequest(uid=self._uid, model=model, rows=rows,
                                priority=priority, timeout_s=timeout_s,
                                submitted_at=time.perf_counter())
            # interactive requests queue at the FRONT, so the next flush
            # carries them
            if priority == TIER_INTERACTIVE:
                m.pending.appendleft(req)
            else:
                m.pending.append(req)
        m.metrics.counter("serve.requests").inc()
        METRICS.counter(QUEUE_DEPTH_METRIC).inc()
        return req

    def predict(self, model: str, rows, *,
                timeout: float | None = 30.0, **kw) -> np.ndarray:
        """Blocking convenience: submit + wait.  Without a running ticker
        the queue is drained synchronously."""
        req = self.submit(model, rows, **kw)
        if not self._running.is_set():
            self.drain()
        return req.wait(timeout)

    # ------------------------------------------------------------------
    # coalescer
    # ------------------------------------------------------------------
    def _shed_timed_out(self, m: ServedModel, now: float) -> None:
        """Demote interactive requests whose wait reached ``timeout_s`` to
        the batch tier (queue BACK, ``shed`` flagged): they stop pulling
        the short interactive deadline and wait like batch-tier work."""
        with self._lock:
            kept, shed = [], []
            for req in m.pending:
                if (req.timeout_s is not None
                        and req.priority == TIER_INTERACTIVE
                        and now - req.submitted_at >= req.timeout_s):
                    req.priority = TIER_BATCH
                    req.shed = True
                    shed.append(req)
                else:
                    kept.append(req)
            if shed:
                m.pending.clear()
                m.pending.extend(kept + shed)
        for req in shed:
            m.metrics.counter("serve.shed").inc()
            TRACER.event("serve.shed", uid=req.uid)

    def _due(self, m: ServedModel, now: float) -> bool:
        """Flush policy: a full largest bucket flushes any queue; else the
        oldest INTERACTIVE request flushes at the short deadline, and a
        batch-only queue (which waits for full buckets) at the long one,
        so a lone request never starves."""
        with self._lock:
            if not m.pending:
                return False
            if sum(r.num_rows for r in m.pending) >= self.buckets[-1]:
                return True
            interactive = [r.submitted_at for r in m.pending
                           if r.priority == TIER_INTERACTIVE]
            if interactive:
                return now - min(interactive) >= self.interactive_deadline_s
            oldest = min(r.submitted_at for r in m.pending)
            return now - oldest >= self.batch_deadline_s

    def _select(self, m: ServedModel) -> list[ForestRequest]:
        """Pop a FIFO prefix of the queue that fits the largest bucket
        (requests are never split across ticks, and row order within and
        across requests is kept)."""
        batch: list[ForestRequest] = []
        total = 0
        with self._lock:
            while m.pending and \
                    total + m.pending[0].num_rows <= self.buckets[-1]:
                req = m.pending.popleft()
                batch.append(req)
                total += req.num_rows
        return batch

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _flush(self, m: ServedModel, now: float) -> int:
        """Coalesce one padded batch for ``m`` and serve it through
        ``infer_rows``.  Returns rows served (0 if the queue was empty).
        A failure is recorded on every waiter and re-raised."""
        with self._engine_lock:
            batch = self._select(m)
            if not batch:
                return 0
            n = sum(r.num_rows for r in batch)
            bucket = self._bucket(n)
            with TRACER.span("serve.tick", model=m.name,
                             requests=len(batch), rows=n,
                             bucket=bucket) as sp:
                with TRACER.span("serve.coalesce", model=m.name):
                    x = np.zeros((bucket, int(m.forest.n_features)),
                                 np.float32)
                    mask = np.zeros(bucket, bool)
                    off = 0
                    for req in batch:
                        x[off:off + req.num_rows] = req.rows
                        mask[off:off + req.num_rows] = True
                        off += req.num_rows
                        req.admitted_at = now
                        m.metrics.histogram("serve.queue_wait_s").record(
                            now - req.submitted_at)
                for reg in (m.metrics, self.metrics):
                    reg.counter("serve.ticks").inc()
                    reg.counter("serve.padding_rows").inc(bucket - n)
                    reg.histogram("serve.coalesce_width",
                                  bounds=self._width_bounds).record(n)
                METRICS.counter(QUEUE_DEPTH_METRIC).inc(-len(batch))
                try:
                    res = self.qe.infer_rows(
                        m.forest, x, row_mask=mask, algorithm=m.algorithm,
                        plan=m.plan, model_id=m.model_id)
                    out = res.predictions.cpu().numpy()
                except BaseException as e:   # re-raised below, and by
                    self.last_error = e      # every waiter's .wait()
                    for req in batch:
                        req.error = e
                        req.done.set()
                    raise
                m.metrics.counter("serve.plan_hits" if res.plan_reuse_hit
                                  else "serve.plan_misses").inc()
                sp.set(plan_hit=res.plan_reuse_hit)
                done_at = time.perf_counter()
                off = 0
                for req in batch:
                    req.predictions = out[off:off + req.num_rows].copy()
                    off += req.num_rows
                    req.finished_at = done_at
                    m.metrics.histogram("serve.e2e_latency_s").record(
                        done_at - req.submitted_at)
                    req.done.set()
        return n

    def tick(self, now: float | None = None, force: bool = False) -> int:
        """One coalescer pass over every model: shed lapsed admission
        timeouts, then flush every due queue (every non-empty one with
        ``force``).  Returns rows served.  The ticker thread calls this in
        a loop; synchronous callers drive it directly.

        Without ``now`` the clock is read again before each flush (the
        reference reads it once a pass), so a request that arrived during
        an earlier flush of the pass is never admitted before it was
        submitted: its queue wait is never negative."""
        clock = time.perf_counter if now is None else (lambda: now)
        served = 0
        for m in self._tenants():
            self._shed_timed_out(m, clock())
            while m.pending:
                t = clock()
                if not (force or self._due(m, t)):
                    break
                served += self._flush(m, t)
        return served

    def drain(self, max_ticks: int = 10_000) -> int:
        """Force-flush until every queue is empty (synchronous callers).
        Returns rows served."""
        served = 0
        for _ in range(max_ticks):
            if not any(m.pending for m in self._tenants()):
                break
            served += self.tick(force=True)
        return served

    # ------------------------------------------------------------------
    # ticker thread
    # ------------------------------------------------------------------
    def start(self) -> None:
        """Start the ticker thread (idempotent)."""
        if self._running.is_set():
            return
        self._running.set()

        def loop():
            while self._running.is_set():
                try:
                    if self.tick() == 0:
                        time.sleep(self.tick_interval_s)
                except Exception:   # noqa: BLE001 -- _flush recorded it on
                    # last_error and the batch's requests; keep serving
                    # the other tenants
                    time.sleep(self.tick_interval_s)

        self._ticker = threading.Thread(target=loop, daemon=True,
                                        name="forest-serve-tick")
        self._ticker.start()

    def stop(self) -> None:
        """Stop the ticker thread and join it (queued work stays queued:
        ``drain()`` finishes it synchronously)."""
        if not self._running.is_set():
            return
        self._running.clear()
        if self._ticker is not None:
            self._ticker.join(timeout=5.0)
            self._ticker = None

    def __enter__(self) -> "ForestServeEngine":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def stats(self, model: str | None = None) -> dict[str, Any]:
        """Per-model serving stats (or, with ``model=None``, the engine
        rollup plus every tenant's row).  Percentiles come from the
        per-model histograms."""
        if model is not None:
            m = self._get(model)
            qw = m.metrics.histogram("serve.queue_wait_s")
            e2e = m.metrics.histogram("serve.e2e_latency_s")
            cw = m.metrics.histogram("serve.coalesce_width",
                                     bounds=self._width_bounds)
            return {
                "requests": m.metrics.counter("serve.requests").value,
                "ticks": m.metrics.counter("serve.ticks").value,
                "shed": m.metrics.counter("serve.shed").value,
                "plan_hits": m.metrics.counter("serve.plan_hits").value,
                "plan_misses":
                    m.metrics.counter("serve.plan_misses").value,
                "padding_rows":
                    m.metrics.counter("serve.padding_rows").value,
                "pending": len(m.pending),
                "mean_coalesce_width": cw.mean if cw.count else 0.0,
                "p50_queue_wait_s": qw.percentile(50),
                "p99_queue_wait_s": qw.percentile(99),
                "p50_latency_s": e2e.percentile(50),
                "p99_latency_s": e2e.percentile(99),
            }
        return {
            "models": len(self._models),
            "queue_depth": METRICS.counter(QUEUE_DEPTH_METRIC).value,
            "ticks": self.metrics.counter("serve.ticks").value,
            "padding_rows":
                self.metrics.counter("serve.padding_rows").value,
            "mean_coalesce_width":
                self._width_h.mean if self._width_h.count else 0.0,
            "per_model": {n: self.stats(n) for n in list(self._models)},
        }
