"""Streaming scan executor: the one batch loop of every plan and tier (torch).

Mirrors ``repro/db/executor.py``.  A source is a ``ScanSource``:
``page_slice`` (a page range in its own tier), ``empty_block`` /
``first_pages`` (its page buffers), ``read_pages`` (the disk tier's read
into staging) and ``to_device`` (the copy onto the device), so the loop
never asks where pages live, nor how a block is laid out: one [rows, F]
array for a dense table, three page arrays (``CSRPages``) for a sparse
one.  Each batch is a contiguous page range (``batch_plan``,
deterministic: batch k always covers the same pages), run through the
compiled plan's stages; its predictions land at the batch's own slot of a
preallocated result buffer -- no concatenate.

Device tier: the page range is a view, the result buffer lives on the
card, and nothing is copied (``bytes_streamed == 0``).

Host and disk tiers stream through at most ``MAX_IN_FLIGHT = 2`` device
page buffers, preallocated per scan (a buffer holds one device array per
block array: three for CSR pages; the disk tier has as many staging
arrays, pinned on the card; every copy of a batch is ordered by its one
copy event, and ``bytes_streamed`` counts all of them).  With
``prefetch_depth=2`` on a CUDA store:

    batch i+1   its pages go H2D on a dedicated copy stream,
                ``non_blocking`` from pinned memory, and record a copy
                event.  Host tier: the copy is issued from the store's
                pinned pages before batch i's stages start (it needs no
                host work).  Disk tier: a READER THREAD reads the memmap
                view into one of two pinned staging buffers and issues the
                H2D from there, so that the host read overlaps batch i's
                stages (they synchronise at their boundary, so a read on
                their thread would overlap nothing)
    batch i     the compute stream waits on batch i's copy event, then the
                stages run on the caller's thread
    batch i-1   its predictions go D2H on a drain stream, ordered after
                the compute, into a preallocated PINNED host result
                buffer; batch i's stages do not wait for it, and the scan
                synchronises the drain once, at its end

A page buffer is refilled only after the drain of the batch that used it
(its release event, recorded on the drain stream, orders the next copy
into it; a staging buffer is refilled once its last H2D has finished),
and each prediction is ``record_stream``-ed on the drain stream, so the
caching allocator never gives memory in use by one stream to another.
The reader thread is shut down on every exit, a raising stage included,
and its errors are raised again on the caller's thread.

``prefetch_depth=1`` is the synchronous reference pipeline: one buffer,
the copy and the drain inline and waited for.  It is bit-identical to
depth 2.  On a ``device="cpu"`` store there are no streams: the copies
are synchronous and the drain is inline (``drain_async`` and
``pinned_staging`` are false), while the loop, the disk tier's reader
thread, the batch plan and the buffer bound are the same.

Reduction scans (the trainer, ``db/train.py``; reference ``executor.py:
465-494``): ``execute(extras=, on_batch=)`` merges per-batch inputs into
the stages' initial state and calls a hook on the stages' thread after
each batch's stages, before its drain, in plan order; a scan made with
``result_key=None`` has no result buffer and no drain (on the card its
page buffer is released on the compute stream after the hook).  The
result buffer takes the dtype of the first batch's result (the trainer's
int32 node-of frontier).

Faults (``db/faults.py``; the reference's ladders, ``executor.py:
505-825``).  A scan made with an ``injector`` / ``retry_policy`` guards
its five sites, on every tier; with neither, each site is a direct call.
The plan is ONE deque of page spans, owned by the thread that acquires
pages: the reader thread of a pageable depth-2 scan, the caller's
otherwise; the stages take loaded batches until the acquiring side says
the plan is done.  Two ladders reorder or split it, and every row still
lands at its deterministic slot:

  ``disk_page_read``  the disk tier's read into staging (``scan.
                      disk_read``); exhausted, the span goes ONCE to the
                      back of the plan, then fails as ``ScanFault`` with
                      ``2 x max_attempts`` attempts
  ``page_dma_in``     the copy onto the device (``scan.dma_in``; the
                      device tier's page view); exhausted, the span is
                      split in halves at the front of the plan (into the
                      same preallocated buffers), down to
                      ``min_batch_pages``, then ``ScanFault``
  ``kernel_launch``   the batch's stages; exhausted: ``ScanFault``
  ``drain_copy_out``  the batch's write into the result buffer (the D2H
                      enqueue on the card); exhausted: ``ScanFault``
  ``drain_worker``    fired once a drained batch where the reference's
                      drain thread takes the item (depth >= 2, more than
                      one planned batch), never retried.  The port has no
                      drain thread: a firing synchronises the drain
                      stream, and this batch's and every later batch's
                      D2H are waited for, as at depth 1
                      (``degraded_to_sync``).  The page prefetch keeps
                      its depth, where the reference's loop drops to
                      depth 1 (``:567-578``): the port's page copies do
                      not wait on the drain.

A guarded attempt fires before it enqueues anything on a stream, so a
failed one records no copy, release or drain event.  ``ScanFault``
carries ``rows_completed``, the rows whose drain was enqueued (landed by
the time it reaches the caller: every exit synchronises both streams).
A ``deadline`` is read once per batch at the top of the loop (and inside
retries): expired, the scan stops, keeps what it drained (the result is
NaN-filled and a row mask kept only when a deadline is set), and
``last_mask`` marks the rows that landed.

The mesh (reference ``executor.py:281-287, 396-411``): a scan made with a
``sharding`` (the store's ``data_sharding()``, a ``db.shards.RowSharding``)
splits each loaded batch into its ``data``-axis row shards, each on its
home device, right after the compute stream waits for the batch's pages;
the stages see ``RowShards``, and a plan's last stage gathers the
per-shard predictions at the store's device in row order, so the drain
writes one tensor a batch as it does off-mesh.  Batches are whole
data-axis units (the query rounds them), and the caller passes the unit
as ``min_batch_pages``, the floor of the transfer-halving ladder, so a
halved span still splits evenly.

Tracing (``repro_torch.obs``; the reference's spans, ``executor.py:
589-803``).  Every scan is one ``scan.execute`` span, and each batch one
``scan.batch`` with ``scan.transfer_wait``, ``scan.compute`` and
``scan.drain_submit`` under it; each page load is a ``scan.dma_in`` (and
on the disk tier a ``scan.disk_read``, the read into staging) parented to
``scan.execute``, explicitly, since the reader thread issues it; a failed
load attempt has its spans too.  A batch's ``scan.drain_write`` is
parented to its ``scan.batch``.  Over a CUDA store it is a DEVICE span,
the interval between the drain's CUDA events on the ``cuda:drain`` track:
with tracing on, the scan records one anchor event on the compute stream
at its start, waits for it and reads ``perf_counter_ns``, and maps each
drain event onto that clock through ``anchor.elapsed_time(event)``; the
spans are published once the drain has been synchronised.  Elsewhere the
drain_write is a host span around the copy.  The fault events land on
the query's spans on either thread (``batch.resubmit`` on
``scan.execute``), except ``drain_worker``'s ``fault.injected``, which is
free-standing, as on the reference's drain thread.  The ``scan.*``
counters are counted on every exit, a raising stage included.  With
tracing off every site is ``NULL_SPAN``: no anchor, no event, no
synchronise is added.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Iterator, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.db.faults import (Deadline, DeadlineExceeded, FaultInjector,
                                   InjectedFault, RetryPolicy, ScanFault)
from repro_torch.db.operators import StageReport, run_stages
from repro_torch.obs import METRICS, TRACER

__all__ = ["ScanSource", "ScanStats", "StreamingScanExecutor",
           "MAX_IN_FLIGHT", "DEFAULT_STREAM_BATCH_BYTES"]

#: hard ceiling on simultaneously live page buffers: the one being
#: computed on plus the one being filled
MAX_IN_FLIGHT = 2

#: default per-batch footprint of an off-device scan on a store with no
#: ``device_budget_bytes``: an explicit host or disk ingest must still
#: stream, never go to the device whole
DEFAULT_STREAM_BATCH_BYTES = 64 << 20

#: seconds the scan waits for its reader thread to stop
READER_JOIN_S = 60.0


@runtime_checkable
class ScanSource(Protocol):
    """What the executor needs from a stored dataset, on any tier."""

    name: str
    tier: str                        # "device" | "host" | "disk"
    num_rows: int                    # true N (pre-padding)
    device: torch.device             # where the stages compute

    @property
    def num_pages(self) -> int: ...

    @property
    def page_rows(self) -> int: ...

    @property
    def num_features(self) -> int: ...

    @property
    def pageable(self) -> bool:
        """Pages a copy to the card cannot read asynchronously (the disk
        tier): the scan reads them into staging buffers first."""
        ...

    def page_slice(self, first_page: int, num_pages: int) -> Any:
        """Contiguous page range in the source's OWN tier, a view."""
        ...

    def empty_block(self, num_pages: int, *, device=None,
                    pin_memory: bool = False) -> Any:
        """An uninitialised block of ``num_pages`` pages on ``device``, or
        in (pinned) host memory: the scan's page and staging buffers."""
        ...

    def first_pages(self, block: Any, num_pages: int) -> Any:
        """The first ``num_pages`` pages of a block, a view."""
        ...

    def read_pages(self, block: Any, out: Any) -> Any:
        """Read a page block into the host block ``out``."""
        ...

    def to_device(self, block: Any, out: Any) -> Any:
        """Copy a host block into the device buffer ``out`` on the current
        stream."""
        ...


@dataclasses.dataclass
class ScanStats:
    """Per-query scan telemetry (attached to ``QueryResult.scan``), with
    the reference's meanings.  Host clocks, except ``drain_s`` on the
    card (CUDA events on the drain stream)."""

    tier: str                        # source tier the scan ran against
    batches: int                     # page batches executed
    batch_pages: int                 # pages per (full) batch as planned
    prefetch_depth: int              # 1 = synchronous, 2 = double-buffered
    max_in_flight: int = 0           # peak live page buffers (<= 2)
    bytes_streamed: int = 0          # off-device -> device bytes copied
    transfer_issue_s: float = 0.0    # time spent issuing the page copies
    #                                  (disk tier: with the staging reads)
    transfer_wait_s: float = 0.0     # EXPOSED wait of the stages' thread
    #                                  for a batch's pages to be on the
    #                                  device (what double-buffering hides;
    #                                  issuing later batches' loads is not
    #                                  counted)
    compute_s: float = 0.0           # stage time, synchronised
    drain_s: float = 0.0             # result-buffer writes; on the card
    #                                  the D2H device time
    drain_wait_s: float = 0.0        # host time BLOCKED on the drain (its
    #                                  exposed cost)
    drain_async: bool = False        # D2H on the drain stream, waited once
    pinned_staging: bool = False     # H2D from and D2H to pinned memory
    wall_s: float = 0.0              # whole scan loop
    # -- the fault plane (db/faults.py) -------------------------------------
    retries: int = 0                 # retry re-attempts across all sites
    faults_injected: int = 0         # injector fires during this scan
    degraded_to_sync: bool = False   # drain_worker fired: the rest of the
    #                                  scan drained synchronously
    batch_resubmits: int = 0         # spans re-enqueued (disk ladder) or
    #                                  halved (transfer ladder)
    deadline_hit: bool = False       # stopped at its deadline: a PARTIAL

    @property
    def drain_overlap_s(self) -> float:
        """Drain work hidden behind compute: drain time minus the exposed
        drain wait (0 for the inline drain, which waits on every write)."""
        return max(0.0, self.drain_s - self.drain_wait_s)


@dataclasses.dataclass
class _InFlight:
    """One loaded batch: its page span, its page buffer and its block (on
    the device: a buffer's first pages, or the device tier's view)."""

    first_page: int
    num_pages: int
    k: int
    block: Any


class StreamingScanExecutor:
    """Runs compiled plan stages over a ``ScanSource`` page batch by page
    batch; the last stage leaves the per-row result at ``result_key``
    (``"pred"``; None for a scan whose product flows through
    ``execute``'s ``on_batch``: no result buffer, no drain).

    ``injector`` / ``retry_policy`` / ``deadline`` opt the scan into the
    fault plane (an armed injector with no policy gets ``RetryPolicy()``);
    ``min_batch_pages`` is the floor of the transfer-halving ladder, and
    ``sharding`` splits each batch over a mesh's ``data`` axis (module
    note).  ``last_mask`` is the row mask of the last ``execute`` that hit its
    deadline (None otherwise)."""

    def __init__(self, stages, *, sharding=None, prefetch_depth: int = 2,
                 result_key: str | None = "pred",
                 injector: FaultInjector | None = None,
                 retry_policy: RetryPolicy | None = None,
                 deadline: Deadline | None = None,
                 min_batch_pages: int = 1):
        if not 1 <= prefetch_depth <= MAX_IN_FLIGHT:
            raise ValueError(f"prefetch_depth must be in [1, "
                             f"{MAX_IN_FLIGHT}], got {prefetch_depth}")
        self.stages = stages
        self.sharding = sharding
        self.prefetch_depth = prefetch_depth
        self.result_key = result_key
        self.injector = injector
        self.retry_policy = retry_policy if retry_policy is not None \
            else (RetryPolicy() if injector is not None else None)
        self.deadline = deadline
        self.min_batch_pages = max(1, int(min_batch_pages))
        self.last_mask: np.ndarray | None = None

    @staticmethod
    def batch_plan(num_pages: int, batch_pages: int
                   ) -> Iterator[tuple[int, int, int]]:
        """Deterministic (batch_index, first_page, num_pages) plan; the
        fault ladders only reorder or split it."""
        if batch_pages < 1:
            raise ValueError(f"batch_pages must be >= 1, got {batch_pages}")
        for k, first in enumerate(range(0, num_pages, batch_pages)):
            yield k, first, min(batch_pages, num_pages - first)

    def execute(self, source: ScanSource, batch_pages: int, *,
                extras=None, on_batch=None
                ) -> tuple[torch.Tensor | None, list[StageReport],
                           ScanStats]:
        """Stream every page batch of ``source`` through the stages.

        Returns (predictions [num_rows], per-batch stage reports, stats).
        Pad rows past ``num_rows`` are scored like any row and cut off.
        The predictions of a device-tier scan stay on the device; those
        of a host- or disk-tier scan land in host memory (pinned on the
        card), in the dtype of the batches' results.  An exhausted ladder
        raises ``ScanFault``; an expired deadline returns the partial
        buffer with ``stats.deadline_hit`` and ``last_mask``.

        Two hooks open the loop to reduction scans (the trainer,
        ``db/train.py``; reference ``executor.py:465-494``), both off by
        default:

          * ``extras(first_page, num_pages) -> dict``: per-batch inputs
            merged into the stages' initial state beside ``"x"``;
          * ``on_batch(first_page, num_pages, state)``: called on the
            stages' thread after the stages and before the drain, in plan
            order.  With no injector the plan is never reordered or
            split, so the hook sees every batch once, in global row
            order: an order-sensitive reduction runs with the fault
            ladders off.

        With ``result_key=None`` the result is None."""
        plan = [(first, n) for _, first, n in
                self.batch_plan(source.num_pages, batch_pages)]
        if not plan:
            raise ValueError(f"dataset {source.name!r} has no pages")
        stats = ScanStats(tier=source.tier, batches=0,
                          batch_pages=batch_pages,
                          prefetch_depth=self.prefetch_depth)
        injector = self.injector
        fired0 = injector.total_fired if injector is not None else 0
        t_wall = time.perf_counter()
        with TRACER.span("scan.execute", tier=source.tier,
                         batch_pages=batch_pages,
                         prefetch_depth=self.prefetch_depth) as scan_span:
            try:
                scan = _Scan(self, source, plan, batch_pages, stats,
                             scan_span, extras, on_batch)
                out, reports = scan.run()
            finally:
                # counted on every exit: a failed scan still counts
                if injector is not None:
                    stats.faults_injected = injector.total_fired - fired0
                scan_span.set(batches=stats.batches,
                              bytes_streamed=stats.bytes_streamed,
                              retries=stats.retries,
                              batch_resubmits=stats.batch_resubmits,
                              degraded_to_sync=stats.degraded_to_sync,
                              deadline_hit=stats.deadline_hit)
                for name, v in (
                        ("scan.batches", stats.batches),
                        ("scan.bytes_streamed", stats.bytes_streamed),
                        ("scan.retries", stats.retries),
                        ("scan.batch_resubmits", stats.batch_resubmits),
                        ("scan.faults_injected", stats.faults_injected),
                        ("scan.degraded_to_sync", stats.degraded_to_sync),
                        ("scan.deadline_hits", stats.deadline_hit)):
                    METRICS.counter(name).inc(int(v))
        stats.wall_s = time.perf_counter() - t_wall
        self.last_mask = (scan.mask[: source.num_rows]
                          if stats.deadline_hit else None)
        if out is None:
            return None, reports, stats
        return out[: source.num_rows], reports, stats


class _Scan:
    """One ``execute``: the plan deque and its ladders, the page buffers,
    streams and reader thread it owns (all released when ``run`` returns
    or raises), the result buffer and the drain."""

    def __init__(self, executor: StreamingScanExecutor, source, plan,
                 batch_pages: int, stats: ScanStats, scan_span,
                 extras=None, on_batch=None):
        self.stages = executor.stages
        self.sharding = executor.sharding
        self.result_key = executor.result_key
        self.extras = extras
        self.on_batch = on_batch
        self.injector = executor.injector
        self.policy = policy = executor.retry_policy
        self.deadline = executor.deadline
        self.unit = executor.min_batch_pages
        self.retryable = (policy.retryable if policy is not None
                          else (InjectedFault, OSError))
        self.attempts = policy.max_attempts if policy is not None else 1
        self.scan_span = scan_span
        self.source = source
        self.stats = stats
        self.R = source.page_rows
        self.pending: deque[tuple[int, int]] = deque(plan)
        self.resubmitted: set[tuple[int, int]] = set()
        # a one-batch scan needs one buffer, whatever the depth
        self.depth = min(executor.prefetch_depth, len(plan))
        # where the reference's drain thread runs: its drain_worker site
        # (a scan with no result has no drain)
        self.async_drain = self.depth > 1 and self.result_key is not None
        self.degraded = False
        self.resident = source.tier == "device"
        self.loads = 0                   # batches loaded (buffer rotation)
        self.live = 0
        self.rows_written = 0            # padded rows whose drain was issued
        self.result: torch.Tensor | None = None
        # the rows that landed, kept only for a deadline's partial result
        self.mask = (np.zeros(source.num_pages * self.R, bool)
                     if self.deadline is not None else None)
        self.lock = threading.Lock()
        dev = source.device
        self.cuda = dev.type == "cuda" and not self.resident
        self.staging = None
        if self.resident:
            return
        self.bufs = [source.empty_block(batch_pages, device=dev)
                     for _ in range(self.depth)]
        if source.pageable:
            self.staging = [source.empty_block(batch_pages,
                                               pin_memory=self.cuda)
                            for _ in range(self.depth)]
        if self.cuda:
            self.compute_stream = torch.cuda.current_stream(dev)
            self.copy_stream = torch.cuda.Stream(dev)
            self.drain_stream = torch.cuda.Stream(dev)
            # the buffers were allocated on the compute stream: the first
            # copies into them are ordered after it
            self.copy_stream.wait_stream(self.compute_stream)
            self.copied = [torch.cuda.Event() for _ in range(self.depth)]
            self.released = [torch.cuda.Event() for _ in range(self.depth)]
            # per batch: (start, end, first_page, num_pages, batch span)
            self.drain_events: list[tuple] = []
            stats.pinned_staging = True
            stats.drain_async = self.depth > 1
            # the clock anchor of the device spans, taken only when tracing
            self.anchor: torch.cuda.Event | None = None
            if TRACER.enabled:
                self.anchor = torch.cuda.Event(enable_timing=True)
                self.anchor.record(self.compute_stream)
                self.anchor.synchronize()
                self.anchor_ns = time.perf_counter_ns()

    # -- the fault sites --------------------------------------------------
    def _guard(self, fn, site: str):
        """``fn()`` at ``site`` under the retry policy; a direct call with
        none (an injector always comes with one)."""
        if self.policy is None:
            return fn()
        return self.policy.run(fn, site=site, injector=self.injector,
                               on_retry=self._count_retry,
                               deadline=self.deadline)

    def _count_retry(self) -> None:
        with self.lock:                  # both threads retry
            self.stats.retries += 1

    @property
    def rows_completed(self) -> int:
        return min(self.rows_written, self.source.num_rows)

    def _resubmit(self, site: str, first: int, n: int) -> None:
        self.stats.batch_resubmits += 1
        # on scan.execute from either thread (the reader holds no span)
        self.scan_span.event("batch.resubmit", site=site, first_page=first,
                             num_pages=n)

    def _expired(self) -> bool:
        """The deadline, read once a batch iteration."""
        if self.deadline is not None and self.deadline.expired:
            self._deadline_hit()
            return True
        return False

    def _deadline_hit(self) -> None:
        self.stats.deadline_hit = True
        TRACER.event("deadline.hit")

    # -- the pages --------------------------------------------------------
    def _transfer(self, first: int, n: int, k: int, staged) -> Any:
        """Pages [first, first + n) on the device: the device tier's view,
        else a copy into page buffer k (from ``staged`` on the disk tier),
        issued on the copy stream on the card."""
        source = self.source
        if self.resident:
            return source.page_slice(first, n)
        block = staged if staged is not None else source.page_slice(first, n)
        out = source.first_pages(self.bufs[k], n)
        if not self.cuda:
            return source.to_device(block, out)
        self.copy_stream.wait_event(self.released[k])
        with torch.cuda.stream(self.copy_stream):
            source.to_device(block, out)
            self.copied[k].record(self.copy_stream)
        return out

    def _load(self, k: int) -> _InFlight | None:
        """The plan's first span into page buffer k, through the
        ``disk_page_read`` and ``page_dma_in`` sites.  None when a ladder
        re-enqueued or split the span instead."""
        first, n = self.pending[0]
        source = self.source
        pages = dict(first_page=first, num_pages=n)
        t0 = time.perf_counter()
        staged = None
        if self.staging is not None:            # the disk tier
            staged = source.first_pages(self.staging[k], n)
            if self.cuda:
                self.copied[k].synchronize()     # its last H2D finished
            try:
                with TRACER.span("scan.disk_read", parent=self.scan_span,
                                 **pages):
                    self._guard(lambda: source.read_pages(
                        source.page_slice(first, n), staged),
                        "disk_page_read")
            except DeadlineExceeded:
                raise
            except self.retryable as e:
                # the disk ladder: once to the back of the plan
                self.pending.popleft()
                if (first, n) in self.resubmitted:
                    raise ScanFault("disk_page_read",
                                    attempts=2 * self.attempts,
                                    rows_completed=self.rows_completed,
                                    cause=e) from e
                self.resubmitted.add((first, n))
                self.pending.append((first, n))
                self._resubmit("disk_page_read", first, n)
                return None
        try:
            with TRACER.span("scan.dma_in", parent=self.scan_span, **pages):
                block = self._guard(
                    lambda: self._transfer(first, n, k, staged),
                    "page_dma_in")
        except DeadlineExceeded:
            raise
        except self.retryable as e:
            # the transfer ladder: halves at the front of the plan
            self.pending.popleft()
            if n <= self.unit:
                raise ScanFault("page_dma_in", attempts=self.attempts,
                                rows_completed=self.rows_completed,
                                cause=e) from e
            n1 = max(self.unit, (n // 2) // self.unit * self.unit)
            self.pending.appendleft((first + n1, n - n1))
            self.pending.appendleft((first, n1))
            self._resubmit("page_dma_in", first, n)
            return None
        self.pending.popleft()
        self.stats.transfer_issue_s += time.perf_counter() - t0
        if not self.resident:
            self.stats.bytes_streamed += block.nbytes
        with self.lock:
            self.live += 1
            self.stats.max_in_flight = max(self.stats.max_in_flight,
                                           self.live)
            if self.live > MAX_IN_FLIGHT:
                raise RuntimeError(f"{self.live} page buffers in flight "
                                   f"(max {MAX_IN_FLIGHT})")
        self.loads += 1
        return _InFlight(first, n, k, block)

    def _release(self) -> None:
        with self.lock:
            self.live -= 1

    def _read_ahead(self, free: queue.Queue, ready: queue.Queue) -> None:
        """The reader thread's body: it owns the plan, and fills each page
        buffer handed back on ``free`` with the plan's next span, putting
        (batch, last) on ``ready``, until the plan is done or ``free``
        gives None."""
        try:
            while self.pending:
                k = free.get()
                if k is None:
                    return
                cur = None
                while cur is None:
                    cur = self._load(k)
                ready.put((cur, not self.pending))
        except BaseException as e:  # noqa: BLE001 -- raised by the caller
            ready.put(e)

    # -- the predictions --------------------------------------------------
    def _result_buffer(self, dtype: torch.dtype,
                       device: torch.device) -> torch.Tensor:
        """The [num_pages * page_rows] result: on the device for the
        device tier, else in (pinned) host memory; NaN-filled when a
        deadline may leave rows unscored."""
        size = self.source.num_pages * self.R
        kw = (dict(device=device) if self.resident
              else dict(pin_memory=self.cuda))
        if self.mask is not None:
            return torch.full((size,), float("nan"), dtype=dtype, **kw)
        return torch.empty(size, dtype=dtype, **kw)

    def _write(self, cur: _InFlight, pred: torch.Tensor, batch_span) -> None:
        """One batch's predictions into their slot: a copy on the host or
        the device tier, a D2H on the drain stream on the card."""
        stats = self.stats
        if self.result is None:
            self.result = self._result_buffer(pred.dtype, pred.device)
        first, n = cur.first_page, cur.num_pages
        lo = first * self.R
        dst = self.result[lo: lo + n * self.R]
        if not self.cuda:
            t0 = time.perf_counter()
            with TRACER.span("scan.drain_write", parent=batch_span,
                             first_page=first, num_pages=n):
                dst.copy_(pred)
            dt = time.perf_counter() - t0
            stats.drain_s += dt
            stats.drain_wait_s += dt
            return
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        self.drain_stream.wait_stream(self.compute_stream)
        with torch.cuda.stream(self.drain_stream):
            start.record(self.drain_stream)
            dst.copy_(pred, non_blocking=True)
            end.record(self.drain_stream)
            self.released[cur.k].record(self.drain_stream)
        self.drain_events.append((start, end, first, n, batch_span))
        pred.record_stream(self.drain_stream)
        if self.depth == 1 or self.degraded:   # the synchronous drain
            t0 = time.perf_counter()
            end.synchronize()
            stats.drain_wait_s += time.perf_counter() - t0

    def _degrade(self) -> None:
        """The drain_worker ladder: the drain becomes synchronous for the
        rest of the scan, the D2Hs issued so far waited for first."""
        self.degraded = True
        self.stats.degraded_to_sync = True
        TRACER.event("degrade.sync_drain")
        if self.cuda:
            t0 = time.perf_counter()
            self.drain_stream.synchronize()
            self.stats.drain_wait_s += time.perf_counter() - t0

    def _drain(self, cur: _InFlight, pred: torch.Tensor, batch_span) -> None:
        """The ``drain_worker`` site, then the guarded write
        (``drain_copy_out``); the rows count as landed once it is
        issued."""
        if self.async_drain and not self.degraded \
                and self.injector is not None:
            try:
                with TRACER.detached():
                    self.injector.fire("drain_worker")
            except InjectedFault:
                self._degrade()
        try:
            self._guard(lambda: self._write(cur, pred, batch_span),
                        "drain_copy_out")
        except self.retryable as e:
            raise ScanFault("drain_copy_out", attempts=self.attempts,
                            rows_completed=self.rows_completed,
                            cause=e) from e
        lo = cur.first_page * self.R
        hi = lo + cur.num_pages * self.R
        if self.mask is not None:
            self.mask[lo:hi] = True
        self.rows_written += hi - lo

    def _finish_drain(self) -> None:
        """The scan's one drain synchronise, and the drain's device time."""
        if not self.cuda:
            return
        t0 = time.perf_counter()
        self.drain_stream.synchronize()
        self.stats.drain_wait_s += time.perf_counter() - t0
        self.stats.drain_s = sum(s.elapsed_time(e)
                                 for s, e, *_ in self.drain_events) / 1e3

    def _publish_drain_spans(self) -> None:
        """Each recorded D2H as a ``scan.drain_write`` device span under its
        batch, on the anchor's clock.  Called once the drain stream has
        been synchronised."""
        if self.anchor is None:
            return
        for start, end, first, n, batch_span in self.drain_events:
            TRACER._device_span(
                "scan.drain_write", batch_span,
                self.anchor_ns + round(self.anchor.elapsed_time(start) * 1e6),
                self.anchor_ns + round(self.anchor.elapsed_time(end) * 1e6),
                "cuda:drain", first_page=first, num_pages=n)

    # -- the loop ---------------------------------------------------------
    def _batch(self, take, reports: list[StageReport],
               waited: float = 0.0) -> _InFlight:
        """One batch under its span: ``take()`` gives its loaded pages (the
        exposed wait, with ``waited`` seconds of loading it on demand),
        then the guarded stages, then the drain."""
        stats = self.stats
        with TRACER.span("scan.batch", index=stats.batches) as batch_span:
            t0 = time.perf_counter()
            with TRACER.span("scan.transfer_wait"):
                cur = take()
                if self.cuda:
                    self.copied[cur.k].synchronize()
            stats.transfer_wait_s += waited + time.perf_counter() - t0
            pages = dict(first_page=cur.first_page, num_pages=cur.num_pages)
            batch_span.set(**pages)

            def launch():
                if self.cuda:
                    self.compute_stream.wait_event(self.copied[cur.k])
                x = cur.block
                if self.sharding is not None:
                    x = self.sharding.split(x)
                state = {"x": x}
                if self.extras is not None:
                    state.update(self.extras(cur.first_page, cur.num_pages))
                return run_stages(self.stages, state)

            t0 = time.perf_counter()
            try:
                with TRACER.span("scan.compute"):
                    state, reps = self._guard(launch, "kernel_launch")
            except self.retryable as e:
                raise ScanFault("kernel_launch", attempts=self.attempts,
                                rows_completed=self.rows_completed,
                                cause=e) from e
            stats.compute_s += time.perf_counter() - t0
            reports.extend(reps)
            stats.batches += 1
            if self.on_batch is not None:
                self.on_batch(cur.first_page, cur.num_pages, state)
            if self.result_key is None:
                state = None
                if self.cuda:                # no drain releases the buffer
                    self.released[cur.k].record(self.compute_stream)
            else:
                pred = state[self.result_key].reshape(-1)
                state = None                 # release the page buffer
                with TRACER.span("scan.drain_submit", **pages):
                    self._drain(cur, pred, batch_span)
        self._release()
        return cur

    def _run_inline(self, reports: list[StageReport]) -> None:
        """The caller's thread owns the plan (the reference's loop): load a
        batch when none is loaded (an exposed load), then batch i+1's pages
        before batch i's stages at depth 2."""
        loaded: deque[_InFlight] = deque()

        def load() -> bool:
            cur = self._load(self.loads % self.depth)
            if cur is not None:
                loaded.append(cur)
            return cur is not None

        while self.pending or loaded:
            if self._expired():
                break
            try:
                waited = 0.0
                if not loaded:
                    t0 = time.perf_counter()
                    if not load():
                        continue             # a ladder adjusted the plan
                    waited = time.perf_counter() - t0
                cur = loaded.popleft()
                while len(loaded) + 1 < self.depth and self.pending:
                    if not load():
                        break
                self._batch(lambda: cur, reports, waited)
            except DeadlineExceeded:
                self._deadline_hit()         # inside a retry
                break

    def _run_reader(self, reports: list[StageReport], free: queue.Queue,
                    ready: queue.Queue) -> None:
        """A reader thread owns the plan; batches come as it loads them.
        Batch i-1's buffer goes back to it as batch i starts, where the
        reference prefetches batch i+1, so a scan stopped at its deadline
        has loaded what the reference's has."""

        def take() -> _InFlight:
            got = ready.get()
            if isinstance(got, BaseException):
                raise got
            cur, done[0] = got
            return cur

        done = [False]
        handback = None
        while not done[0]:
            if self._expired():
                break
            if handback is not None:
                free.put(handback)
            try:
                handback = self._batch(take, reports).k
            except DeadlineExceeded:
                self._deadline_hit()         # inside a reader's retry
                break

    def run(self) -> tuple[torch.Tensor, list[StageReport]]:
        """Every batch, then the one drain synchronise.  Pageable pages at
        depth 2 are read ahead by a reader thread, since their host read
        is work to overlap with the stages."""
        reports: list[StageReport] = []
        reader = None
        failed: BaseException | None = None
        try:
            if self.depth > 1 and self.source.pageable:
                free: queue.Queue = queue.Queue()
                ready: queue.Queue = queue.Queue()
                for k in range(self.depth):
                    free.put(k)
                reader = threading.Thread(target=self._read_ahead,
                                          args=(free, ready),
                                          name="scan-reader", daemon=True)
                reader.start()
                self._run_reader(reports, free, ready)
            else:
                self._run_inline(reports)
            self._finish_drain()
        except BaseException as e:
            failed = e
            raise
        finally:
            if reader is not None:
                free.put(None)                 # wake a reader that waits
                reader.join(READER_JOIN_S)
            self._quiesce()
            if reader is not None and reader.is_alive():
                msg = "the scan's reader thread did not stop"
                if failed is None:
                    raise RuntimeError(msg)
                failed.add_note(msg)           # keep the error in flight
        if self.result is None and self.result_key is not None:
            # stopped before any drain
            self.result = self._result_buffer(torch.float32,
                                              self.source.device)
        return self.result, reports

    def _quiesce(self) -> None:
        """No stream still touches the scan's buffers when it returns or
        raises; the drained batches' device spans are published."""
        if self.cuda:
            self.copy_stream.synchronize()
            self.drain_stream.synchronize()
            self._publish_drain_spans()
