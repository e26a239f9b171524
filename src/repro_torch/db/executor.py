"""Streaming scan executor: the one batch loop of every plan and tier (torch).

Mirrors ``repro/db/executor.py``.  A source is a ``ScanSource``:
``page_slice`` (a page range in its own tier), ``empty_block`` /
``first_pages`` (its page buffers) and ``to_device`` (staging onto the
device), so the loop never asks where pages live, nor how a block is laid
out: one [rows, F] array for a dense table, three page arrays (``CSRPages``)
for a sparse one.  Each batch is a contiguous page range (``batch_plan``,
deterministic: batch k always covers the same pages), run through the
compiled plan's stages; its predictions land at the batch's own slot of a
preallocated result buffer -- no concatenate.

Device tier: the page range is a view, the result buffer lives on the
card, and nothing is copied (``bytes_streamed == 0``).

Host and disk tiers stream through at most ``MAX_IN_FLIGHT = 2`` device
page buffers, preallocated per scan (a buffer holds one device array per
block array: three for CSR pages, and the disk tier as many pinned staging
arrays; every copy of a batch is ordered by its one copy event, and
``bytes_streamed`` counts all of them).  With ``prefetch_depth=2`` on a
CUDA store:

    batch i+1   its pages go H2D on a dedicated copy stream,
                ``non_blocking`` from pinned memory, and record a copy
                event.  Host tier: the copy is issued from the store's
                pinned pages before batch i's stages start (it needs no
                host work).  Disk tier: a READER THREAD copies the memmap
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
into it), and each prediction is ``record_stream``-ed on the drain
stream, so the caching allocator never gives memory in use by one stream
to another.  The reader thread is shut down on every exit, a raising
stage included, and its errors are raised again on the caller's thread.

``prefetch_depth=1`` is the synchronous reference pipeline: one buffer,
the copy and the drain inline and waited for.  It is bit-identical to
depth 2.  On a ``device="cpu"`` store there are no streams: the copies
are synchronous and the drain is inline (``drain_async`` and
``pinned_staging`` are false), while the loop, the disk tier's reader
thread, the batch plan and the buffer bound are the same.

Tracing (``repro_torch.obs``; the reference's spans, ``executor.py:
589-741``).  Every scan is one ``scan.execute`` span, and each batch one
``scan.batch`` with ``scan.transfer_wait``, ``scan.compute`` and
``scan.drain_submit`` under it; each batch's page load is a
``scan.dma_in`` (and on the disk tier a ``scan.disk_read``) parented to
``scan.execute``, explicitly, since the reader thread issues it.  A
batch's ``scan.drain_write`` is parented to its ``scan.batch``.  Over a
CUDA store it is a DEVICE span, the interval between the drain's CUDA
events on the ``cuda:drain`` track: with tracing on, the scan records one
anchor event on the compute stream at its start, waits for it and reads
``perf_counter_ns``, and maps each drain event onto that clock through
``anchor.elapsed_time(event)``; the spans are published once the drain
has been synchronised.  Elsewhere the drain_write is a host span around
the copy.  ``scan.batches`` and ``scan.bytes_streamed`` are counted on
every exit, a raising stage included.  With tracing off every site is
``NULL_SPAN``: no anchor, no event, no synchronise is added.

Not ported yet: the fault-injection sites, retry ladders and deadlines
(ROADMAP queue 1, item 8b).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Iterator, Protocol, runtime_checkable

import torch

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
        """Pages a copy to the card cannot read asynchronously: the scan
        stages them through pinned buffers."""
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

    def to_device(self, block: Any, out: Any, staging: Any = None) -> Any:
        """Stage an off-device block into the device buffer ``out`` on the
        current stream (through the pinned ``staging`` for pageable
        pages)."""
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

    @property
    def drain_overlap_s(self) -> float:
        """Drain work hidden behind compute: drain time minus the exposed
        drain wait (0 for the inline drain, which waits on every write)."""
        return max(0.0, self.drain_s - self.drain_wait_s)


@dataclasses.dataclass
class _InFlight:
    first_page: int
    num_pages: int
    block: Any


class StreamingScanExecutor:
    """Runs compiled plan stages over a ``ScanSource`` page batch by page
    batch; the last stage leaves the per-row predictions at ``"pred"``."""

    def __init__(self, stages, *, prefetch_depth: int = 2):
        if not 1 <= prefetch_depth <= MAX_IN_FLIGHT:
            raise ValueError(f"prefetch_depth must be in [1, "
                             f"{MAX_IN_FLIGHT}], got {prefetch_depth}")
        self.stages = stages
        self.prefetch_depth = prefetch_depth

    @staticmethod
    def batch_plan(num_pages: int, batch_pages: int
                   ) -> Iterator[tuple[int, int, int]]:
        """Deterministic (batch_index, first_page, num_pages) plan."""
        if batch_pages < 1:
            raise ValueError(f"batch_pages must be >= 1, got {batch_pages}")
        for k, first in enumerate(range(0, num_pages, batch_pages)):
            yield k, first, min(batch_pages, num_pages - first)

    def execute(self, source: ScanSource, batch_pages: int
                ) -> tuple[torch.Tensor, list[StageReport], ScanStats]:
        """Stream every page batch of ``source`` through the stages.

        Returns (predictions [num_rows], per-batch stage reports, stats).
        Pad rows past ``num_rows`` are scored like any row and cut off.
        The predictions of a device-tier scan stay on the device; those
        of a host- or disk-tier scan land in host memory (pinned on the
        card)."""
        plan = [(first, n) for _, first, n in
                self.batch_plan(source.num_pages, batch_pages)]
        if not plan:
            raise ValueError(f"dataset {source.name!r} has no pages")
        stats = ScanStats(tier=source.tier, batches=0,
                          batch_pages=batch_pages,
                          prefetch_depth=self.prefetch_depth)
        t_wall = time.perf_counter()
        with TRACER.span("scan.execute", tier=source.tier,
                         batch_pages=batch_pages,
                         prefetch_depth=self.prefetch_depth) as scan_span:
            try:
                if source.tier == "device":
                    out, reports = self._resident(source, plan, stats)
                else:
                    out, reports = _StreamedScan(
                        self, source, plan, batch_pages, stats,
                        scan_span).run()
            finally:
                # counted on every exit: a failed scan still counts
                scan_span.set(batches=stats.batches,
                              bytes_streamed=stats.bytes_streamed)
                METRICS.counter("scan.batches").inc(stats.batches)
                METRICS.counter("scan.bytes_streamed").inc(
                    stats.bytes_streamed)
        stats.wall_s = time.perf_counter() - t_wall
        return out[: source.num_rows], reports, stats

    def _resident(self, source, plan, stats):
        """Device tier: page views, no copies, the result on the device."""
        R = source.page_rows
        pending = list(reversed(plan))
        reports: list[StageReport] = []
        bufs: list[_InFlight] = []
        result: torch.Tensor | None = None

        def acquire() -> None:
            first, n = pending.pop()
            with TRACER.span("scan.dma_in", first_page=first, num_pages=n):
                bufs.append(_InFlight(first, n, source.page_slice(first, n)))
            stats.max_in_flight = max(stats.max_in_flight, len(bufs))
            if len(bufs) > MAX_IN_FLIGHT:
                raise RuntimeError(f"{len(bufs)} page buffers in flight "
                                   f"(max {MAX_IN_FLIGHT})")

        while pending or bufs:
            while len(bufs) < self.prefetch_depth and pending:
                acquire()                      # batch i+1 while i computes
            cur = bufs.pop(0)
            pages = dict(first_page=cur.first_page, num_pages=cur.num_pages)
            with TRACER.span("scan.batch", index=stats.batches, **pages):
                with TRACER.span("scan.transfer_wait"):
                    pass                       # the pages are a view
                t0 = time.perf_counter()
                with TRACER.span("scan.compute"):
                    state, reps = run_stages(self.stages, {"x": cur.block})
                stats.compute_s += time.perf_counter() - t0
                reports.extend(reps)
                stats.batches += 1
                pred = state["pred"].reshape(-1)
                state = None                   # release the page view
                t0 = time.perf_counter()
                with TRACER.span("scan.drain_submit", **pages), \
                        TRACER.span("scan.drain_write", **pages):
                    if result is None:
                        result = torch.empty(source.num_pages * R,
                                             dtype=pred.dtype,
                                             device=pred.device)
                    lo = cur.first_page * R
                    result[lo: lo + cur.num_pages * R] = pred
                stats.drain_s += time.perf_counter() - t0
                stats.drain_wait_s = stats.drain_s
        return result, reports


class _StreamedScan:
    """One host- or disk-tier scan: the page buffers, the streams and the
    reader thread it owns, all released when ``run`` returns or raises."""

    def __init__(self, executor: StreamingScanExecutor, source, plan,
                 batch_pages: int, stats: ScanStats, scan_span):
        self.stages = executor.stages
        self.scan_span = scan_span
        self.source = source
        self.plan = plan
        self.stats = stats
        self.R = source.page_rows
        dev = source.device
        self.cuda = dev.type == "cuda"
        # a one-batch scan needs one buffer, whatever the depth
        self.depth = min(executor.prefetch_depth, len(plan))
        self.bufs = [source.empty_block(batch_pages, device=dev)
                     for _ in range(self.depth)]
        self.staging = None
        if self.cuda and source.pageable:
            self.staging = [source.empty_block(batch_pages, pin_memory=True)
                            for _ in range(self.depth)]
        self.result: torch.Tensor | None = None
        self.live = 0
        # host time the inline path spends issuing LATER batches' loads
        # while the stages' thread waits for the current one: issue time,
        # not exposed wait
        self.ahead_issue_s = 0.0
        self.lock = threading.Lock()
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

    # -- the pages --------------------------------------------------------
    def _acquire(self) -> None:
        with self.lock:
            self.live += 1
            self.stats.max_in_flight = max(self.stats.max_in_flight,
                                           self.live)
            if self.live > MAX_IN_FLIGHT:
                raise RuntimeError(f"{self.live} page buffers in flight "
                                   f"(max {MAX_IN_FLIGHT})")

    def _release(self) -> None:
        with self.lock:
            self.live -= 1

    def _load(self, first: int, n: int, k: int) -> None:
        """Pages [first, first + n) into page buffer k: the read and the
        copy, issued on the copy stream on the card."""
        t0 = time.perf_counter()
        source = self.source
        pages = dict(first_page=first, num_pages=n)
        if source.tier == "disk":
            # the lazy memmap view; the pages are read by the staging copy
            # under scan.dma_in, as the reference's device_put reads them
            with TRACER.span("scan.disk_read", parent=self.scan_span,
                             **pages):
                block = source.page_slice(first, n)
        else:
            block = source.page_slice(first, n)
        out = source.first_pages(self.bufs[k], n)
        with TRACER.span("scan.dma_in", parent=self.scan_span, **pages):
            if not self.cuda:
                source.to_device(block, out)
            else:
                staging = None
                if self.staging is not None:
                    self.copied[k].synchronize()   # its last H2D finished
                    staging = source.first_pages(self.staging[k], n)
                self.copy_stream.wait_event(self.released[k])
                with torch.cuda.stream(self.copy_stream):
                    source.to_device(block, out, staging)
                    self.copied[k].record(self.copy_stream)
        self.stats.transfer_issue_s += time.perf_counter() - t0
        self.stats.bytes_streamed += out.nbytes

    def _inline_batches(self) -> Iterator[tuple[int, int, int]]:
        """Batches loaded on the stages' thread.  Depth 1: each batch's
        pages when it is wanted.  Depth 2 over pinned pages: batch i+1's
        copy is issued before batch i's stages, since it needs no host
        work to hide behind them."""
        ahead: deque[tuple[int, int, int]] = deque()
        for i, (first, n) in enumerate(self.plan):
            k = i % self.depth
            t0 = time.perf_counter()
            self._acquire()
            self._load(first, n, k)
            if i and self.depth > 1:           # batch i is loaded ahead
                self.ahead_issue_s += time.perf_counter() - t0
            ahead.append((first, n, k))
            if len(ahead) == self.depth:
                yield ahead.popleft()
        yield from ahead

    def _read_ahead(self, free: queue.Queue, ready: queue.Queue,
                    stop: threading.Event) -> None:
        """The reader thread's body: fill each free page buffer with the
        next batch, in plan order, until the plan ends or ``stop`` is set."""
        try:
            for first, n in self.plan:
                k = free.get()
                if stop.is_set():
                    return
                self._acquire()
                self._load(first, n, k)
                ready.put((first, n, k))
        except BaseException as e:  # noqa: BLE001 -- raised by the caller
            ready.put(e)

    # -- the predictions --------------------------------------------------
    def _drain(self, first: int, n: int, pred: torch.Tensor, k: int,
               batch_span) -> None:
        """Batch predictions into their slot of the host result buffer."""
        stats = self.stats
        if self.result is None:
            self.result = torch.empty(self.source.num_pages * self.R,
                                      dtype=pred.dtype, pin_memory=self.cuda)
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
            self.released[k].record(self.drain_stream)
        self.drain_events.append((start, end, first, n, batch_span))
        pred.record_stream(self.drain_stream)
        if self.depth == 1:                    # the synchronous reference
            t0 = time.perf_counter()
            end.synchronize()
            stats.drain_wait_s += time.perf_counter() - t0

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
    def _compute(self, first: int, n: int, k: int,
                 reports: list[StageReport], batch_span) -> None:
        if self.cuda:
            self.compute_stream.wait_event(self.copied[k])
        t0 = time.perf_counter()
        with TRACER.span("scan.compute"):
            state, reps = run_stages(
                self.stages, {"x": self.source.first_pages(self.bufs[k], n)})
        self.stats.compute_s += time.perf_counter() - t0
        reports.extend(reps)
        self.stats.batches += 1
        pred = state["pred"].reshape(-1)
        state = None
        with TRACER.span("scan.drain_submit", first_page=first, num_pages=n):
            self._drain(first, n, pred, k, batch_span)

    def run(self) -> tuple[torch.Tensor, list[StageReport]]:
        """Every batch: wait for its pages (the exposed transfer), run the
        stages, drain; then the one drain synchronise.  Pageable pages at
        depth 2 are read ahead by a reader thread, since their host read
        is work to overlap with the stages."""
        reports: list[StageReport] = []
        reader = None
        failed: BaseException | None = None
        try:
            if self.depth > 1 and self.source.pageable:
                free: queue.Queue = queue.Queue()
                ready: queue.Queue = queue.Queue()
                stop = threading.Event()
                for k in range(self.depth):
                    free.put(k)
                reader = threading.Thread(target=self._read_ahead,
                                          args=(free, ready, stop),
                                          name="scan-reader", daemon=True)
                reader.start()
                batches = iter(ready.get, None)
            else:
                batches = self._inline_batches()
            for i, (first, n) in enumerate(self.plan):
                with TRACER.span("scan.batch", index=i, first_page=first,
                                 num_pages=n) as batch_span:
                    ahead = self.ahead_issue_s
                    t0 = time.perf_counter()
                    with TRACER.span("scan.transfer_wait"):
                        item = next(batches)
                        if isinstance(item, BaseException):
                            raise item
                        _, _, k = item             # batches come in plan order
                        if self.cuda:
                            self.copied[k].synchronize()
                    self.stats.transfer_wait_s += (
                        time.perf_counter() - t0
                        - (self.ahead_issue_s - ahead))
                    self._compute(first, n, k, reports, batch_span)
                self._release()
                if reader is not None:
                    free.put(k)
            self._finish_drain()
        except BaseException as e:
            failed = e
            raise
        finally:
            if reader is not None:
                stop.set()
                free.put(None)                 # wake a reader that waits
                reader.join(READER_JOIN_S)
            self._quiesce()
            if reader is not None and reader.is_alive():
                msg = "the scan's reader thread did not stop"
                if failed is None:
                    raise RuntimeError(msg)
                failed.add_note(msg)           # keep the error in flight
        return self.result, reports

    def _quiesce(self) -> None:
        """No stream still touches the scan's buffers when it returns or
        raises; the drained batches' device spans are published."""
        if self.cuda:
            self.copy_stream.synchronize()
            self.drain_stream.synchronize()
            self._publish_drain_spans()
