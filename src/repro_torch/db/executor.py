"""Streaming scan executor: the one batch loop of every plan (torch).

Mirrors the device-tier path of ``repro/db/executor.py``.  A source gives
``page_slice`` (a page range in its own tier) and ``to_device`` (staging
onto the device), so the loop never branches on where pages live -- the
reference's ``ScanSource`` contract.  Each batch is a contiguous
page range (``batch_plan``, deterministic: batch k always covers the same
pages); the loop acquires at most ``MAX_IN_FLIGHT = 2`` page buffers at a
time (the one being computed on plus the next one), runs the compiled
plan's stages on it, and writes the batch's predictions into a
preallocated result buffer at the batch's own slot -- no concatenate.

On the device tier the transfer is a no-op view and the result buffer
lives on the same device as the predictions, so the query's output never
leaves the card.  Not ported yet: the host/disk tiers with their H2D page
DMA and the asynchronous D2H drain worker (ROADMAP queue 1, item 6), and
the fault-injection sites and deadlines (item 8).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Iterator

import torch

from repro_torch.db.operators import StageReport, run_stages

__all__ = ["ScanStats", "StreamingScanExecutor", "MAX_IN_FLIGHT"]

#: hard ceiling on simultaneously live page buffers
MAX_IN_FLIGHT = 2


@dataclasses.dataclass
class ScanStats:
    """Per-query scan telemetry (attached to ``QueryResult.scan``).
    ``compute_s`` covers the stages, which synchronise at their boundary;
    ``drain_s`` is host time enqueueing the result-buffer slot writes."""

    tier: str                        # source tier the scan ran against
    batches: int                     # page batches executed
    batch_pages: int                 # pages per (full) batch as planned
    prefetch_depth: int              # 1 = one buffer, 2 = one ahead
    max_in_flight: int = 0           # peak live page buffers (<= 2)
    compute_s: float = 0.0           # stage time, synchronised
    drain_s: float = 0.0             # result-buffer slot writes
    wall_s: float = 0.0              # whole scan loop


@dataclasses.dataclass
class _InFlight:
    first_page: int
    num_pages: int
    block: Any


class StreamingScanExecutor:
    """Runs compiled plan stages over a stored dataset page batch by page
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

    def execute(self, source, batch_pages: int
                ) -> tuple[torch.Tensor, list[StageReport], ScanStats]:
        """Stream every page batch of ``source`` through the stages.

        Returns (predictions [num_rows], per-batch stage reports, stats).
        Pad rows past ``num_rows`` are scored like any row and cut off."""
        R = source.page_rows
        pending = deque((first, n) for _, first, n in
                        self.batch_plan(source.num_pages, batch_pages))
        stats = ScanStats(tier=source.tier, batches=0,
                          batch_pages=batch_pages,
                          prefetch_depth=self.prefetch_depth)
        reports: list[StageReport] = []
        bufs: deque[_InFlight] = deque()
        result: torch.Tensor | None = None
        t_wall = time.perf_counter()

        def acquire() -> None:
            first, n = pending.popleft()
            block = source.to_device(source.page_slice(first, n))
            bufs.append(_InFlight(first, n, block))
            stats.max_in_flight = max(stats.max_in_flight, len(bufs))
            if len(bufs) > MAX_IN_FLIGHT:
                raise RuntimeError(f"{len(bufs)} page buffers in flight "
                                   f"(max {MAX_IN_FLIGHT})")

        while pending or bufs:
            while len(bufs) < self.prefetch_depth and pending:
                acquire()                      # batch i+1 while i computes
            cur = bufs.popleft()
            t0 = time.perf_counter()
            state, reps = run_stages(self.stages, {"x": cur.block})
            stats.compute_s += time.perf_counter() - t0
            reports.extend(reps)
            stats.batches += 1
            pred = state["pred"].reshape(-1)
            t0 = time.perf_counter()
            if result is None:
                result = torch.empty(source.num_pages * R, dtype=pred.dtype,
                                     device=pred.device)
            lo = cur.first_page * R
            result[lo: lo + cur.num_pages * R] = pred
            stats.drain_s += time.perf_counter() - t0
            state = None                       # release the page buffer
            cur.block = None
        if result is None:
            raise ValueError(f"dataset {source.name!r} has no pages")
        stats.wall_s = time.perf_counter() - t_wall
        return result[: source.num_rows], reports, stats
