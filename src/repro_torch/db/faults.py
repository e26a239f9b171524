"""The fault plane of the scan data plane: injection, bounded retries,
deadlines and structured scan faults (torch).

Mirrors ``repro/db/faults.py`` (the port keeps its own copy; plain Python,
no torch op).  A deployment that puts the forest on the request path
(fraud gating, ranking, admission) turns a failed page read or a lost
drain into an outage, so every call at one of the data plane's five NAMED
SITES can be faulted and recovered:

  ``page_dma_in``     a page block's transfer onto the device (the scan's
                      H2D, the device tier's page view, the loaders'
                      transfers)
  ``drain_copy_out``  one batch's predictions into the result buffer
  ``disk_page_read``  reading disk-tier pages off their mapping (the
                      scan's read into staging, ``store.move`` off disk)
  ``kernel_launch``   running a batch's stages
  ``drain_worker``    the drain itself: the reference's drain thread
                      dying, which the port's stream drain stands in for
                      (not retried: the ladder falls back to the
                      synchronous drain)

``FaultInjector`` arms sites deterministically (fire at the Nth call) or
with a probability from a generator seeded by (seed, site);
``RetryPolicy`` bounds the attempts at a site with exponential backoff and
a jitter that is a pure function of (site, attempt); ``Deadline`` is the
cooperative per-query budget, read between batches and before a backoff
sleep, never inside a stage: a CUDA kernel cannot be cancelled safely
mid-flight, so the scan stops at a batch boundary.  A ladder that cannot
recover raises a ``ScanFault`` (site, attempts, rows completed, cause);
an expired deadline returns a partial result with a ``DegradedReport``.
The ladders themselves live in ``db/executor.py``, ``db/store.py`` and
``db/loader.py``; ``docs/torch_reliability.md`` describes them on the card.

Only ``(InjectedFault, OSError)`` is retried.  A CUDA error (a
``RuntimeError``, ``torch.AcceleratorError`` on recent torch) is not: a
device-side fault poisons the context, and a retried launch would return
garbage.  Events (``fault.injected``, ``retry``) go through the port's
``TRACER``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable

import numpy as np

from repro_torch.obs import TRACER

__all__ = ["FAULT_SITES", "InjectedFault", "ScanFault", "DeadlineExceeded",
           "FaultInjector", "RetryPolicy", "Deadline", "DegradedReport"]

#: the named injection points of the scan data plane
FAULT_SITES = ("page_dma_in", "drain_copy_out", "disk_page_read",
               "kernel_launch", "drain_worker")


class InjectedFault(RuntimeError):
    """Raised by ``FaultInjector.fire`` at an armed site: the stand-in for
    a failed transfer, read or launch.  Retryable by default."""

    def __init__(self, site: str, call: int):
        super().__init__(f"injected fault at site {site!r} (call {call})")
        self.site = site
        self.call = call


class ScanFault(RuntimeError):
    """A scan-path failure that exhausted its recovery ladder: the fault
    ``site``, the ``attempts`` made there, the ``rows_completed`` that had
    landed in the result buffer, and the underlying ``cause``."""

    def __init__(self, site: str, *, attempts: int, rows_completed: int,
                 cause: BaseException | None = None,
                 detail: str = ""):
        msg = (f"scan fault at site {site!r} after {attempts} attempt(s), "
               f"{rows_completed} rows completed")
        if detail:
            msg += f": {detail}"
        if cause is not None:
            msg += f" (cause: {cause!r})"
        super().__init__(msg)
        self.site = site
        self.attempts = attempts
        self.rows_completed = rows_completed
        self.cause = cause


class DeadlineExceeded(Exception):
    """A deadline expired inside a retry loop.  The executor turns it into
    a partial result (``deadline_hit``); it never reaches a caller."""

    def __init__(self, site: str, cause: BaseException | None = None):
        super().__init__(f"deadline exceeded during retries at {site!r}")
        self.site = site
        self.cause = cause


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _SiteRule:
    """Arming state of one site."""

    fail_at: int | None = None       # fire at the Nth call (1-based)
    probability: float = 0.0         # else fire with this probability
    times: int = 1                   # how many fires before disarming
    fired: int = 0                   # fires so far
    rng: Any = None                  # seeded per-site generator


class FaultInjector:
    """Site-based fault injection with two deterministic modes:

      * ``inject(site, fail_at=N)``: fire at the Nth call of the site
        (1-based), and at the ``times - 1`` calls after it;
      * ``inject(site, probability=p)``: fire each call with probability
        ``p`` from a generator seeded by (seed, site), so a given seed and
        call sequence always fire at the same calls.

    ``fire(site)`` sits at each injection point; it counts the call in
    ``calls`` and raises ``InjectedFault`` when armed."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.calls: dict[str, int] = {s: 0 for s in FAULT_SITES}
        self._rules: dict[str, _SiteRule] = {}

    def inject(self, site: str, *, fail_at: int | None = None,
               probability: float | None = None,
               times: int = 1) -> "FaultInjector":
        """Arm ``site`` with exactly one of ``fail_at`` / ``probability``.
        Returns self, so arming chains."""
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"expected one of {FAULT_SITES}")
        if (fail_at is None) == (probability is None):
            raise ValueError("arm with exactly one of fail_at=/probability=")
        rule = _SiteRule(fail_at=fail_at, times=times)
        if probability is not None:
            rule.probability = float(probability)
            sd = int.from_bytes(hashlib.blake2s(
                f"{self.seed}:{site}".encode(), digest_size=8).digest(),
                "big")
            rule.rng = np.random.default_rng(sd)
        self._rules[site] = rule
        return self

    def fire(self, site: str) -> None:
        """Count one call at ``site``; raise ``InjectedFault`` if armed."""
        self.calls[site] = call = self.calls.get(site, 0) + 1
        rule = self._rules.get(site)
        if rule is None or rule.fired >= rule.times:
            return
        if rule.fail_at is not None:
            hit = rule.fail_at <= call < rule.fail_at + rule.times
        else:
            hit = bool(rule.rng.random() < rule.probability)
        if hit:
            rule.fired += 1
            TRACER.event("fault.injected", site=site, call=call)
            raise InjectedFault(site, call)

    @property
    def total_fired(self) -> int:
        """Faults fired so far, across every site."""
        return sum(r.fired for r in self._rules.values())


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


class Deadline:
    """A cooperative wall-clock budget for one query, read at batch
    boundaries and before backoff sleeps.  A ``None`` budget never
    expires."""

    def __init__(self, budget_s: float | None,
                 start: float | None = None):
        self.budget_s = budget_s
        self.start = time.perf_counter() if start is None else start

    @property
    def expired(self) -> bool:
        return (self.budget_s is not None
                and time.perf_counter() - self.start >= self.budget_s)

    def remaining(self) -> float:
        if self.budget_s is None:
            return float("inf")
        return max(0.0, self.budget_s - (time.perf_counter() - self.start))


# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff and deterministic jitter.

    ``run(fn, site=...)`` calls ``fn`` up to ``max_attempts`` times,
    sleeping ``backoff_base_s * backoff_factor**k`` (capped at
    ``max_backoff_s``) plus a jitter hashed from (site, attempt) between
    attempts.  ``per_call_budget_s`` bounds the time one logical call may
    spend across its attempts; an expired ``deadline`` stops the loop with
    ``DeadlineExceeded``.  Only ``retryable`` types are retried; anything
    else propagates at once (a shape error is a bug, a CUDA error a
    poisoned context)."""

    max_attempts: int = 3
    backoff_base_s: float = 0.001
    backoff_factor: float = 2.0
    max_backoff_s: float = 0.05
    jitter_frac: float = 0.25
    per_call_budget_s: float | None = None
    retryable: tuple = (InjectedFault, OSError)

    def backoff_s(self, site: str, attempt: int) -> float:
        """Deterministic backoff before retry ``attempt`` (1-based)."""
        base = min(self.backoff_base_s * self.backoff_factor
                   ** (attempt - 1), self.max_backoff_s)
        h = int.from_bytes(hashlib.blake2s(
            f"{site}:{attempt}".encode(), digest_size=4).digest(), "big")
        return base * (1.0 + self.jitter_frac * (h / 0xFFFFFFFF))

    def run(self, fn: Callable[[], Any], *, site: str,
            injector: FaultInjector | None = None,
            on_retry: Callable[[], None] | None = None,
            deadline: Deadline | None = None) -> Any:
        """Run ``fn`` under this policy at ``site``: ``injector.fire(site)``
        before each attempt (the injection point is the guarded call, so a
        fired attempt runs nothing of ``fn``), ``on_retry`` once per
        re-attempt.  Exhausted attempts raise the last cause; callers wrap
        it in a ``ScanFault`` with their own context."""
        t0 = time.perf_counter()
        attempt = 0
        while True:
            attempt += 1
            try:
                if injector is not None:
                    injector.fire(site)
                return fn()
            except self.retryable as e:
                if attempt >= self.max_attempts:
                    raise
                if (self.per_call_budget_s is not None
                        and time.perf_counter() - t0
                        >= self.per_call_budget_s):
                    raise
                if deadline is not None and deadline.expired:
                    raise DeadlineExceeded(site, cause=e)
                if on_retry is not None:
                    on_retry()
                TRACER.event("retry", site=site, attempt=attempt)
                pause = self.backoff_s(site, attempt)
                if deadline is not None:
                    pause = min(pause, deadline.remaining())
                if pause > 0:
                    time.sleep(pause)


# ---------------------------------------------------------------------------
# graceful degradation reporting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DegradedReport:
    """What a PARTIAL query result is missing and why
    (``QueryResult.degraded``).  The scored rows are bit-identical to an
    unbounded run (a batch always covers the same pages), the others are
    NaN in ``predictions``, and ``row_mask`` says which is which."""

    rows_scored: int
    rows_missing: int
    cause: str                        # "deadline" (the one ladder that
    #                                   returns partials)
    deadline_s: float | None = None
    row_mask: np.ndarray | None = None   # [num_rows] bool, True = scored

    def __bool__(self) -> bool:
        return self.rows_missing > 0
