"""Per-query span tracing with Chrome trace-event (Perfetto) export.

Mirrors ``repro/obs/trace.py`` (the port keeps its own copy).  A ``Tracer``
records SPANS -- named, attributed intervals on the ``perf_counter_ns``
clock -- nested per thread through a thread-local stack, with an explicit
``parent=`` for a child opened on another thread (the scan's reader thread
parents its ``scan.disk_read`` / ``scan.dma_in`` spans to the scan's
``scan.execute``).  Span EVENTS are instants on the open span of the
firing thread.

  * Disabled by default, and the disabled path allocates nothing:
    ``tracer.span(...)`` returns the shared ``NULL_SPAN`` singleton.
  * Monotonic clock only (``time.perf_counter_ns``).
  * Stdlib only.

What the card changes.  A host span's wall is a fair clock only where the
code it wraps waits for the card: a stage ends in a synchronise, so its
``stage:*`` span is; the scan's drain is a D2H on a drain stream that the
host only enqueues.  So the tracer takes one more kind of span, a DEVICE
span (``_device_span``): an interval measured by CUDA events and mapped
onto this tracer's clock by the caller, published on a named device track
(``cuda:drain``) instead of a thread's.  ``export_chrome`` gives each
device track its own lane, so the drain's overlap with ``scan.compute``
shows as the reference's drain thread shows it.

``TraceSummary`` is the per-query rollup attached to ``QueryResult.trace``.
The names are cataloged in ``obs/names.py`` and documented in
``docs/torch_observability.md``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import threading
import time
from collections import deque
from typing import Any

__all__ = ["Span", "SpanEvent", "NullSpan", "NULL_SPAN", "Tracer",
           "TRACER", "TraceSummary"]


@dataclasses.dataclass
class SpanEvent:
    """An instant inside (or beside) a span."""

    name: str
    ts_ns: int
    tid: int
    thread_name: str
    attrs: dict[str, Any]


class Span:
    """One named interval.  Context manager: enter starts the clock and
    pushes onto the owning thread's stack; exit stops it, pops, and
    publishes the span to the tracer's finished list.  ``track`` names the
    device lane of a device span (None for a host span)."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "start_ns",
                 "end_ns", "tid", "thread_name", "events", "track",
                 "_tracer", "_parent")

    def __init__(self, tracer: "Tracer", name: str,
                 parent: "Span | None" = None, attrs: dict | None = None):
        self.name = name
        self.attrs = attrs or {}
        self.span_id = next(tracer._ids)
        self.parent_id: int | None = None
        self._parent = parent               # explicit cross-thread parent
        self.start_ns = 0
        self.end_ns = 0
        self.tid = 0
        self.thread_name = ""
        self.events: list[SpanEvent] = []
        self.track: str | None = None
        self._tracer = tracer

    def __enter__(self) -> "Span":
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread_name = t.name
        parent = self._parent
        if parent is None:
            parent = self._tracer._current()
        if isinstance(parent, Span):
            self.parent_id = parent.span_id
        self._tracer._push(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end_ns = time.perf_counter_ns()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._pop(self)
        self._tracer._finished.append(self)

    def set(self, **attrs) -> "Span":
        """Attach / overwrite attributes (after close too: exports read
        lazily)."""
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> None:
        """Record an instant on this span (now, on the calling thread)."""
        t = threading.current_thread()
        self.events.append(SpanEvent(name=name,
                                     ts_ns=time.perf_counter_ns(),
                                     tid=t.ident or 0, thread_name=t.name,
                                     attrs=attrs))

    @property
    def duration_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class NullSpan:
    """The disabled tracer's span: a shared no-op singleton."""

    __slots__ = ()

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def set(self, **attrs) -> "NullSpan":
        return self

    def event(self, name: str, **attrs) -> None:
        return None

    @property
    def duration_s(self) -> float:
        return 0.0


NULL_SPAN = NullSpan()


@dataclasses.dataclass
class TraceSummary:
    """Per-query rollup (``QueryResult.trace``).

    ``phase_s`` sums span seconds BY NAME over the query's span tree (a
    device span counts its device seconds); ``span_counts`` /
    ``event_counts`` count spans and events by name; ``counters`` holds
    the ``METRICS`` counter deltas that accrued while the query ran."""

    root: str
    wall_s: float
    phase_s: dict[str, float]
    span_counts: dict[str, int]
    event_counts: dict[str, int]
    counters: dict[str, int | float]
    num_spans: int = 0

    def phase(self, name: str) -> float:
        """Total seconds of spans named ``name`` (0.0 when absent)."""
        return self.phase_s.get(name, 0.0)


def _jsonable(v):
    return v if isinstance(v, (str, int, float, bool, type(None))) \
        else str(v)


class Tracer:
    """Thread-safe span tracer, process-global as ``TRACER``.

    Finished spans land in an append-only deque (GIL-atomic appends;
    ``mark()`` / ``finished()`` window it), which ``export_chrome`` and
    ``summarize`` read."""

    def __init__(self):
        self.enabled = False
        self._ids = itertools.count(1)
        self._finished: deque[Span] = deque()
        self._orphan_events: deque[SpanEvent] = deque()
        self._stacks = threading.local()
        self._epoch_ns = time.perf_counter_ns()

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def reset(self) -> None:
        """Drop every recorded span and event and restart the export epoch
        (spans still open publish into the fresh window when they close)."""
        self._finished = deque()
        self._orphan_events = deque()
        self._epoch_ns = time.perf_counter_ns()

    # -- per-thread stack ---------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._stacks, "spans", None)
        if st is None:
            st = self._stacks.spans = []
        return st

    def _current(self) -> Span | None:
        st = getattr(self._stacks, "spans", None)
        return st[-1] if st else None

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:                 # out-of-order exit: still correct
            st.remove(span)

    # -- recording ----------------------------------------------------------
    def span(self, name: str, parent: Span | NullSpan | None = None,
             **attrs):
        """Open a span (a context manager).  Disabled: the shared
        ``NULL_SPAN``, no allocation, no clock.  ``parent=`` overrides the
        thread-stack parent; a ``NullSpan`` parent (captured while
        disabled) means no parent."""
        if not self.enabled:
            return NULL_SPAN
        if not isinstance(parent, Span):
            parent = None
        return Span(self, name, parent=parent, attrs=attrs)

    def _device_span(self, name: str, parent: Span | NullSpan | None,
                     start_ns: int, end_ns: int, track: str,
                     **attrs) -> Span | None:
        """Publish a closed span whose interval was measured on the device:
        ``start_ns`` / ``end_ns`` are CUDA-event times already mapped onto
        this tracer's ``perf_counter_ns`` clock, ``track`` the device lane
        it is exported on.  Never pushed on a thread stack.  Disabled:
        records nothing and returns None."""
        if not self.enabled:
            return None
        sp = Span(self, name, attrs=attrs)
        if isinstance(parent, Span):
            sp.parent_id = parent.span_id
        sp.start_ns, sp.end_ns = int(start_ns), int(end_ns)
        sp.thread_name = sp.track = track
        self._finished.append(sp)
        return sp

    def event(self, name: str, **attrs) -> None:
        """Record an instant on the calling thread's open span (or as a
        free-standing orphan instant when no span is open)."""
        if not self.enabled:
            return
        cur = self._current()
        if cur is not None:
            cur.event(name, **attrs)
        else:
            t = threading.current_thread()
            self._orphan_events.append(SpanEvent(
                name=name, ts_ns=time.perf_counter_ns(),
                tid=t.ident or 0, thread_name=t.name, attrs=attrs))

    @contextlib.contextmanager
    def detached(self):
        """Run a block with no span open on the calling thread: an event
        inside is a free-standing instant, as on a thread that holds no
        span (the fault plane's ``drain_worker`` site, whose reference
        fires on its drain thread)."""
        st = getattr(self._stacks, "spans", None)
        self._stacks.spans = []
        try:
            yield
        finally:
            self._stacks.spans = st if st is not None else []

    # -- consumption --------------------------------------------------------
    def mark(self) -> int:
        """Index into the finished-span window: ``finished(mark)`` /
        ``summarize(..., since=mark)`` scope to spans closed after it."""
        return len(self._finished)

    def finished(self, since: int = 0) -> list[Span]:
        return list(itertools.islice(self._finished, since, None))

    def summarize(self, root: Span, *, since: int = 0,
                  counters_before: dict | None = None,
                  counters_now: dict | None = None) -> TraceSummary:
        """Roll the span tree under ``root`` up into a ``TraceSummary``.
        Membership is by parent chain (a child may close after its parent,
        on another thread or as a device span), so the walk iterates the
        window to a fixpoint."""
        window = self.finished(since)
        under: set[int] = {root.span_id}
        changed = True
        while changed:
            changed = False
            for s in window:
                if s.span_id not in under and s.parent_id in under:
                    under.add(s.span_id)
                    changed = True
        phase_s: dict[str, float] = {}
        span_counts: dict[str, int] = {}
        event_counts: dict[str, int] = {}
        n = 0
        for s in window:
            if s.span_id not in under:
                continue
            n += 1
            phase_s[s.name] = phase_s.get(s.name, 0.0) + s.duration_s
            span_counts[s.name] = span_counts.get(s.name, 0) + 1
            for ev in s.events:
                event_counts[ev.name] = event_counts.get(ev.name, 0) + 1
        counters: dict[str, int | float] = {}
        if counters_now is not None:
            before = counters_before or {}
            for k, v in counters_now.items():
                d = v - before.get(k, 0)
                if d:
                    counters[k] = d
        return TraceSummary(root=root.name, wall_s=root.duration_s,
                            phase_s=phase_s, span_counts=span_counts,
                            event_counts=event_counts, counters=counters,
                            num_spans=n)

    def export_chrome(self, path: str | None = None,
                      since: int = 0) -> dict:
        """The finished-span window as Chrome trace-event JSON.

        One lane per thread and one per device track: ``tid`` is a dense
        index with an ``M`` row naming it (the Python thread's name, or the
        track's, e.g. ``cuda:drain``).  Spans are ``ph: "X"`` complete
        events (``ts`` / ``dur`` in microseconds since the tracer epoch),
        span events ``ph: "i"`` instants.  Returns the payload; writes it
        to ``path`` as JSON when given."""
        tid_names: dict[Any, tuple[int, str]] = {}

        def lane(key, name: str) -> int:
            if key not in tid_names:
                tid_names[key] = (len(tid_names) + 1, name)
            return tid_names[key][0]

        def us(ts_ns: int) -> float:
            return (ts_ns - self._epoch_ns) / 1000.0

        events: list[dict] = []
        for sp in self.finished(since):
            args = {k: _jsonable(v) for k, v in sp.attrs.items()}
            args["span_id"] = sp.span_id
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            key = ("track", sp.track) if sp.track else sp.tid
            events.append({"name": sp.name, "cat": "span", "ph": "X",
                           "ts": us(sp.start_ns), "dur": sp.duration_s * 1e6,
                           "pid": 1, "tid": lane(key, sp.thread_name),
                           "args": args})
            for ev in sp.events:
                events.append({
                    "name": ev.name, "cat": "event", "ph": "i", "s": "t",
                    "ts": us(ev.ts_ns), "pid": 1,
                    "tid": lane(ev.tid, ev.thread_name),
                    "args": dict(
                        {k: _jsonable(v) for k, v in ev.attrs.items()},
                        span_id=sp.span_id)})
        for ev in self._orphan_events:
            events.append({"name": ev.name, "cat": "event", "ph": "i",
                           "s": "t", "ts": us(ev.ts_ns), "pid": 1,
                           "tid": lane(ev.tid, ev.thread_name),
                           "args": {k: _jsonable(v)
                                    for k, v in ev.attrs.items()}})
        for tid, name in sorted(tid_names.values()):
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": name}})
        events.append({"name": "process_name", "ph": "M", "pid": 1,
                       "tid": 0, "args": {"name": "repro-data-plane"}})
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as fh:
                json.dump(payload, fh)
        return payload


#: the process-global tracer every layer of the port reports to (disabled
#: by default; ``TRACER.enable()`` arms it)
TRACER = Tracer()
