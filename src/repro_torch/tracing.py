"""Host spans of the port: where the host's time goes while the card waits.

A span is a named stretch of one host thread's time, stamped in
nanoseconds on the clock of ``time.time_ns()``, which the profiler's
events use too, so a span and a profiler event compare directly::

    from repro_torch import tracing

    with tracing.recording() as rec:
        runner.run_campaign(sims, "appaware", solver="waterfill")
    for s in rec.spans:
        print(s.name, s.end_ns - s.start_ns, s.attrs)

Recording is off by default. Off, :func:`span` checks one module-level
value and returns a shared no-op context, so the spans in the port's loops
cost next to nothing. :func:`timed` always reads the clock, once at each
end, for callers that keep their own totals of a stage (the campaign's
``last_stats``), and records the span only while recording is on: one
reading feeds both.

Each span knows the span that caused it: by default the innermost span
open on its thread; across threads, the handle :func:`current` returned
where the work was handed over. Every span of one campaign carries the id
of its ``campaign`` span.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Iterator, NamedTuple

_perf_ns = time.perf_counter_ns


class Span(NamedTuple):
    """One finished span: ``name``, ``start_ns`` and ``end_ns`` on the
    clock of ``time.time_ns()``, its ``id``, the ``parent`` span's id (None
    at the top), the ``thread`` (``threading.get_ident()``) that ran it,
    the ``campaign`` span's id (None outside a campaign), and ``attrs``."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: "int | None"
    thread: int
    campaign: "int | None"
    attrs: dict


class Recorder:
    """The spans of one :func:`recording` block, in the order they ended.
    ``offset_ns`` turns the span clock (``time.perf_counter_ns()``) into
    ``time.time_ns()``; it is read once, when recording starts."""

    def __init__(self):
        a = _perf_ns()
        wall = time.time_ns()
        self.offset_ns = wall - (a + _perf_ns()) // 2
        self.spans: list[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        """This thread's open spans, as (id, campaign id) handles."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


_recorder: Recorder | None = None


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record every span that ends inside the block; yields the
    :class:`Recorder` that holds them."""
    global _recorder
    rec, prev = Recorder(), _recorder
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = prev


def current():
    """A handle on the innermost span open on this thread (None when there
    is none, or when recording is off), to pass as ``parent=`` to a span
    that another thread opens on this one's behalf."""
    rec = _recorder
    if rec is None:
        return None
    stack = rec._stack()
    return stack[-1] if stack else None


class _Timed:
    """A span that reads the clock at both ends whether or not recording is
    on (``ns``, ``seconds``). ``start()``/``stop()`` or ``with``; a second
    ``stop()`` does nothing."""
    __slots__ = ("name", "attrs", "parent", "rec", "handle", "t0", "t1")

    def __init__(self, name: str, parent, attrs: dict):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.t1 = None

    def start(self) -> "_Timed":
        self.rec = rec = _recorder
        if rec is not None:
            stack = rec._stack()
            if self.parent is None and stack:
                self.parent = stack[-1]
            sid = next(rec._ids)
            camp = (sid if self.name == "campaign"
                    else self.parent[1] if self.parent else None)
            self.handle = (sid, camp)
            stack.append(self.handle)
        self.t0 = _perf_ns()
        return self

    def stop(self) -> None:
        if self.t1 is not None:
            return
        self.t1 = _perf_ns()
        rec = self.rec
        if rec is not None:
            stack = rec._stack()
            if self.handle in stack:
                del stack[stack.index(self.handle):]
            off = rec.offset_ns
            rec.spans.append(Span(
                self.name, self.t0 + off, self.t1 + off, self.handle[0],
                self.parent[0] if self.parent else None,
                threading.get_ident(), self.handle[1], self.attrs))

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def ns(self) -> int:
        return self.t1 - self.t0

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: str, parent=None, **attrs):
    """A span of the block it opens, recorded while recording is on; off,
    the shared no-op context."""
    if _recorder is None:
        return _NO_SPAN
    return _Timed(name, parent, attrs)


def timed(name: str, parent=None, **attrs) -> _Timed:
    """A span that times its block always and is recorded while recording
    is on: read ``.seconds`` after it stops."""
    return _Timed(name, parent, attrs)


def traced(name: str):
    """Decorate a function so that each call is one span ``name`` while
    recording is on."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _recorder is None:
                return fn(*args, **kwargs)
            with _Timed(name, None, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def paths(spans) -> dict:
    """Each span's id to its path from the top, ``"campaign > dispatch >
    update"``; a parent not among ``spans`` ends the path there."""
    by_id = {s.id: s for s in spans}
    out: dict[int, str] = {}

    def path(s: Span) -> str:
        p = out.get(s.id)
        if p is None:
            up = by_id.get(s.parent)
            p = out[s.id] = s.name if up is None else f"{path(up)} > {s.name}"
        return p

    for s in spans:
        path(s)
    return out


def timeline(spans, thread: int) -> list:
    """The time of ``thread`` cut where its spans open and close: sorted,
    disjoint ``(start_ns, end_ns, path)`` pieces, each under the innermost
    span open then. Time under no span is not listed."""
    mine = sorted((s for s in spans if s.thread == thread),
                  key=lambda s: (s.start_ns, -s.end_ns))
    names = paths(spans)
    out: list[tuple[int, int, str]] = []
    open_: list[Span] = []
    t = None

    def emit(until: int) -> None:
        if open_ and t is not None and until > t:
            out.append((t, until, names[open_[-1].id]))

    for s in mine:
        while open_ and open_[-1].end_ns <= s.start_ns:
            emit(open_[-1].end_ns)
            t = open_.pop().end_ns
        emit(s.start_ns)
        open_.append(s)
        t = s.start_ns
    while open_:
        emit(open_[-1].end_ns)
        t = open_.pop().end_ns
    return out


def idle_by_span(busy, pieces, start_ns: int, end_ns: int) -> dict:
    """Where a device idled, by what the host was doing: the stretches of
    [start_ns, end_ns) outside every sorted, merged ``busy`` interval
    ([start, end] ns, a device's activity on the same clock), cut at the
    :func:`timeline` ``pieces``. Returns each path's ``[seconds, gaps]``;
    time under no piece goes to ``"outside the spans"``."""
    idle, t = [], start_ns
    for a, b in busy:
        if a > t:
            idle.append((t, min(a, end_ns)))
        t = max(t, b)
        if t >= end_ns:
            break
    if t < end_ns:
        idle.append((t, end_ns))
    out: dict[str, list] = {}
    k = 0
    for a, b in idle:
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j, t = k, a
        while t < b:
            if j < len(pieces) and pieces[j][0] <= t:
                end, path = min(b, pieces[j][1]), pieces[j][2]
                j += 1
            else:
                end = min(b, pieces[j][0]) if j < len(pieces) else b
                path = "outside the spans"
            if end > t:
                acc = out.setdefault(path, [0.0, 0])
                acc[0] += (end - t) * 1e-9
                acc[1] += 1
            t = end
    return out
