"""Request-span tracing: context-manager spans with monotonic timestamps,
exported as Chrome trace-event JSON (Perfetto-loadable).

Port of ``repro.obs.trace`` (the port keeps its own copy; the span names,
their args and the export format are the reference's).  Design constraints,
in priority order:

1. **~Zero cost disabled.**  ``Tracer(enabled=False).span(...)`` returns a
   module-level null-span singleton — no object allocation, no clock read,
   no event append — so instrumentation can live permanently on the serve
   hot paths (``tick``/``megastep``) without a flag check at every call
   site.  ``instant()`` likewise returns immediately.
2. **Single-threaded nesting by containment.**  The serve engines are
   single-threaded hosts driving the device, so spans need no explicit
   parent ids: every span records ``(name, t0, dur)`` against one
   ``(pid, tid)`` and Perfetto reconstructs the nesting from timestamp
   containment, as Chrome's own trace events nest.  Events are appended at
   span *exit*, so a child always precedes its parent in the buffer.
3. **Clock = ``time.perf_counter``.**  Monotonic, the clock the engine
   stats and request latency timestamps use, so span durations and
   ``stats["decode_s"]`` agree and a trace lines up with a metrics snapshot
   of the same run.

A span times host code.  It adds no device synchronization: a span's
duration is what the host waits for, so a span that ends in a read-back
(the engines' ``decode_tick`` and ``decode_megastep``) includes the device
time the read-back waits on, and one that only queues work does not.

The export format is the Chrome trace-event JSON object form::

    {"traceEvents": [
        {"name": "admit", "ph": "X", "ts": 12.3, "dur": 4500.0,
         "pid": 0, "tid": 0, "args": {"uid": 7}},
        {"name": "emit", "ph": "i", "ts": 99.0, "s": "t",
         "pid": 0, "tid": 0, "args": {"uid": 7}},
    ]}

``ph: "X"`` are complete (duration) events, ``ph: "i"`` are instants;
timestamps are microseconds relative to the tracer's construction.  Load
with https://ui.perfetto.dev ("Open trace file") or chrome://tracing.
"""

from __future__ import annotations

import json
import time
from typing import Optional

__all__ = ["Tracer", "Span", "NULL_SPAN"]


class _NullSpan:
    """Shared no-op span: the disabled-tracer fast path.  One module-level
    instance is returned for every ``span()`` call on a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    # duration reads on a disabled span are explicit zeros, never clock reads
    dur_s = 0.0


NULL_SPAN = _NullSpan()


class Span:
    """One live span; append-on-exit keeps ``__enter__`` to a clock read."""

    __slots__ = ("_tracer", "name", "args", "t0", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.dur_s = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dur_s = time.perf_counter() - self.t0
        self._tracer.events.append(("X", self.name, self.t0, self.dur_s, self.args))
        return False


class Tracer:
    """Span/instant collector with Chrome trace-event export.

    ``events`` holds ``(ph, name, t_s, dur_s, args)`` tuples where ``ph`` is
    ``"X"`` (complete span, appended at exit) or ``"i"`` (instant, ``dur_s``
    None).  Timestamps are raw ``perf_counter`` seconds; the export rebases
    them onto the tracer's origin in microseconds.
    """

    def __init__(self, enabled: bool = True, pid: int = 0, tid: int = 0):
        self.enabled = enabled
        self.pid = pid
        self.tid = tid
        self.events: list = []
        self._origin = time.perf_counter()

    # -- recording ----------------------------------------------------------

    def span(self, name: str, args: Optional[dict] = None):
        """Context manager timing one region.  Disabled tracers return the
        shared null span (identity-stable; zero allocation)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, args)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        """Point event (``ph: "i"``): submissions, request completions."""
        if not self.enabled:
            return
        self.events.append(("i", name, time.perf_counter(), None, args))

    def clear(self) -> None:
        self.events.clear()
        self._origin = time.perf_counter()

    # -- inspection ---------------------------------------------------------

    def span_names(self) -> set:
        return {name for _, name, _, _, _ in self.events}

    def spans(self, name: Optional[str] = None) -> list:
        """Completed spans (ph == "X"), optionally filtered by name, as
        ``(name, t0_s, dur_s, args)`` in append (child-before-parent) order."""
        return [(n, t0, dur, args) for ph, n, t0, dur, args in self.events
                if ph == "X" and (name is None or n == name)]

    def instants(self, name: Optional[str] = None) -> list:
        return [(n, t0, args) for ph, n, t0, _, args in self.events
                if ph == "i" and (name is None or n == name)]

    # -- export -------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (``{"traceEvents": [...]}``)."""
        out = []
        for ph, name, t0, dur, args in self.events:
            ev = {"name": name, "ph": ph, "ts": (t0 - self._origin) * 1e6,
                  "pid": self.pid, "tid": self.tid}
            if ph == "X":
                ev["dur"] = dur * 1e6
            else:
                ev["s"] = "t"  # instant scope: thread
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
