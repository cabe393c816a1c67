"""Observability for the serve stack (port of ``repro.obs``).

``Obs`` bundles the two collectors every engine carries:

* ``obs.trace`` — request-span tracer (Chrome trace-event export);
* ``obs.metrics`` — counter/gauge/histogram registry with one
  ``snapshot()`` contract.

Engines default to ``Obs(trace=False)``: metrics are always live (they back
``--metrics-json``), tracing is opt-in.  ``obs.headroom`` turns the A2Q
accumulator guarantee into gauges.
"""

from __future__ import annotations

from repro_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, merge_snapshots, percentile,
)
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer

__all__ = [
    "Obs", "Tracer", "Span", "NULL_SPAN",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "merge_snapshots", "percentile",
]


class Obs:
    """Tracer + metrics bundle threaded through the serve stack."""

    def __init__(self, trace: bool = False):
        self.trace = Tracer(enabled=trace)
        self.metrics = MetricsRegistry()

    def reset(self) -> None:
        """Clear collected state (spans + metrics); the single reset path
        behind every ``reset_stats``."""
        self.trace.clear()
        self.metrics.reset()
