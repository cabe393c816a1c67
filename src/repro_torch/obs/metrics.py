"""Metrics registry: counters / gauges / histograms with labels, one
``snapshot()`` contract, and associative snapshot merging for a fleet view.

Port of ``repro.obs.metrics`` (the port keeps its own copy; metric names,
labels and the snapshot layout are the reference's).  The registry gathers
the serve stack's runtime signals — engine ``stats``/``throughput()``, the
paged cache's counters, the int-chain report, CUDA-graph capture counts —
behind one schema:

* **Counter** — monotone accumulator (tokens, dispatches, cache events).
* **Gauge** — last-written value (utilization, acceptance rate, capture
  counts, peak block usage).
* **Histogram** — raw observed values (request latency, TTFT) with
  nearest-rank percentiles.

Snapshot keys are Prometheus-flavoured: ``name`` or ``name{k=v,...}`` with
label pairs sorted, so equal metric identities collide by construction.
Snapshots are plain JSON dicts::

    {"serve_decode_tokens": {"type": "counter", "value": 512.0},
     "request_latency_s":   {"type": "histogram", "values": [...]},
     "acc_headroom_utilization{site=stacks.0.attn.wq}":
                            {"type": "gauge", "value": 0.41}}

``merge_snapshots`` defines the fleet semantics: counters **add**, gauges
take the **max** (the conservative choice for utilizations, peaks and
capture counts), histograms **concatenate** raw values.  All three are
associative and commutative, so the merge of replica snapshots does not
depend on their grouping or arrival order.

``percentile`` is nearest-rank (``rank = ceil(q/100 · n)``): it returns an
*observed* sample even for tiny n — p99 of 5 samples is the max.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional, Sequence

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "percentile", "merge_snapshots",
]


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest observed value with at least
    ``q`` percent of samples at or below it.  0.0 on empty input ("no
    samples yet" reads as zero latency, the engine stats' convention)."""
    if not values:
        return 0.0
    xs = sorted(values)
    rank = math.ceil(q / 100.0 * len(xs))
    return float(xs[min(max(rank, 1), len(xs)) - 1])


def _key(name: str, labels: Optional[dict]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone accumulator.  ``set`` absorbs externally maintained totals
    (the engine's stats dicts) at snapshot time."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set(self, value: float) -> None:
        self.value = float(value)


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Raw-sample histogram: a run observes at most a few thousand
    requests, so raw values keep percentiles exact and the merge a
    concatenation."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: list = []

    def observe(self, value: float) -> None:
        self.values.append(float(value))

    def percentile(self, q: float) -> float:
        return percentile(self.values, q)

    @property
    def count(self) -> int:
        return len(self.values)


class MetricsRegistry:
    """Get-or-create registry keyed by ``(name, sorted labels)``."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, labels: Optional[dict]):
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = cls()
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {key!r} already registered as {type(m).__name__}")
        return m

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[dict] = None) -> Histogram:
        return self._get(Histogram, name, labels)

    def reset(self) -> None:
        self._metrics.clear()

    # -- snapshot contract --------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable view of every registered metric."""
        out = {}
        for key, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out[key] = {"type": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[key] = {"type": "gauge", "value": m.value}
            else:
                out[key] = {"type": "histogram", "values": list(m.values)}
        return out

    def load(self, snap: dict) -> None:
        """Restore metrics from a snapshot (a merged fleet view parked in a
        registry for percentile queries)."""
        for key, entry in snap.items():
            name, labels = _parse_key(key)
            if entry["type"] == "counter":
                self.counter(name, labels).set(entry["value"])
            elif entry["type"] == "gauge":
                self.gauge(name, labels).set(entry["value"])
            else:
                self.histogram(name, labels).values.extend(entry["values"])

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)


def _parse_key(key: str):
    if "{" not in key:
        return key, None
    name, rest = key.split("{", 1)
    labels = {}
    for pair in rest.rstrip("}").split(","):
        k, v = pair.split("=", 1)
        labels[k] = v
    return name, labels


def merge_snapshots(*snaps: dict) -> dict:
    """Fleet merge: counters add, gauges max, histograms concat.  Each rule
    is associative and commutative over its value domain, so any grouping or
    order of replica snapshots gives the same fleet view."""
    out: dict = {}
    for snap in snaps:
        for key, entry in snap.items():
            cur = out.get(key)
            if cur is None:
                out[key] = {
                    "type": entry["type"],
                    **({"values": list(entry["values"])} if entry["type"] == "histogram"
                       else {"value": entry["value"]}),
                }
                continue
            if cur["type"] != entry["type"]:
                raise TypeError(f"metric {key!r} merged across types "
                                f"{cur['type']!r} vs {entry['type']!r}")
            if entry["type"] == "counter":
                cur["value"] += entry["value"]
            elif entry["type"] == "gauge":
                cur["value"] = max(cur["value"], entry["value"])
            else:
                cur["values"].extend(entry["values"])
    return out
