"""Counter / gauge / histogram registry with a scoped ``collect()`` context.

Counterpart of ``repro.obs.metrics``.  A :class:`Registry` holds labeled
metric series; the probe layer (``repro_torch.obs.probes``) writes into
every registry currently activated by a ``collect()`` context.  Everything
is plain Python ints/floats, recorded on the host from values the probed
call already holds there, and a registry serializes to flat JSON-safe
records (``to_dict`` / :func:`registry_from_dict` round-trip exactly,
``tests/test_torch_obs.py``).

Series identity is ``(name, sorted labels)``; the same call site with the
same labels accumulates into one series.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Mapping

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "registry_from_dict",
]

_Key = tuple[str, tuple[tuple[str, str], ...]]


def _key(name: str, labels: Mapping[str, object]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


@dataclasses.dataclass
class Counter:
    """Monotonically accumulating value (BT totals, dispatch counts)."""

    name: str
    labels: dict[str, str]
    value: float = 0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r}: negative inc {amount}")
        self.value += amount


@dataclasses.dataclass
class Gauge:
    """Last-write-wins value (current link count, active backend id)."""

    name: str
    labels: dict[str, str]
    value: float = 0

    def set(self, value: float) -> None:
        self.value = value


@dataclasses.dataclass
class Histogram:
    """Streaming count/sum/min/max summary (span walls, per-link BT)."""

    name: str
    labels: dict[str, str]
    count: int = 0
    sum: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Registry:
    """One scope's metric series, keyed by (name, labels)."""

    def __init__(self) -> None:
        self._counters: dict[_Key, Counter] = {}
        self._gauges: dict[_Key, Gauge] = {}
        self._histograms: dict[_Key, Histogram] = {}

    # ------------------------------------------------------------ factories
    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            c = self._counters[k] = Counter(name, dict(k[1]))
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            g = self._gauges[k] = Gauge(name, dict(k[1]))
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        k = _key(name, labels)
        h = self._histograms.get(k)
        if h is None:
            h = self._histograms[k] = Histogram(name, dict(k[1]))
        return h

    # -------------------------------------------------------------- queries
    def series(self, name: str) -> Iterator[Counter | Gauge | Histogram]:
        """Every series (any kind) with this metric name."""
        for store in (self._counters, self._gauges, self._histograms):
            for (n, _), s in store.items():
                if n == name:
                    yield s

    def value(self, name: str, **labels) -> float:
        """The value of one counter/gauge series (0 when never written)."""
        k = _key(name, labels)
        s = self._counters.get(k) or self._gauges.get(k)
        return 0 if s is None else s.value

    def __len__(self) -> int:
        return (
            len(self._counters) + len(self._gauges) + len(self._histograms)
        )

    # -------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        """Flat JSON-safe records (the metrics report schema)."""

        def num(v: float):
            return v if isinstance(v, int) or math.isfinite(v) else None

        return {
            "counters": [
                {"name": c.name, "labels": c.labels, "value": c.value}
                for c in self._counters.values()
            ],
            "gauges": [
                {"name": g.name, "labels": g.labels, "value": g.value}
                for g in self._gauges.values()
            ],
            "histograms": [
                {
                    "name": h.name,
                    "labels": h.labels,
                    "count": h.count,
                    "sum": h.sum,
                    "min": num(h.min),
                    "max": num(h.max),
                }
                for h in self._histograms.values()
            ],
        }


def registry_from_dict(doc: Mapping) -> Registry:
    """Rebuild a registry from :meth:`Registry.to_dict` output (the JSON
    round-trip used by the report layer and pinned in tests)."""
    reg = Registry()
    for rec in doc.get("counters", ()):
        reg.counter(rec["name"], **rec["labels"]).value = rec["value"]
    for rec in doc.get("gauges", ()):
        reg.gauge(rec["name"], **rec["labels"]).value = rec["value"]
    for rec in doc.get("histograms", ()):
        h = reg.histogram(rec["name"], **rec["labels"])
        h.count, h.sum = rec["count"], rec["sum"]
        h.min = math.inf if rec["min"] is None else rec["min"]
        h.max = -math.inf if rec["max"] is None else rec["max"]
    return reg
