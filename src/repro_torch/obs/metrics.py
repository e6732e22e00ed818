"""Unified metrics registry: counters, gauges, fixed-bucket log
histograms, and binned time-series — one naming scheme for ledgers that
previously lived as ad-hoc dicts (``EngineStats``, the engine step
ledger, kvstore tier counters, admission rejections).

Naming scheme: dotted lowercase paths, subsystem first —
``engine.transfers``, ``engine.step.bytes``, ``kvstore.hits``,
``serving.rejections`` — with dimensions as **labels** (keyword
arguments on ``inc``/``set``/``get``), not name suffixes:

    registry.counter("kvstore.hits").inc(tier="gpu")
    registry.counter("engine.step.bytes").inc(nbytes, step=7)

Two collection styles coexist deliberately:

  * **push** — low-frequency ledgers (per-transfer, per-page, per-
    rejection) write the registry directly;
  * **pull** — per-chunk hot-path tallies (``LinkWorker`` byte ledgers)
    stay as plain attributes and are synced into gauges at snapshot
    time (``MMAEngine.sync_metrics``), so the dispatch loop never pays
    a registry lookup per chunk.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, Any], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted(labels.items()))


def _label_str(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class _Metric:
    """Shared label-cell storage for counters and gauges."""

    kind = "metric"

    def __init__(self, name: str) -> None:
        self.name = name
        self._cells: Dict[LabelKey, float] = {}

    def get(self, **labels: Any) -> float:
        return self._cells.get(_label_key(labels), 0)

    def set(self, value: float, **labels: Any) -> None:
        self._cells[_label_key(labels)] = value

    def total(self) -> float:
        return sum(self._cells.values())

    def labels(self) -> List[LabelKey]:
        return list(self._cells)

    def items(self) -> Iterator[Tuple[Dict[str, Any], float]]:
        for key, value in self._cells.items():
            yield dict(key), value

    def as_dict(self) -> Any:
        """Scalar for the single unlabeled cell, else a flat
        ``"k=v,..." -> value`` map (JSON-ready)."""
        if not self._cells:
            return 0
        if len(self._cells) == 1 and () in self._cells:
            return self._cells[()]
        return {_label_str(k): v for k, v in sorted(
            self._cells.items(), key=lambda kv: _label_str(kv[0])
        )}


class Counter(_Metric):
    """Monotone-by-convention accumulator (``inc`` may carry a negative
    delta only to undo provisional accounting, e.g. a preempted chunk's
    refund)."""

    kind = "counter"

    def inc(self, n: float = 1, **labels: Any) -> None:
        key = _label_key(labels)
        self._cells[key] = self._cells.get(key, 0) + n


class Gauge(_Metric):
    """Point-in-time value (queue depth, residency bytes, EWMA rate)."""

    kind = "gauge"


class LogHistogram:
    """Fixed-bucket base-2 log histogram: values land in bucket
    ``ceil(log2(v))`` clamped to ``[min_exp, max_exp]``. O(1) observe,
    O(buckets) summary — the shape latency/size distributions need
    without per-sample storage."""

    kind = "histogram"

    def __init__(
        self, name: str, min_exp: int = -20, max_exp: int = 40
    ) -> None:
        self.name = name
        self.min_exp = min_exp
        self.max_exp = max_exp
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0

    def _bucket(self, value: float) -> int:
        if value <= 0:
            return self.min_exp
        e = math.ceil(math.log2(value))
        return max(self.min_exp, min(self.max_exp, int(e)))

    def observe(self, value: float, n: int = 1) -> None:
        b = self._bucket(value)
        self._buckets[b] = self._buckets.get(b, 0) + n
        self.count += n
        self.sum += value * n

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Upper bucket bound containing the q-quantile (bucket-granular,
        exact to within one power of two)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for exp in sorted(self._buckets):
            seen += self._buckets[exp]
            if seen >= target:
                return 2.0 ** exp
        return 2.0 ** max(self._buckets)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "buckets_le": {
                f"{2.0 ** e:g}": n for e, n in sorted(self._buckets.items())
            },
        }


class BinnedTimeline:
    """Incremental time-binned accumulator: ``add(t, v)`` is O(1), and
    rate/series queries are O(bins in range) — the windowed primitive
    behind ``SimLink`` throughput and ``FlowRecorder`` timelines
    (which previously re-summed their full event lists per call)."""

    kind = "timeline"

    def __init__(self, bin_s: float = 0.05) -> None:
        if bin_s <= 0:
            raise ValueError(f"bin_s must be positive, got {bin_s!r}")
        self.bin_s = bin_s
        self._bins: Dict[int, float] = {}
        self.total = 0.0
        self.t_last = 0.0

    def add(self, t: float, value: float) -> None:
        b = int(t // self.bin_s)
        self._bins[b] = self._bins.get(b, 0.0) + value
        self.total += value
        if t > self.t_last:
            self.t_last = t

    def bin(self, index: int) -> float:
        """Accumulated value of one bin (0.0 when untouched)."""
        return self._bins.get(index, 0.0)

    def value_between(self, t0: float, t1: float) -> float:
        """Sum over bins whose midpoint falls in [t0, t1] (bin-granular:
        exact when t0/t1 sit on bin edges)."""
        if t1 < t0:
            return 0.0
        b0, b1 = int(t0 // self.bin_s), int(t1 // self.bin_s)
        if b1 - b0 > len(self._bins):
            return sum(
                v for b, v in self._bins.items() if b0 <= b <= b1
            )
        return sum(self._bins.get(b, 0.0) for b in range(b0, b1 + 1))

    def rate(self, t0: float, t1: float) -> float:
        """Mean value/second over [t0, t1]."""
        if t1 <= t0:
            return 0.0
        return self.value_between(t0, t1) / (t1 - t0)

    def series(self, t_end: Optional[float] = None) -> List[Tuple[float, float]]:
        """Dense ``(bin_midpoint, value/s)`` rows from the first filled
        bin through ``t_end`` (default: last observed event)."""
        if not self._bins:
            return []
        t_end = self.t_last if t_end is None else t_end
        b0 = min(self._bins)
        b1 = max(int(t_end // self.bin_s), b0)
        return [
            ((b + 0.5) * self.bin_s, self._bins.get(b, 0.0) / self.bin_s)
            for b in range(b0, b1 + 1)
        ]


class MetricsRegistry:
    """Get-or-create home for named metrics. One registry per engine /
    store / orchestrator; ``as_dict()`` is the JSON-ready snapshot
    reports embed."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, factory, kind: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = factory(name)
        elif m.kind != kind:
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {kind}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, "gauge")

    def histogram(self, name: str) -> LogHistogram:
        return self._get(name, LogHistogram, "histogram")

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def as_dict(self, prefix: str = "") -> Dict[str, Any]:
        return {
            name: m.as_dict()
            for name, m in sorted(self._metrics.items())
            if name.startswith(prefix) and m.kind != "timeline"
        }
