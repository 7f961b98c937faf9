"""Metrics registry: counters, gauges, and histograms with exact
percentile readout (a copy of ``repro/obs/metrics.py``).

The registry is the numeric half of the observability layer (spans are the
temporal half): named counters (monotone totals — prefix hits, COW events,
useful samples), gauges (instantaneous values with a bounded time series —
live pool blocks, active slots), and histograms.

A :class:`Histogram` keeps *both* views of a sample stream: fixed
log-spaced bucket counts (the cheap aggregate a dashboard would scrape)
and the exact sample list (bounded by ``max_samples``), so percentile
readout is **exact** — :meth:`Histogram.percentile` reproduces
:func:`percentile` (numpy's default linear-interpolation method) to the
bit while the sample window holds every observation, and degrades to
bucket interpolation only after ``max_samples`` observations drop out of
the window.  :mod:`repro_torch.serving.metrics` delegates its
``percentile`` / ``_dist`` math here instead of keeping a private copy.

Gauge series are stamped by the registry's injectable ``clock`` (same
contract as :class:`repro_torch.obs.trace.Tracer`), so a registry attached
to the serving engine keeps pool-occupancy series on the *simulated* clock
and exports them as Chrome-trace counter tracks aligned with the spans.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def percentile(xs: Sequence[float], q: float) -> float:
    """Linearly-interpolated percentile (numpy's default method), q in
    [0, 100].  NaN for an empty sample.

    Bit-identical to ``np.percentile``: the interpolation replicates
    numpy's ``_lerp``, which evaluates from the far edge once the
    fractional rank passes 0.5 (``b - (b - a)*(1 - t)``) — the detail
    that makes the last ulp agree."""
    xs = sorted(float(x) for x in xs)
    if not xs:
        return float("nan")
    if len(xs) == 1:
        return xs[0]
    rank = (q / 100.0) * (len(xs) - 1)
    lo = min(int(math.floor(rank)), len(xs) - 2)
    t = rank - lo
    a, b = xs[lo], xs[lo + 1]
    if t >= 0.5:
        return b - (b - a) * (1.0 - t)
    return a + (b - a) * t


# log-spaced seconds-scale latency bounds: 100us .. ~100s
DEFAULT_BOUNDS: Tuple[float, ...] = tuple(
    1e-4 * (10 ** (i / 4)) for i in range(25))


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-value gauge with a bounded (t, value) series and a running
    peak; series timestamps come from the owning registry's clock."""

    __slots__ = ("_registry", "value", "peak", "series")

    def __init__(self, registry: "MetricsRegistry", max_points: int = 4096):
        self._registry = registry
        self.value: Optional[float] = None
        self.peak = -math.inf
        self.series: deque = deque(maxlen=max_points)

    def set(self, v: float, t: Optional[float] = None) -> None:
        """Set the gauge; ``t`` overrides the registry clock stamp (used
        when several engines share one registry but run on distinct
        simulated clocks)."""
        v = float(v)
        self.value = v
        self.peak = max(self.peak, v)
        self.series.append((self._registry.clock() if t is None else t, v))


class Histogram:
    """Fixed-bucket histogram retaining an exact sample window.

    ``bounds`` are bucket upper edges (one overflow bucket past the last);
    ``observe`` updates bucket counts, count/total/min/max, and appends to
    the sample window (insertion order — the mean is the same left-to-right
    float sum the pre-obs serving metrics computed)."""

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS,
                 max_samples: int = 100_000):
        self.bounds = tuple(float(b) for b in bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: deque = deque(maxlen=max_samples)

    @property
    def samples(self) -> List[float]:
        return list(self._samples)

    @property
    def exact(self) -> bool:
        """True while the sample window still holds every observation."""
        return len(self._samples) == self.count

    def observe(self, x: float) -> None:
        x = float(x)
        i = 0
        for i, b in enumerate(self.bounds):          # noqa: B007
            if x <= b:
                break
        else:
            i = len(self.bounds)
        self.bucket_counts[i] += 1
        self.count += 1
        self.total += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        self._samples.append(x)

    def percentile(self, q: float) -> float:
        """Exact (sample-window) percentile; bucket linear interpolation
        once observations have aged out of the window."""
        if self.count == 0:
            return float("nan")
        if self.exact:
            return percentile(self._samples, q)
        # bucket fallback: rank within cumulative counts, interpolate
        # linearly inside the owning bucket
        rank = (q / 100.0) * (self.count - 1)
        seen = 0
        lo_edge = self.min
        for i, c in enumerate(self.bucket_counts):
            if c == 0:
                continue
            hi_edge = (self.bounds[i] if i < len(self.bounds) else self.max)
            hi_edge = min(hi_edge, self.max)
            if rank < seen + c:
                frac = (rank - seen + 1) / c
                return lo_edge + (hi_edge - lo_edge) * min(frac, 1.0)
            seen += c
            lo_edge = hi_edge
        return self.max

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"mean": float("nan"), "p50": float("nan"),
                    "p95": float("nan"), "p99": float("nan")}
        mean = (sum(self._samples) / len(self._samples) if self.exact
                else self.total / self.count)
        return {"mean": mean, "p50": self.percentile(50),
                "p95": self.percentile(95), "p99": self.percentile(99)}


class MetricsRegistry:
    """Named counters/gauges/histograms behind get-or-create accessors."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock if clock is not None else time.perf_counter
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if name not in self._counters:
            self._counters[name] = Counter()
        return self._counters[name]

    def gauge(self, name: str, max_points: int = 4096) -> Gauge:
        if name not in self._gauges:
            self._gauges[name] = Gauge(self, max_points)
        return self._gauges[name]

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BOUNDS,
                  max_samples: Optional[int] = None) -> Histogram:
        """Get-or-create; ``max_samples`` (first-create only) bounds the
        exact sample window — a small window makes the histogram a
        sliding window over *recent* observations, which is what the
        disagg router percentiles over."""
        if name not in self._histograms:
            self._histograms[name] = Histogram(
                bounds, max_samples if max_samples is not None else 100_000)
        return self._histograms[name]

    @property
    def gauges(self) -> Dict[str, Gauge]:
        return dict(self._gauges)

    def snapshot(self) -> Dict:
        """JSON-ready dump for benchmark artifacts and launch summaries."""
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: {"value": g.value, "peak": g.peak,
                           "points": len(g.series)}
                       for k, g in self._gauges.items()},
            "histograms": {k: {"count": h.count, **h.summary()}
                           for k, h in self._histograms.items()},
        }
