"""Low-overhead tracer: nested spans + instant events in a bounded ring
(a copy of ``repro/obs/trace.py``).

One :class:`Tracer` owns a ring buffer (``collections.deque`` with
``maxlen``) of finished events — wraparound drops the *oldest* events, so a
long-running server keeps its newest timeline.  Three event kinds:

* spans — ``with tracer.span("decode_step", track="engine", step=i):`` —
  one ``ph="X"`` (complete) event per exit, stamped with the per-track
  nesting depth at entry;
* retroactive spans — :meth:`Tracer.complete` takes explicit (t0, t1):
  the serving engine builds per-request phase spans straight from the
  same :class:`~repro_torch.serving.metrics.RequestRecord` timestamps the
  TTFT/TPOT metrics read, so span durations reconcile with the report by
  construction;
* instants — :meth:`Tracer.instant` (``ph="i"``): scheduler decisions
  (admit / shed / pushback), rebalance events, kernel dispatches.

Time comes from an injectable ``clock`` callable (seconds).  Wall clock
(``time.perf_counter``) by default; the serving engine pins it to its
simulated :class:`~repro_torch.serving.traffic.Clock`, and tests pin a
:class:`ManualClock` for deterministic timelines.

The disabled path is near-free: ``Tracer(enabled=False)`` (or the shared
:data:`NULL_TRACER`) returns one module-level no-op context manager from
every ``span()`` call and drops instants/completes before touching the
clock — no event objects, no ring writes, no timestamps.  Hot call sites
guard their *argument* computation (e.g. roofline models) behind
``tracer.enabled`` so a disabled tracer costs one attribute check.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional


class ManualClock:
    """Injectable monotonic clock for deterministic tests and simulations:
    ``advance(dt)`` moves time forward; calling the clock reads it."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def advance(self, dt: float) -> None:
        assert dt >= 0.0
        self.now += dt

    def __call__(self) -> float:
        return self.now


class _NoopSpan:
    """Shared do-nothing context manager returned by disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """Live span handle: records (ts, dur, depth) on exit."""

    __slots__ = ("_tracer", "name", "track", "args", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str, track: str, args: Dict):
        self._tracer = tracer
        self.name, self.track, self.args = name, track, args

    def __enter__(self):
        tr = self._tracer
        self.depth = tr._depth.get(self.track, 0)
        tr._depth[self.track] = self.depth + 1
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t1 = tr.clock()
        tr._depth[self.track] = self.depth
        tr._events.append({"ph": "X", "name": self.name, "track": self.track,
                           "ts": self.t0, "dur": max(t1 - self.t0, 0.0),
                           "depth": self.depth, "args": self.args})
        return False


class Tracer:
    """Bounded-ring span/instant recorder with an injectable clock.

    ``capacity`` bounds the ring (oldest events drop first); ``clock`` is
    any zero-arg callable returning seconds.  ``enabled=False`` makes every
    recording method a no-op that allocates nothing.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True):
        self.enabled = enabled
        self.clock = clock if clock is not None else time.perf_counter
        self._events: deque = deque(maxlen=capacity)
        self._depth: Dict[str, int] = {}

    @property
    def capacity(self) -> int:
        return self._events.maxlen

    @property
    def events(self) -> List[Dict]:
        """Finished events, oldest first (children precede their parent —
        they exit first; Chrome-trace ``X`` events are order-independent)."""
        return list(self._events)

    def span(self, name: str, track: str = "main", **args):
        """Context manager timing a nested span on ``track``."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, track, args)

    def complete(self, name: str, t0: float, t1: float,
                 track: str = "main", **args) -> None:
        """Record an already-timed span retroactively (explicit t0/t1 on
        this tracer's clock domain)."""
        if not self.enabled:
            return
        self._events.append({"ph": "X", "name": name, "track": track,
                             "ts": t0, "dur": max(t1 - t0, 0.0),
                             "depth": self._depth.get(track, 0),
                             "args": args})

    def instant(self, name: str, track: str = "main", **args) -> None:
        if not self.enabled:
            return
        self._events.append({"ph": "i", "name": name, "track": track,
                             "ts": self.clock(), "args": args})

    def extend(self, events: Iterable[Dict]) -> None:
        """Merge finished events from another tracer (e.g. a probe-local
        tracer whose timeline should land in the session trace)."""
        if self.enabled:
            self._events.extend(events)

    def clear(self) -> None:
        self._events.clear()

    def span_names(self) -> Dict[str, int]:
        """Event-count histogram by name — the cheap trace summary the
        serve artifact's ``obs`` section carries."""
        out: Dict[str, int] = {}
        for ev in self._events:
            out[ev["name"]] = out.get(ev["name"], 0) + 1
        return out


NULL_TRACER = Tracer(capacity=1, enabled=False)


def or_null(tracer: Optional[Tracer]) -> Tracer:
    """The idiom every instrumented subsystem uses: ``tracer=None`` means
    the shared no-op tracer, never a None check per call site."""
    return tracer if tracer is not None else NULL_TRACER
