"""Straggler mitigation (paper §V.B robustness): simulation harness for
heterogeneous / flaky workers and the three mitigation policies (a copy of
``repro/runtime/straggler.py``: host-side numpy, so its results equal the
JAX package's exactly).

Policies over a step with per-worker speeds s_p (samples/sec):
* ``uniform``  — B/P samples each; step time = max_p((B/P)/s_p).
* ``adaptive`` — batch allocated by ``load_balance.adaptive_batch_allocation``
  (paper's adaptive batch sizing): step time = max_p(b_p/s_p).
* ``dropk``    — uniform batches but the slowest k workers' gradients are
  dropped (backup-worker semantics); effective samples shrink accordingly.

The accumulators live on a :class:`repro_torch.obs.metrics.MetricsRegistry`
(a private one per call when none is handed in): a step-time histogram,
useful-samples counter, and per-step gauges — the simulated step clock is
an injectable :class:`repro_torch.obs.trace.ManualClock`, so the gauge
series advance on simulation time, not wall time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import load_balance
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import ManualClock


@dataclasses.dataclass
class StragglerSim:
    n_workers: int = 8
    base_speed: float = 1000.0        # samples/sec/worker
    hetero_cv: float = 0.3            # speed coefficient of variation
    flaky_prob: float = 0.05          # per-step chance a worker runs 4x slow
    seed: int = 0

    def speeds(self, steps: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        base = self.base_speed * np.maximum(
            0.1, rng.normal(1.0, self.hetero_cv, self.n_workers))
        out = np.tile(base, (steps, 1))
        flaky = rng.random((steps, self.n_workers)) < self.flaky_prob
        out[flaky] /= 4.0
        return out


def run_policy(sim: StragglerSim, global_batch: int, steps: int,
               policy: str = "uniform", drop_k: int = 1,
               realloc_every: int = 10,
               metrics: Optional[MetricsRegistry] = None,
               clock: Optional[ManualClock] = None) -> Dict[str, float]:
    """Returns effective throughput (useful samples/sec) and step stats.

    ``metrics``: obs registry the per-step accumulators live on —
    ``straggler.step_time_s`` histogram, ``straggler.useful_samples``
    counter, ``straggler.slowest_worker_t`` gauge (timestamped by
    ``clock``, the simulated step clock, which ends at the total simulated
    duration).  The returned dict reads back out of the registry, so an
    attached caller sees exactly the reported numbers."""
    metrics = metrics if metrics is not None else MetricsRegistry()
    clock = clock if clock is not None else ManualClock()
    metrics.clock = clock
    hist = metrics.histogram("straggler.step_time_s")
    useful_c = metrics.counter("straggler.useful_samples")
    gauge = metrics.gauge("straggler.slowest_worker_t")
    speeds = sim.speeds(steps)
    P = sim.n_workers
    alloc = np.full(P, global_batch // P)
    for t in range(steps):
        s = speeds[t]
        if policy == "adaptive" and t % realloc_every == 0:
            # allocate by trailing observed speed (causal: use step t-1)
            obs = speeds[max(t - 1, 0)]
            alloc = load_balance.adaptive_batch_allocation(obs, global_batch)
        elif policy != "adaptive":
            alloc = np.full(P, global_batch // P)
        per_worker_t = alloc / s
        if policy == "dropk":
            # step completes when the (P-k)-th worker finishes
            finish = np.sort(per_worker_t)
            t_step = finish[P - 1 - drop_k]
            done = per_worker_t <= t_step + 1e-12
            useful_c.inc(float(alloc[done].sum()))
        else:
            t_step = per_worker_t.max()
            useful_c.inc(float(alloc.sum()))
        clock.advance(float(t_step))        # simulated step clock
        hist.observe(float(t_step))
        gauge.set(float(per_worker_t.max()))
    total_t = hist.total
    return {"throughput": float(useful_c.value / total_t),
            "mean_step_time": total_t / steps,
            "useful_frac": float(useful_c.value / (global_batch * steps))}


def compare_policies(sim: StragglerSim, global_batch: int = 1024,
                     steps: int = 200) -> Dict[str, Dict[str, float]]:
    return {p: run_policy(sim, global_batch, steps, p)
            for p in ("uniform", "adaptive", "dropk")}
