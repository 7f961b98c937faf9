"""Serving latency/throughput metrics with SLO attainment (port of
``repro/serving/metrics.py``).

All times are seconds on the engine's clock (simulated or wall):

* TTFT  — time to first token: ``first_token - arrival`` (includes queue
  wait and prefill).
* TPOT  — time per output token after the first:
  ``(finished - first_token) / (tokens_out - 1)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class RequestRecord:
    """Per-request lifecycle timestamps filled in by the engine."""

    rid: int
    user_id: int = 0
    prompt_len: int = 0
    slo_name: str = ""
    ttft_slo_s: float = math.inf
    tpot_slo_s: float = math.inf
    arrival: float = 0.0
    admitted: Optional[float] = None      # prefill started
    first_token: Optional[float] = None   # first generated token emitted
    finished: Optional[float] = None
    tokens_out: int = 0
    rejected: bool = False                # bounded admission queue was full

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.finished is None or self.tokens_out < 2:
            return None
        return (self.finished - self.first_token) / (self.tokens_out - 1)

    @property
    def slo_met(self) -> Optional[bool]:
        if self.finished is None:
            return None
        ok = self.ttft <= self.ttft_slo_s
        if self.tpot is not None:
            ok = ok and self.tpot <= self.tpot_slo_s
        return bool(ok)


# Percentile math lives in repro_torch.obs.metrics; re-exported here because
# serving callers and tests address it as serving.metrics.percentile.
percentile = obs_metrics.percentile


class WindowedLatency:
    """Sliding-window TTFT/TPOT histograms over the most recent
    observations: two registry histograms (``<name>.ttft_window`` /
    ``<name>.tpot_window``) whose ``max_samples`` caps the window, so the
    recent latency picture shows up in the registry snapshot the trace
    exporter dumps, as in the JAX engine."""

    def __init__(self, registry: "obs_metrics.MetricsRegistry",
                 name: str, window: int = 64):
        self._ttft = registry.histogram(f"{name}.ttft_window",
                                        max_samples=window)
        self._tpot = registry.histogram(f"{name}.tpot_window",
                                        max_samples=window)

    def observe_ttft(self, s: float) -> None:
        self._ttft.observe(s)

    def observe_tpot(self, s: float) -> None:
        self._tpot.observe(s)


def _dist(xs: List[float]) -> Dict[str, float]:
    """Distribution summary via the obs histogram readout -- exact while the
    sample window holds everything, which it always does for serve runs."""
    h = obs_metrics.Histogram()
    for x in xs:
        h.observe(x)
    return h.summary()


def summarize(records: Sequence[RequestRecord],
              elapsed_s: float) -> Dict:
    """Aggregate a serve run into the report printed by the launcher."""
    finished = [r for r in records if r.finished is not None]
    rejected = [r for r in records if r.rejected]
    tokens = sum(r.tokens_out for r in finished)
    ttfts = [r.ttft for r in finished]
    tpots = [r.tpot for r in finished if r.tpot is not None]
    waits = [r.admitted - r.arrival for r in finished
             if r.admitted is not None]

    slo: Dict[str, Dict[str, float]] = {}
    for tier in sorted({r.slo_name for r in finished if r.slo_name}):
        tier_reqs = [r for r in finished if r.slo_name == tier]
        met = sum(1 for r in tier_reqs if r.slo_met)
        slo[tier] = {"requests": len(tier_reqs),
                     "attainment": met / len(tier_reqs)}

    return {
        "requests": len(records),
        "finished": len(finished),
        "rejected": len(rejected),
        "elapsed_s": elapsed_s,
        "tokens_out": tokens,
        "throughput_tok_s": tokens / elapsed_s if elapsed_s > 0 else 0.0,
        "requests_per_s": (len(finished) / elapsed_s
                           if elapsed_s > 0 else 0.0),
        "ttft_s": _dist(ttfts),
        "tpot_s": _dist(tpots),
        "queue_wait_s": _dist(waits),
        "slo": slo,
    }


def format_report(summary: Dict, title: str = "serve") -> str:
    """Human-readable one-screen report."""
    t, p = summary["ttft_s"], summary["tpot_s"]
    lines = [
        f"[{title}] {summary['finished']}/{summary['requests']} requests "
        f"({summary['rejected']} rejected), "
        f"{summary['tokens_out']} tokens in {summary['elapsed_s']:.2f}s",
        f"  throughput  {summary['throughput_tok_s']:.1f} tok/s, "
        f"{summary['requests_per_s']:.1f} req/s",
        f"  ttft  p50 {t['p50'] * 1e3:.1f}ms  p95 {t['p95'] * 1e3:.1f}ms  "
        f"p99 {t['p99'] * 1e3:.1f}ms",
        f"  tpot  p50 {p['p50'] * 1e3:.1f}ms  p95 {p['p95'] * 1e3:.1f}ms  "
        f"p99 {p['p99'] * 1e3:.1f}ms",
    ]
    for tier, s in summary["slo"].items():
        lines.append(f"  slo[{tier}]  {s['attainment'] * 100:.0f}% "
                     f"of {s['requests']} requests")
    return "\n".join(lines)
