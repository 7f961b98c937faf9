"""Timeline utilities: pipeline-tick synthesis and stage-time readout (a
copy of ``repro/obs/timeline.py``).

Two consumers share this module:

* :func:`stage_tick_times` turns measured ``stage_tick`` spans (emitted by
  :func:`repro_torch.runtime.trainer.probe_stage_times` when handed a tracer)
  back into the per-stage median times that
  :func:`repro_torch.core.load_balance.rebalance_stages` consumes — the probe
  and the rebalancer now read the *same* timeline instead of a side
  channel.  The median rule (sort, take ``[n // 2]``) matches the probe's
  own reduction exactly, so trace-fed and probe-fed rebalancing agree.

* :func:`synthesize_pipeline_ticks` walks the static
  :func:`repro_torch.core.pipeline.schedule_tables` tick tables and lays a
  modeled fwd/bwd span per (tick, stage) onto per-stage tracks: measured
  per-stage costs on the schedule's exact tick structure, bubbles visible
  as gaps, the same picture for every rank of a world.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

from repro_torch.obs.trace import Tracer


def stage_tick_times(events: Iterable[Dict], n_stages: int = 0,
                     name: str = "stage_tick") -> List[float]:
    """Per-stage median duration over ``name`` spans (args carry
    ``stage``).  Returns a list indexed by stage; stages with no samples
    get 0.0.  Median = sort then ``[n // 2]`` — the same reduction
    ``probe_stage_times`` applies to its raw samples."""
    per_stage: Dict[int, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") != name:
            continue
        s = int(ev.get("args", {}).get("stage", -1))
        if s < 0:
            continue
        per_stage.setdefault(s, []).append(float(ev["dur"]))
    if n_stages <= 0:
        n_stages = (max(per_stage) + 1) if per_stage else 0
    out = []
    for s in range(n_stages):
        samples = sorted(per_stage.get(s, []))
        out.append(samples[len(samples) // 2] if samples else 0.0)
    return out


def synthesize_pipeline_ticks(tracer: Tracer, schedule: str, n_stages: int,
                              n_micro: int, stage_times: Sequence[float],
                              t0: float = 0.0, bwd_cost_ratio: float = 2.0,
                              track_prefix: str = "stage") -> float:
    """Lay modeled per-tick fwd/bwd spans onto ``{track_prefix}{s}`` tracks.

    Walks the (T, S) micro-index tables from ``schedule_tables``; each
    tick advances global time by the max cost over the units active in it
    (stages step in lock-step — the synchronous-pipeline assumption the
    bubble model already makes), and every active (tick, stage) cell gets
    one span named ``pp.fwd`` / ``pp.bwd`` with args ``stage`` / ``micro``
    / ``tick``.  Returns the end time of the last tick.
    """
    from repro_torch.core.pipeline import schedule_tables

    fwd, bwd, _depth = schedule_tables(schedule, n_stages, n_micro)
    costs = [float(c) for c in stage_times]
    t = float(t0)
    for tick in range(fwd.shape[0]):
        active = []  # (stage, micro, is_bwd)
        for s in range(n_stages):
            mf, mb = int(fwd[tick, s]), int(bwd[tick, s])
            if mf >= 0:
                active.append((s, mf, False))
            if mb >= 0:
                active.append((s, mb, True))
        if not active:
            continue
        dt = max(costs[s] * (bwd_cost_ratio if is_bwd else 1.0)
                 for s, _m, is_bwd in active)
        for s, m, is_bwd in active:
            dur = costs[s] * (bwd_cost_ratio if is_bwd else 1.0)
            tracer.complete("pp.bwd" if is_bwd else "pp.fwd", t, t + dur,
                            track=f"{track_prefix}{s}",
                            stage=s, micro=m, tick=tick)
        t += dt
    return t
