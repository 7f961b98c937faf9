"""Exporters: Chrome-trace/Perfetto JSON and JSONL (a copy of
``repro/obs/export.py``).

Chrome trace event format (the JSON array flavor Perfetto's legacy
importer and ``chrome://tracing`` both load): every event carries ``ph``
(X = complete span, i = instant, C = counter, M = metadata), ``ts``
(microseconds), ``pid`` and ``tid``.  Tracks map to threads: each distinct
tracer track (one per engine slot, per pipeline stage, per pool) becomes
one ``tid`` with a ``thread_name`` metadata record, so the timeline opens
with labeled rows.  Registry gauge series export as ``ph="C"`` counter
tracks aligned on the same clock.

Open a trace: https://ui.perfetto.dev → "Open trace file" (or
``chrome://tracing`` → Load).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer


def chrome_trace(tracer: Tracer,
                 registry: Optional[MetricsRegistry] = None,
                 pid: int = 1, process_name: str = "repro") -> Dict:
    """Tracer (+ optional registry gauges) -> Chrome-trace JSON object."""
    events: List[Dict] = [{"ph": "M", "name": "process_name", "ts": 0.0,
                           "pid": pid, "tid": 0,
                           "args": {"name": process_name}}]
    tids: Dict[str, int] = {}

    def tid_for(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "ts": 0.0,
                           "pid": pid, "tid": tids[track],
                           "args": {"name": track}})
        return tids[track]

    for ev in tracer.events:
        base = {"name": ev["name"], "pid": pid,
                "tid": tid_for(ev["track"]),
                "ts": ev["ts"] * 1e6, "args": ev.get("args", {})}
        if ev["ph"] == "X":
            events.append({**base, "ph": "X", "dur": ev["dur"] * 1e6})
        else:
            events.append({**base, "ph": "i", "s": "t"})
    if registry is not None:
        for name, g in registry.gauges.items():
            tid = tid_for(f"counter:{name}")
            for t, v in g.series:
                events.append({"ph": "C", "name": name, "pid": pid,
                               "tid": tid, "ts": t * 1e6,
                               "args": {"value": v}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer: Tracer,
                       registry: Optional[MetricsRegistry] = None) -> int:
    """Write Chrome-trace JSON; returns the event count."""
    obj = chrome_trace(tracer, registry)
    with open(path, "w") as f:
        json.dump(obj, f)
    return len(obj["traceEvents"])


def write_jsonl(path: str, tracer: Tracer,
                registry: Optional[MetricsRegistry] = None) -> int:
    """One raw tracer event per line (seconds-domain timestamps), with a
    final ``{"metrics": ...}`` line when a registry rides along.  The
    grep-able flavor for offline analysis; Chrome trace is for eyeballs."""
    n = 0
    with open(path, "w") as f:
        for ev in tracer.events:
            f.write(json.dumps(ev) + "\n")
            n += 1
        if registry is not None:
            f.write(json.dumps({"metrics": registry.snapshot()}) + "\n")
            n += 1
    return n


def write_trace(path: str, tracer: Tracer,
                registry: Optional[MetricsRegistry] = None) -> int:
    """Suffix-dispatched writer behind the ``--trace-out`` launch flags:
    ``*.jsonl`` -> JSONL, anything else -> Chrome-trace JSON."""
    if path.endswith(".jsonl"):
        return write_jsonl(path, tracer, registry)
    return write_chrome_trace(path, tracer, registry)
