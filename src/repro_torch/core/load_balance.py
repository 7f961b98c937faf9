"""Adaptive load balancing (paper C4): the three mechanisms the paper folds
into its "adaptive load-balancing mechanism" (a copy of
``repro/core/load_balance.py``: host-side numpy, with
:func:`rebalance_moe_params` taking torch tensors too).

1. **Expert placement rebalancing** (MoE, §III.A.c): given observed per-expert
   token loads, re-assign experts to devices with LPT (longest-processing-time
   first) greedy bin packing so per-device load is near-uniform.  Returns the
   permutation to apply to the expert-sharded weight arrays.
2. **Pipeline stage partitioning** (§III.A.b): contiguous layer->stage
   partition minimizing the max stage cost (classic linear-partition DP) —
   kills pipeline "bubbles" from imbalanced stages.
3. **Adaptive per-worker batch sizing** (§V.A, heterogeneous hardware):
   largest-remainder proportional allocation of the global batch to workers
   by measured speed.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def rebalance_experts(load: Sequence[float], n_devices: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """LPT assignment of experts to devices.

    Returns (assignment (E,) device-id per expert, permutation (E,) such that
    experts[permutation] lays experts out contiguously by device with
    balanced per-device load).  E % n_devices == 0 is preserved: each device
    receives exactly E/n_devices experts (capacity-constrained LPT).
    """
    load = np.asarray(load, np.float64)
    E = load.shape[0]
    assert E % n_devices == 0
    cap = E // n_devices
    order = np.argsort(-load)                      # heaviest first
    dev_load = np.zeros(n_devices)
    dev_count = np.zeros(n_devices, np.int64)
    assignment = np.zeros(E, np.int64)
    for e in order:
        open_devs = np.where(dev_count < cap)[0]
        d = open_devs[np.argmin(dev_load[open_devs])]
        assignment[e] = d
        dev_load[d] += load[e]
        dev_count[d] += 1
    permutation = np.argsort(assignment, kind="stable")
    return assignment, permutation


def balance_quality(load: Sequence[float], assignment: np.ndarray,
                    n_devices: int) -> float:
    """max/mean per-device load (1.0 = perfect)."""
    load = np.asarray(load, np.float64)
    per_dev = np.bincount(assignment, weights=load, minlength=n_devices)
    return float(per_dev.max() / max(per_dev.mean(), 1e-12))


def balance_stages(layer_costs: Sequence[float], n_stages: int) -> List[int]:
    """Contiguous partition of layers into stages minimizing max stage cost.

    Returns stage boundaries: list of n_stages+1 indices (b[s], b[s+1]) is
    stage s's layer range.  O(L^2 * S) DP — L is small.
    """
    costs = np.asarray(layer_costs, np.float64)
    L = len(costs)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def seg(i, j):                                  # cost of layers [i, j)
        return prefix[j] - prefix[i]

    INF = float("inf")
    dp = np.full((n_stages + 1, L + 1), INF)
    cut = np.zeros((n_stages + 1, L + 1), np.int64)
    dp[0, 0] = 0.0
    for s in range(1, n_stages + 1):
        for j in range(1, L + 1):
            for i in range(s - 1, j):
                c = max(dp[s - 1, i], seg(i, j))
                if c < dp[s, j]:
                    dp[s, j] = c
                    cut[s, j] = i
    bounds = [L]
    j = L
    for s in range(n_stages, 0, -1):
        j = int(cut[s, j])
        bounds.append(j)
    return bounds[::-1]


def stage_costs(layer_costs: Sequence[float], bounds: List[int]
                ) -> np.ndarray:
    c = np.asarray(layer_costs, np.float64)
    return np.array([c[bounds[s]:bounds[s + 1]].sum()
                     for s in range(len(bounds) - 1)])


def layer_costs_from_stage_times(stage_times: Sequence[float],
                                 bounds: Sequence[int]) -> np.ndarray:
    """Per-layer cost estimate from observed per-stage timings.

    Timing granularity is the stage (one tick = one stage_fn call), so a
    stage's measured time is attributed uniformly to its layers — exact
    when layers inside a stage are homogeneous, and a contraction toward
    the fix-point otherwise (each rebalance re-measures at the new
    partition)."""
    bounds = list(bounds)
    costs = np.zeros(bounds[-1], np.float64)
    for s in range(len(bounds) - 1):
        n = bounds[s + 1] - bounds[s]
        costs[bounds[s]:bounds[s + 1]] = float(stage_times[s]) / max(n, 1)
    return costs


def rebalance_stages(stage_times: Sequence[float], bounds: Sequence[int],
                     n_stages: int = 0) -> List[int]:
    """Close the observe->rebalance loop for pipeline stages (the stage
    analogue of ``rebalance_experts`` -> ``rebalance_moe_params``): observed
    per-tick stage timings re-carve the layer->stage bounds via the same
    linear-partition DP.  Apply the new bounds to live stage params with
    :func:`repro_torch.models.transformer.remap_stage_params` — the remap is
    output-preserving (layer order never changes, only the carve points).
    """
    bounds = list(bounds)
    n_stages = n_stages or len(bounds) - 1
    costs = layer_costs_from_stage_times(stage_times, bounds)
    return balance_stages(costs, n_stages)


def rebalance_from_trace(events, bounds: Sequence[int],
                         n_stages: int = 0) -> List[int]:
    """:func:`rebalance_stages` fed straight from the observability
    timeline: per-stage times are the medians of ``stage_tick`` span
    durations (:func:`repro_torch.obs.timeline.stage_tick_times` — the same
    sort-then-middle reduction ``probe_stage_times`` applies), so a
    recorded trace can drive the rebalance decision in place of a live
    probe."""
    from repro_torch.obs.timeline import stage_tick_times
    bounds = list(bounds)
    n_stages = n_stages or len(bounds) - 1
    times = stage_tick_times(events, n_stages)
    return rebalance_stages(times, bounds, n_stages)


def adaptive_batch_allocation(worker_speeds: Sequence[float],
                              global_batch: int,
                              min_per_worker: int = 1) -> np.ndarray:
    """Largest-remainder proportional split of the global batch by speed."""
    speeds = np.asarray(worker_speeds, np.float64)
    P = len(speeds)
    assert global_batch >= P * min_per_worker
    frac = speeds / speeds.sum() * (global_batch - P * min_per_worker)
    base = np.floor(frac).astype(np.int64) + min_per_worker
    rem = global_batch - base.sum()
    order = np.argsort(-(frac - np.floor(frac)))
    base[order[:rem]] += 1
    return base


def straggler_dropk_weights(arrival_order: Sequence[int], drop_k: int
                            ) -> np.ndarray:
    """Backup-worker semantics: weight 0 for the last ``drop_k`` arrivals,
    renormalized mean over the rest."""
    P = len(arrival_order)
    w = np.ones(P)
    slowest = np.argsort(arrival_order)[-drop_k:] if drop_k else []
    w[slowest] = 0.0
    return w / w.sum()


def rebalance_moe_params(moe_params: dict, permutation: np.ndarray) -> dict:
    """Apply an expert permutation to a live MoE layer (router columns +
    expert-stacked weights).  The model function is permutation-equivariant
    -- outputs are bit-identical -- but the experts' physical placement on
    the ``model`` mesh axis follows the LPT assignment, balancing
    per-device load (paper C4, closing the observe->rebalance loop).

    Works on one layer's params or on layer-stacked (L, E, ...) arrays
    (same permutation applied to every layer), numpy arrays or torch
    tensors.
    """
    perm = [int(i) for i in permutation]
    out = dict(moe_params)
    out["router"] = moe_params["router"][..., perm]
    for key in ("wi", "wi_gate", "wi_up", "wo"):
        if key in moe_params:
            w = moe_params[key]
            axis = w.ndim - 3                   # (..., E, din, dout)
            if isinstance(w, np.ndarray):
                out[key] = np.take(w, perm, axis=axis)
            else:
                out[key] = w.index_select(axis, torch.tensor(
                    perm, dtype=torch.long, device=w.device))
    return out
