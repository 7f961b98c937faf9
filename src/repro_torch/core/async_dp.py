"""Asynchronous data parallelism with delay compensation (paper C7, Eq. 12;
port of ``repro/core/async_dp.py``).

A faithful *simulation* of a parameter server: P virtual workers push
gradients computed against stale parameter snapshots; the server applies
the trainer's real update rule with a delay-compensated learning rate

    theta_{t+1} = update(theta_t, g_p, eta / (1 + tau_p))     (Eq. 12)

where tau_p is the staleness of worker p's snapshot.  The optimizer is the
SAME plumbing ``runtime.trainer`` uses for the synchronous steps
(:func:`repro_torch.runtime.trainer.make_update_rule` — AdamW +
warmup-cosine), not a hand-rolled SGD, so staleness comparisons against
the sync baseline isolate staleness rather than optimizer differences.  The
staleness process is configurable (fixed, random, or straggler-heavy) and
delay compensation can be switched off to reproduce the naive-async
degradation.

Parameters are a tree of float tensors (nested dicts) or one tensor;
gradients come from ``torch.autograd.grad`` and the loss after each update
is taken under ``torch.no_grad()``.  The ring of snapshots holds the
tensors each update returns: the update is functional (``adamw_apply``
without ``donate``), so no later update writes into a snapshot.  As in
JAX, the update runs elementwise, not through the fused AdamW kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass
class AsyncConfig:
    n_workers: int = 4
    max_staleness: int = 4
    compensate: bool = True           # Eq. 12 down-weighting
    lr: float = 0.1
    staleness: str = "random"         # fixed | random | straggler
    warmup_steps: int = 1             # shared update rule's LR warmup


def _staleness_schedule(cfg: AsyncConfig, steps: int, rng: np.random.Generator
                        ) -> np.ndarray:
    """(steps,) worker id + staleness per arriving gradient."""
    if cfg.staleness == "fixed":
        tau = np.full(steps, cfg.max_staleness // 2)
    elif cfg.staleness == "random":
        tau = rng.integers(0, cfg.max_staleness + 1, steps)
    elif cfg.staleness == "straggler":
        # one slow worker contributes maximally stale gradients
        tau = rng.integers(0, 2, steps)
        worker = rng.integers(0, cfg.n_workers, steps)
        tau = np.where(worker == 0, cfg.max_staleness, tau)
    else:
        raise ValueError(cfg.staleness)
    return tau.astype(np.int32)


def _update_plumbing(lr: float, steps: int, warmup_steps: int):
    """The trainer's shared optimizer (AdamW + warmup-cosine), configured
    for a bare convergence study: no weight decay, no clipping."""
    from repro_torch.config import TrainConfig
    from repro_torch.runtime import trainer

    tcfg = TrainConfig(steps=steps, learning_rate=lr,
                       warmup_steps=max(warmup_steps, 1), weight_decay=0.0,
                       grad_clip=0.0, checkpoint_every=0)
    return trainer.make_update_rule(tcfg)


def _grad(loss_fn: Callable, params, batch):
    """d loss_fn(params, batch) / d params, shaped like ``params``."""
    xs = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, xs), batch)
    return tree_unflatten(params, list(torch.autograd.grad(loss, xs)))


@torch.no_grad()
def _loss(loss_fn: Callable, params, batch) -> float:
    return float(loss_fn(params, batch))


def simulate_async_sgd(loss_fn: Callable, params0, data_stream,
                       cfg: AsyncConfig, seed: int = 0
                       ) -> Tuple[object, List[float]]:
    """Run the async simulation.

    loss_fn(params, batch) -> scalar tensor; data_stream: iterable of
    batches.  Keeps a ring buffer of the last ``max_staleness+1`` parameter
    snapshots; each arriving gradient is computed at snapshot (t - tau_t)
    and applied through the trainer's shared update rule with the Eq.-12
    LR scale.
    """
    rng = np.random.default_rng(seed)
    batches = list(data_stream)
    steps = len(batches)
    tau_sched = _staleness_schedule(cfg, steps, rng)

    init, apply = _update_plumbing(cfg.lr, steps, cfg.warmup_steps)
    history = [params0] * (cfg.max_staleness + 1)   # ring of snapshots
    params = params0
    opt = init(params0)
    losses = []
    for t in range(steps):
        tau = int(min(tau_sched[t], t))             # cannot be staler than t
        stale_params = history[(t - tau) % len(history)]
        g = _grad(loss_fn, stale_params, batches[t])
        scale = 1.0 / (1.0 + tau) if cfg.compensate else 1.0
        with torch.no_grad():
            # rounded to float32 first, as JAX's jnp.float32(scale)
            params, opt = apply(params, opt, g, float(np.float32(scale)))
        history[t % len(history)] = params
        losses.append(_loss(loss_fn, params, batches[t]))
    return params, losses


def simulate_sync_sgd(loss_fn: Callable, params0, data_stream, lr: float,
                      warmup_steps: int = 1) -> Tuple[object, List[float]]:
    """Synchronous baseline on the same stream (Eq. 8/9), through the same
    shared update rule as the async simulator."""
    batches = list(data_stream)
    init, apply = _update_plumbing(lr, len(batches), warmup_steps)

    params = params0
    opt = init(params0)
    losses = []
    for batch in batches:
        g = _grad(loss_fn, params, batch)
        with torch.no_grad():
            params, opt = apply(params, opt, g, 1.0)
        losses.append(_loss(loss_fn, params, batch))
    return params, losses
