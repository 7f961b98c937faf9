"""The paper's explicit data-parallel train step and the training loop
(port of ``make_dp_train_step``, ``make_update_rule`` and ``train_loop``
of ``repro/runtime/trainer.py``).

The JAX step runs inside ``shard_map`` over the dp mesh axes; here every
rank of a ``torch.distributed`` world runs it on its slice of the global
batch (dim 0, in the JAX mesh's device order) and syncs the gradients by
hand: flat all-reduce (Eq. 8), hierarchical all-reduce (C5), or
compressed all-gather with error feedback (C6, Eq. 10-11).  Parameters
and optimizer state are replicated; the residual is this rank's flat
``(N_pad,)`` f32 error-feedback state (row ``r`` of JAX's ``(P, N_pad)``).

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md):
the rows-touched embedding sync and ZeRO over the vocab dim
(``embed_sync``), the checkpoint manager (``checkpoint_every > 0``), the
hybrid GSPMD and pipelined steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.config import TrainConfig
from repro_torch.core import compression, hierarchical
from repro_torch.core.hierarchical import DPMesh
from repro_torch.optimizer import adamw, schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class DPSyncConfig:
    mode: str = "flat"              # flat | hierarchical | onebit | topk
    intra_axis: str = "data"
    inter_axis: Optional[str] = None
    block: int = 512
    topk_block: int = 2048
    k: int = 32
    use_kernel: bool = True


def residual_size(params, scfg: DPSyncConfig) -> int:
    """Flat padded size of the compression error-feedback state."""
    n = sum(x.numel() for x in tree_leaves(params))
    mult = 8 * scfg.block if scfg.mode == "onebit" else scfg.topk_block
    return n + ((-n) % mult)


def _clock(split: Optional[Dict[str, float]], device) -> float:
    """The host clock after the device's queued work, when measuring."""
    if split is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def make_dp_train_step(loss_fn: Callable, mesh: DPMesh, tcfg: TrainConfig,
                       scfg: DPSyncConfig = DPSyncConfig(),
                       embed_sync=None):
    """step(params, opt, residual, batch, split=None) -> (params, opt,
    residual, loss).

    ``loss_fn(params, batch)`` returns a scalar; ``batch`` is the global
    batch, of which this rank takes its slice on dim 0.  ``loss`` is the
    mean over the dp ranks.  ``split``, when a dict, accumulates the
    step's seconds in ``fwd_bwd``, ``sync`` and ``opt`` (the device is
    synchronised at each boundary, so pass it only to measure)."""
    if embed_sync is not None:
        raise NotImplementedError(
            "embed_sync (rows-touched embedding sync, zero_opt) is not "
            "ported yet; see ROADMAP.md")
    axes = (scfg.intra_axis,) + ((scfg.inter_axis,) if scfg.inter_axis
                                 else ())
    world = mesh.size(axes)
    shard = mesh.shard_index(axes)
    compressed = scfg.mode in ("onebit", "topk")
    if compressed:
        csync = compression.make_compressed_sync(
            scfg.mode, mesh=mesh, axis=scfg.intra_axis,
            block=scfg.block if scfg.mode == "onebit" else scfg.topk_block,
            k=scfg.k, use_kernel=scfg.use_kernel)
    else:
        gsync = hierarchical.make_sync_fn(scfg.mode, mesh, scfg.intra_axis,
                                          scfg.inter_axis)

    def local_batch(batch):
        return {k: v[shard * (v.shape[0] // world):
                     (shard + 1) * (v.shape[0] // world)]
                for k, v in batch.items()}

    def step(params, opt, residual, batch, split=None):
        device = tree_leaves(params)[0].device
        marks = [_clock(split, device)]
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(leaves, local_batch(batch))
        grads = tree_unflatten(leaves, list(torch.autograd.grad(
            loss, tree_leaves(leaves))))
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=mesh.group(axes))
        loss = loss / world
        marks.append(_clock(split, device))
        with torch.no_grad():
            if compressed:
                grads, new_res = csync(grads, residual)
                if scfg.inter_axis:                 # hierarchy: pods too
                    grads = tree_map(
                        lambda g: hierarchical.flat_allreduce_mean(
                            g, mesh, (scfg.inter_axis,)), grads)
            else:
                grads = gsync(grads)
                new_res = residual
            marks.append(_clock(split, device))
            lr = schedule.warmup_cosine(opt["step"], tcfg.learning_rate,
                                        tcfg.warmup_steps, tcfg.steps)
            new_params, new_opt = adamw.adamw_apply(params, grads, opt, lr,
                                                    tcfg)
        if split is not None:
            marks.append(_clock(split, device))
            for key, a, b in zip(("fwd_bwd", "sync", "opt"), marks,
                                 marks[1:]):
                split[key] = split.get(key, 0.0) + b - a
        return new_params, new_opt, new_res, loss

    return step


def make_update_rule(tcfg: TrainConfig):
    """The trainer's optimizer plumbing (AdamW + warmup-cosine LR) as
    (init, apply): ``init(params) -> opt``; ``apply(params, opt, grads,
    lr_scale=1.0) -> (params, opt)``."""

    def init(params):
        return adamw.init_opt_state(params)

    def apply(params, opt, grads, lr_scale=1.0):
        lr = schedule.warmup_cosine(opt["step"], tcfg.learning_rate,
                                    tcfg.warmup_steps, tcfg.steps)
        return adamw.adamw_apply(params, grads, opt, lr * lr_scale, tcfg)

    return init, apply


@dataclasses.dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: list
    throughput: float               # samples/sec (host wall clock)


def train_loop(state: Dict[str, Any], batches: Iterator, step_fn: Callable,
               tcfg: TrainConfig, *, samples_per_batch: int = 0,
               log_every: int = 10, verbose: bool = False) -> TrainResult:
    """Generic loop over state = {'params', 'opt', 'residual'} with
    ``step_fn(params, opt, residual, batch) -> (params, opt, residual,
    loss)``.  The JAX loop's rebalance hook, tracer and failure injection
    belong to slices not ported yet."""
    if tcfg.checkpoint_every:
        raise NotImplementedError(
            "checkpoint_every > 0: the checkpoint manager is not ported "
            "yet (set checkpoint_every=0; see ROADMAP.md)")
    losses = []
    t0 = time.perf_counter()
    for batch in batches:
        state["params"], state["opt"], state["residual"], loss = step_fn(
            state["params"], state["opt"], state["residual"], batch)
        losses.append(float(loss))
        if verbose and len(losses) % log_every == 0:
            print(f"step {len(losses)}: loss {losses[-1]:.4f}")
    dt = time.perf_counter() - t0
    n = len(losses)
    tput = samples_per_batch * n / dt if dt > 0 else 0.0
    return TrainResult(steps_run=n, final_step=n, losses=losses,
                       throughput=tput)
