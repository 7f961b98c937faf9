"""Pipeline parallelism (paper C2): micro-batched pipelining over the
``stage`` axis of a :class:`~repro_torch.core.hierarchical.DPMesh`, by
point-to-point sends between neighbouring stages (port of
``repro/core/pipeline.py``, whose executor is a ``lax.scan`` inside
``shard_map`` over ``lax.ppermute``).

Two schedules share one stage contract -- ``stage_fn(params_slice, x) ->
y`` with shape-uniform inter-stage activations:

* ``gpipe`` -- every forward first, then every backward; the boundary
  input of each micro-batch is stashed (``n_micro`` slots);
* ``1f1b`` -- PipeDream-flush: a warmed-up stage interleaves one forward
  with one backward, so at most ``n_stages - s`` micro-batches are in
  flight at stage ``s`` (``min(n_stages, n_micro)`` slots).

The tick tables are built on the host (:func:`schedule_tables`, the JAX
package's code) and are the same on every rank, so each rank knows at
each tick which micro-batch its forward and backward units take, what it
sends and what it receives: :func:`make_pipeline_vag_body` posts exactly
those messages, both directions of a tick in one
``dist.batch_isend_irecv``, into ring slots ``m % depth`` whose
no-overwrite rule :func:`_validate_schedule` checks.  An idle tick
computes nothing (JAX computes it and masks the result, which changes no
number).  The forward unit runs ``stage_fn`` without autograd; the
backward unit recomputes the stage from the stashed input with autograd,
as JAX's ``jax.vjp`` does on every backward tick under both schedules.

Stage balancing is upstream: :mod:`repro_torch.core.load_balance`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import hierarchical as hier
from repro_torch.core.hierarchical import DPMesh
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

SCHEDULES = ("gpipe", "1f1b")


# ---------------------------------------------------------------------------
# Micro-batching
# ---------------------------------------------------------------------------

def microbatch(x: torch.Tensor, n_micro: int, pad: bool = False
               ) -> torch.Tensor:
    """(B, ...) -> (n_micro, ceil(B/n_micro), ...).

    ``pad=True`` right-pads a remainder batch with zero rows (callers mask
    the pad rows out of the loss -- see ``pad_batch``); otherwise B must
    divide evenly.
    """
    B = x.shape[0]
    if B % n_micro:
        if not pad:
            raise ValueError(
                f"batch {B} does not divide into {n_micro} micro-batches; "
                f"pass pad=True (and mask the pad rows) or pick a divisor")
        x = pad_batch(x, n_micro)
        B = x.shape[0]
    return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))


def pad_batch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """Zero-pad dim 0 up to the next multiple of ``n_micro``."""
    r = (-x.shape[0]) % n_micro
    if r == 0:
        return x
    return torch.cat([x, x.new_zeros((r,) + tuple(x.shape[1:]))], dim=0)


# ---------------------------------------------------------------------------
# Schedules (host side, the JAX package's code)
# ---------------------------------------------------------------------------

def schedule_tables(schedule: str, n_stages: int, n_micro: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-built tick tables for either schedule.

    Returns (fwd, bwd, depth): fwd/bwd are (T, n_stages) int32 -- the
    micro-batch index the stage's forward/backward unit processes that
    tick (-1 = idle) -- and ``depth`` is the activation-stash ring size the
    schedule needs (``min(n_stages, n_micro)`` for 1F1B, ``n_micro`` for
    GPipe: the memory difference that motivates 1F1B).

    One compute unit per stage per tick.  Under ``1f1b`` a stage prefers a
    ready backward (the PipeDream-flush rule) and may only start forward
    ``m`` while fewer than ``n_stages - s`` micro-batches are in flight;
    under ``gpipe`` forwards run unthrottled and backwards drain after.
    """
    S, M = n_stages, n_micro
    one_f_one_b = schedule == "1f1b"
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} (have {SCHEDULES})")
    f_t = np.full((S, M), -1, np.int64)
    b_t = np.full((S, M), -1, np.int64)
    nf = [0] * S
    nb = [0] * S
    t = 0
    while min(nb) < M:
        for s in range(S):
            m = nb[s]
            can_b = (m < M and 0 <= f_t[s, m] < t
                     and (s == S - 1 or 0 <= b_t[s + 1, m] < t))
            mf = nf[s]
            cap = (S - s) if one_f_one_b else M
            can_f = (mf < M
                     and (s == 0 or 0 <= f_t[s - 1, mf] < t)
                     and nf[s] - nb[s] < cap)
            if can_b and (one_f_one_b or not can_f):
                b_t[s, m] = t
                nb[s] += 1
            elif can_f:
                f_t[s, mf] = t
                nf[s] += 1
        t += 1
        if t > 4 * (M + S) + 8:
            raise RuntimeError(
                f"{schedule} schedule did not converge ({S=}, {M=})")
    T = t
    fwd = np.full((T, S), -1, np.int32)
    bwd = np.full((T, S), -1, np.int32)
    for s in range(S):
        for m in range(M):
            fwd[f_t[s, m], s] = m
            bwd[b_t[s, m], s] = m
    depth = min(S, M) if one_f_one_b else M
    _validate_schedule(f_t, b_t, S, M, depth)
    return fwd, bwd, depth


def _validate_schedule(f_t: np.ndarray, b_t: np.ndarray, S: int, M: int,
                       D: int) -> None:
    """No-overwrite invariants for the depth-D ring buffers.

    Slot ``m % D`` of each per-stage buffer must not be rewritten by micro
    ``m + D`` before micro ``m`` is consumed.  These follow from the
    schedule's in-flight bound; re-checked here (as real raises, immune to
    ``python -O``) so a schedule bug fails loudly at build time instead of
    as silent gradient corruption.
    """

    def need(ok, what, s, m):
        if not ok:
            raise ValueError(
                f"invalid schedule: {what} violated at stage {s}, "
                f"micro {m} (S={S}, M={M}, depth={D})")

    for s in range(S):
        for m in range(M - D):
            # input stash: fwd m+D writes the slot bwd m reads
            need(f_t[s, m + D] > b_t[s, m], "stash reuse", s, m)
            if s >= 1:      # fwd inbox: arrival of m+D vs consumption of m
                need(f_t[s - 1, m + D] + 1 > f_t[s, m], "fwd inbox", s, m)
            if s <= S - 2:  # bwd inbox
                need(b_t[s + 1, m + D] + 1 > b_t[s, m], "bwd inbox", s, m)
    # dependency sanity
    for s in range(S):
        for m in range(M):
            need(b_t[s, m] > f_t[s, m] >= 0, "fwd-before-bwd", s, m)
            if s >= 1:
                need(f_t[s, m] > f_t[s - 1, m], "fwd dependency", s, m)
            if s <= S - 2:
                need(b_t[s, m] > b_t[s + 1, m], "bwd dependency", s, m)


def schedule_cost(schedule: str, n_stages: int, n_micro: int,
                  t_fwd: float = 1.0, t_bwd: float = 2.0) -> Dict[str, float]:
    """Per-step schedule cost model (the bubble column of the
    ``train-parallel`` benchmark).

    ``gpipe`` runs a full forward phase then a full backward phase and
    rematerializes each stage's forward inside the backward phase (the
    backward tick costs ``t_fwd + t_bwd``); ``1f1b`` keeps at most
    ``n_stages`` boundary inputs stashed and need not recompute.  Bubble
    fraction is 1 - useful/span; 1F1B's is strictly below GPipe's for
    n_stages > 1.

    The executor (:func:`make_pipeline_vag_body`) recomputes the stage
    forward on every backward tick under BOTH schedules, so measured step
    times do not show this model's gpipe-vs-1f1b compute gap: there the
    schedules differ in stash depth and tick count only.
    """
    S, M = n_stages, n_micro
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} (have {SCHEDULES})")
    useful = M * (t_fwd + t_bwd)
    if schedule == "gpipe":
        span = (M + S - 1) * t_fwd + (M + S - 1) * (t_fwd + t_bwd)
        stash = M
    else:
        span = (M + S - 1) * (t_fwd + t_bwd)
        stash = min(S, M)
    return {"schedule": schedule, "n_stages": S, "n_micro": M,
            "span": span, "useful": useful,
            "bubble_frac": 1.0 - useful / span,
            "stash_micros": stash}


# ---------------------------------------------------------------------------
# The executor: pipelined value-and-grad (both schedules, one signature)
# ---------------------------------------------------------------------------
#
# Contract shared by every constructor below:
#   stage_fn(stage_params_slice, x) -> y           shape-uniform activations
#   last_fn(last_params, y, tgt, mask) -> loss_sum masked NLL *sum* (the
#       pipeline divides by the global mask weight, so remainder-padded
#       micro-batches weight correctly)
#   vag(stage_params, last_params, x_micro, tgt_micro, mask_micro)
#     -> (loss, (g_stage, g_last, g_x))
# with g_x the cotangent of x_micro -- the hook the trainer uses to reach
# the (replicated) token-embedding parameters that produced x.  Stage
# params are this rank's stage: every leaf carries a leading dim of 1.


def _local(stage_params):
    return tree_map(lambda a: a[0], stage_params)


def _accumulating(tree, acc, W, stacked: bool = False):
    """Autograd leaves over ``tree``'s storage, each of which adds its
    float32 gradient divided by ``W`` to its slice of ``acc`` as soon as
    a backward has it, and drops it.  A stacked (L, ...) leaf under
    ``blocks`` becomes a list of one leaf a layer (the stage's layer loop
    indexes it as it indexes the stacked tensor), so no layer's gradient
    is padded to the whole stack.  ``mask`` (the pad mask, layout and not
    a parameter) is passed through."""
    if isinstance(tree, dict):
        return {k: tree[k] if k == "mask" else _accumulating(
            tree[k], acc[k], W, stacked or k == "blocks") for k in tree}

    def leaf(x, buf):
        t = x.detach().requires_grad_()

        def take(t):
            buf.add_(t.grad.to(torch.float32) / W)
            t.grad = None
        t.register_post_accumulate_grad_hook(take)
        return t
    if stacked:
        return [leaf(x, b) for x, b in zip(tree.unbind(0), acc.unbind(0))]
    return leaf(tree, acc)


def _f32_zeros(tree):
    return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                          device=a.device), tree)


def _param_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) if k != "mask"
                for t in _param_leaves(tree[k])]
    return list(tree) if isinstance(tree, list) else [tree]


def make_pipeline_vag_body(stage_fn: Callable, last_fn: Callable,
                           n_stages: int, n_micro: int,
                           schedule: str = "1f1b",
                           stage_axis: str = "stage", *, mesh: DPMesh):
    """This rank's pipelined value-and-grad: the schedule executor, for
    use inside a larger step (the trainer's DP x TP x stage step) or
    through :func:`make_pipeline_value_and_grad`.

    Each tick of :func:`schedule_tables` a stage runs at most one forward
    (no autograd; its boundary input stashed in a ring of ``depth``
    slots) and one backward (the stage recomputed from the stashed input
    with autograd, seeded by the cotangent in its inbox; the last stage
    folds ``last_fn`` in, seeds with 1 and adds the micro-batch's loss).
    Gradients accumulate in float32 divided by the global mask weight
    ``W``.  Activations go down the ``stage`` axis and cotangents up it,
    by point-to-point sends posted only where the tables put a message.

    body(stage_params, last_params, x_micro, tgt_micro, mask_micro) ->
    (loss, g_stage, g_last, g_x): ``g_stage`` is this stage's (leading
    dim 1, ``mask`` zeros); loss, ``g_last`` and ``g_x`` are summed over
    the stage axis, where each lives on one stage, as JAX's ``psum``
    replicates them.
    """
    S, M = n_stages, n_micro
    if mesh.shape.get(stage_axis, 1) != S:
        raise ValueError(f"{S} stages on a mesh whose {stage_axis!r} axis "
                         f"is {mesh.shape.get(stage_axis, 1)}")
    fwd_np, bwd_np, depth = schedule_tables(schedule, S, M)
    sid = mesh.coords.get(stage_axis, 0)
    is_last, is_first = sid == S - 1, sid == 0
    down = hier.neighbour(mesh, stage_axis, +1) if not is_last else None
    up = hier.neighbour(mesh, stage_axis, -1) if not is_first else None
    # each tick: the micro-batches this rank's forward and backward units
    # take, and those of the activation and cotangent it receives (-1: none)
    plan = []
    for t in range(fwd_np.shape[0]):
        plan.append((int(fwd_np[t, sid]), int(bwd_np[t, sid]),
                     int(fwd_np[t, sid - 1]) if not is_first else -1,
                     int(bwd_np[t, sid + 1]) if not is_last else -1))

    def body(stage_params, last_params, x_micro, tgt_micro, mask_micro):
        p_local = _local(stage_params)
        W = torch.clamp(torch.sum(mask_micro), min=1.0)
        act_shape = (depth,) + tuple(x_micro.shape[1:])
        inbox_f = (x_micro.new_zeros(act_shape) if not is_first else None)
        stash = inbox_f.new_zeros(act_shape) if not is_first else None
        inbox_b = x_micro.new_zeros(act_shape) if not is_last else None
        g_stage = _f32_zeros({k: v for k, v in p_local.items()
                              if k != "mask"})
        g_last = _f32_zeros(last_params)
        g_x = torch.zeros(x_micro.shape, dtype=torch.float32,
                          device=x_micro.device)
        loss = torch.zeros((), dtype=torch.float32, device=x_micro.device)
        p_grad = _accumulating(p_local, g_stage, W)
        lp_grad = (_accumulating(last_params, g_last, W) if is_last
                   else None)
        for m_f, m_b, r_f, r_b in plan:
            ops = []
            # ---- forward unit ------------------------------------------
            if m_f >= 0:
                if is_first:
                    x_in = x_micro[m_f]
                else:
                    x_in = inbox_f[m_f % depth]
                    stash[m_f % depth].copy_(x_in)
                if not is_last:
                    with torch.no_grad():
                        y = stage_fn(p_local, x_in)
                    ops.append(("send", y, down))
            # ---- backward unit -----------------------------------------
            if m_b >= 0:
                x_s = (x_micro[m_b] if is_first else stash[m_b % depth])
                x_s = x_s.detach().requires_grad_()
                inputs = _param_leaves(p_grad) + [x_s]
                if is_last:
                    inputs += _param_leaves(lp_grad)
                    ls = last_fn(lp_grad, stage_fn(p_grad, x_s),
                                 tgt_micro[m_b], mask_micro[m_b])
                    torch.autograd.backward(ls, inputs=inputs)
                    loss = loss + ls.detach().to(torch.float32)
                else:
                    ct = inbox_b[m_b % depth].to(x_s.dtype)
                    torch.autograd.backward(stage_fn(p_grad, x_s), ct,
                                            inputs=inputs)
                gx = x_s.grad
                if is_first:
                    g_x[m_b] = gx.to(torch.float32) / W
                else:
                    ops.append(("send", gx.to(x_micro.dtype), up))
            # ---- messages: what the tables say arrives this tick --------
            if r_f >= 0:
                ops.append(("recv", inbox_f[r_f % depth], up))
            if r_b >= 0:
                ops.append(("recv", inbox_b[r_b % depth], down))
            if ops:
                hier.exchange(ops)
        # the loss, the last params' and the input's gradients live on one
        # stage each: summed over the stage axis (zeros elsewhere)
        if S > 1:
            ax = (stage_axis,)
            loss = hier.all_reduce_sum(loss, mesh, ax)
            g_last = tree_map(lambda g: hier.all_reduce_sum(g, mesh, ax),
                              g_last)
            g_x = hier.all_reduce_sum(g_x, mesh, ax)
        loss = loss / W
        g_stage = tree_map(lambda g: g[None], g_stage)
        if "mask" in stage_params:
            g_stage["mask"] = torch.zeros_like(stage_params["mask"],
                                               dtype=torch.float32)
        return loss, g_stage, g_last, g_x

    return body


def make_pipeline_value_and_grad(stage_fn: Callable, last_fn: Callable,
                                 mesh: DPMesh, n_stages: int, n_micro: int,
                                 schedule: str = "1f1b",
                                 stage_axis: str = "stage"):
    """The executor (:func:`make_pipeline_vag_body`) with JAX's standalone
    signature: vag(...) -> (loss, (g_stage, g_last, g_x))."""
    body = make_pipeline_vag_body(stage_fn, last_fn, n_stages, n_micro,
                                  schedule, stage_axis, mesh=mesh)

    def vag(stage_params, last_params, x_micro, tgt_micro, mask_micro):
        loss, g_stage, g_last, g_x = body(stage_params, last_params,
                                          x_micro, tgt_micro, mask_micro)
        return loss, (g_stage, g_last, g_x)

    return vag


# ---------------------------------------------------------------------------
# GPipe with autograd through the sends: the parity oracle
# ---------------------------------------------------------------------------

class _Send(torch.autograd.Function):
    """Sends ``y`` to ``peer`` (tag ``tag``) and returns an empty tensor
    that carries the dependency; backward receives ``y``'s cotangent from
    ``peer`` (the reverse send)."""

    @staticmethod
    def forward(ctx, y, peer, tag):
        ctx.meta = (y.shape, y.dtype, y.device, peer, tag)
        hier.exchange([("send", y.contiguous(), peer)], tag=tag)
        return y.new_zeros((0,))

    @staticmethod
    def backward(ctx, _g):
        shape, dtype, device, peer, tag = ctx.meta
        ct = torch.empty(shape, dtype=dtype, device=device)
        hier.exchange([("recv", ct, peer)], tag=tag)
        return ct, None, None


class _Recv(torch.autograd.Function):
    """Receives a ``like``-shaped tensor from ``peer`` (tag ``tag``);
    backward sends its cotangent back.  ``anchor`` (a tensor requiring
    grad, e.g. an empty one) puts the receive on the autograd graph."""

    @staticmethod
    def forward(ctx, anchor, like, peer, tag):
        ctx.meta = (peer, tag, anchor.shape)
        out = torch.empty_like(like)
        hier.exchange([("recv", out, peer)], tag=tag)
        return out

    @staticmethod
    def backward(ctx, g):
        peer, tag, shape = ctx.meta
        hier.exchange([("send", g.contiguous(), peer)], tag=tag)
        return g.new_zeros(shape), None, None, None


class _Replicate(torch.autograd.Function):
    """Summed over the stage axis forward (one stage holds the value,
    the others zeros); identity backward: every stage then computes the
    same function of it, and only the holder's graph carries it back."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return hier.all_reduce_sum(x, mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gpipe(stage_fn: Callable, mesh: DPMesh, n_stages: int, n_micro: int,
          stage_axis: str = "stage"):
    """A pipelined apply: (stage_params, x_micro) -> y_micro.

    Stage ``s`` runs micro-batch ``m`` at tick ``s + m`` and sends its
    output to stage ``s + 1`` (autograd through the send: the backward
    sends the cotangent back).  ``x_micro`` (n_micro, mb, ...) is consumed
    by stage 0; the last stage's outputs come back on every stage.
    """
    S, M = n_stages, n_micro
    sid = mesh.coords.get(stage_axis, 0)
    down = hier.neighbour(mesh, stage_axis, +1) if sid < S - 1 else None
    up = hier.neighbour(mesh, stage_axis, -1) if sid > 0 else None

    def pipe(stage_params, x_micro):
        p_local = _local(stage_params)
        anchor = x_micro.new_zeros((0,)).requires_grad_()
        deps, ys = [], []
        for m in range(M):
            inp = (x_micro[m] if sid == 0 else
                   _Recv.apply(anchor, x_micro[m], up, m))
            y = stage_fn(p_local, inp)
            if down is not None:
                deps.append(_Send.apply(y, down, m))
            else:
                ys.append(y)
        ysink = (torch.stack(ys) if ys else torch.zeros_like(x_micro))
        for d in deps:                  # keeps every send on the graph
            ysink = ysink + d.sum()
        return _Replicate.apply(ysink, mesh, stage_axis)

    return pipe


def make_pipeline_loss(stage_fn: Callable, last_fn: Callable, mesh: DPMesh,
                       n_stages: int, n_micro: int,
                       stage_axis: str = "stage"):
    """Pipelined loss: stages run stage_fn through :func:`gpipe`;
    ``last_fn(last_params, y, target)`` maps final activations to each
    micro-batch's scalar loss.  Returns loss_fn(stage_params, last_params,
    x_micro, tgt_micro) -> the mean; differentiable end to end."""
    pipe = gpipe(stage_fn, mesh, n_stages, n_micro, stage_axis)

    def loss(stage_params, last_params, x_micro, tgt_micro):
        y = pipe(stage_params, x_micro)
        per = torch.stack([last_fn(last_params, y[m], tgt_micro[m])
                           for m in range(n_micro)])
        return torch.mean(per)

    return loss


def gpipe_value_and_grad(stage_fn, last_fn, mesh: DPMesh, n_stages: int,
                         n_micro: int, stage_axis: str = "stage"):
    """Autograd reference: value-and-grad straight through :func:`gpipe`'s
    sends, with :func:`make_pipeline_value_and_grad`'s signature -- the
    parity oracle the schedule executor is tested against.  ``g_stage`` is
    this stage's, ``g_last`` the same on every stage, ``g_x`` summed over
    the stage axis."""
    pipe = gpipe(stage_fn, mesh, n_stages, n_micro, stage_axis)

    def vag(stage_params, last_params, x_micro, tgt_micro, mask_micro):
        sp = tree_map(lambda a: a.detach().requires_grad_(), stage_params)
        lp = tree_map(lambda a: a.detach().requires_grad_(), last_params)
        x = x_micro.detach().requires_grad_()
        y = pipe(sp, x)
        sums = torch.stack([last_fn(lp, y[m], tgt_micro[m], mask_micro[m])
                            for m in range(n_micro)])
        W = torch.clamp(torch.sum(mask_micro), min=1.0)
        loss = torch.sum(sums) / W
        wrt = {"stage": sp, "last": lp, "x": x}
        leaves = tree_leaves(wrt)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = tree_unflatten(wrt, [torch.zeros_like(t) if d is None else d
                                 for t, d in zip(leaves, grads)])
        g_x = hier.all_reduce_sum(g["x"], mesh, (stage_axis,))
        return loss.detach(), (g["stage"], g["last"], g_x)

    return vag
