"""AdamW with an f32 master copy (port of ``repro/optimizer/adamw.py``).

Parameters, gradients and the state are nested dicts of tensors keyed like
the JAX pytree.  :func:`adamw_apply` is functional, as in the JAX package:
it returns new parameters (in each parameter's own dtype, so bf16 weights
keep an f32 master) and a new state, and changes none of its inputs.

``use_kernel=True`` routes each leaf whose size is a multiple of 1024 (the
JAX package's rule) through the fused AdamW kernel
(``kernels/fused_adamw.py``), with the step's hyperparameters built once
on the device; the other leaves take the elementwise update.  The kernel
takes any such leaf, also those whose shape the TPU kernel's tiling
asserts on (ROADMAP.md, section 3).

ZeRO (the hybrid step, ``runtime/trainer.py``): :func:`zero_grads`
reduce-scatters each gradient over the dp axes onto its optimizer-state
shard (JAX's ZeRO-2 sharding constraint), :func:`sharded_global_norm`
takes the whole model's norm from every rank's shards, :func:`adamw_apply`
updates the shards elementwise and in place (``donate``), and
:func:`zero_params` all-gathers the new parameters back over the dp axes.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.core import hierarchical as hier
from repro_torch.kernels import fused_adamw
from repro_torch.tree import tree_leaves, tree_map


def init_opt_state(params) -> Dict[str, Any]:
    """m, v (zeros) and an f32 master copy shaped like params, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            # a copy even for f32 params: the master never aliases them
            "master": tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def sharded_global_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of a tree of shards, each laid out by its spec:
    the squares are summed over each leaf's shard, then over the ranks of
    the axes that shard it (one all-reduce per set of axes), so a leaf
    replicated over an axis counts once."""
    parts: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, spec in zip(tree_leaves(grads), tree_leaves(specs)):
        axes = tuple(a for a in mesh.axis_names
                     if any(a == e or (isinstance(e, tuple) and a in e)
                            for e in spec))
        sq = torch.sum(torch.square(g.to(torch.float32)))
        parts[axes] = parts[axes] + sq if axes in parts else sq
    total = sum(hier.all_reduce_sum(sq, mesh, axes) if axes else sq
                for axes, sq in parts.items())
    return torch.sqrt(total)


def zero_grads(grads, zdims, mesh, dp_axes: Sequence[str], pspecs):
    """ZeRO-2: each gradient summed over the dp axes, of which this rank
    keeps the slice of its ``zdims`` dim (the dim ZeRO-1 shards over the dp
    axes); a leaf with no such dim (``None``) is all-reduced whole, over
    the dp axes its param spec ``pspecs`` does not shard it over: where it
    does, its shards are disjoint and its gradient already holds every
    rank's batch (a column-sharded embedding table, whose lookup's
    all-to-all backward brought it)."""
    def one(g, dim, spec):
        if dim is not None:
            return hier.reduce_scatter_dim(g, mesh, dp_axes, dim)
        used = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        axes = tuple(a for a in dp_axes if a not in used)
        return hier.all_reduce_sum(g, mesh, axes) if axes else g
    if mesh.size(dp_axes) == 1:
        return grads
    return tree_map(one, grads, zdims, pspecs)


def zero_params(shards, zdims, mesh, dp_axes: Sequence[str], out):
    """The inverse of the ZeRO cut, in place: each of ``out``'s leaves
    made whole from its updated block ``shards`` (a view of it), by an
    all-gather over the dp axes on its ``zdims`` dim, one leaf at a
    time."""
    if mesh.size(dp_axes) > 1:
        tree_map(lambda o, x, d: d is None or o.copy_(
            hier.gather_dim(x, mesh, dp_axes, d)), out, shards, zdims)
    return out


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _leaf_update(p32, g, m, v, lr, bc1, bc2, tc: TrainConfig, hyper=None,
                 scale=None):
    """One leaf's (p', m', v'); through the fused kernel when ``hyper``
    (its (8,) operand) is given and the leaf's size is a multiple of
    1024.  ``scale`` multiplies the float32 gradient (the clip)."""
    g = g.to(torch.float32)
    if scale is not None:
        g = g * scale
    if hyper is not None and p32.numel() % (8 * 128) == 0:
        out = fused_adamw.adamw_update(
            *(x.contiguous().view(-1) for x in (p32, g, m, v)), hyper)
        return tuple(x.view(p32.shape) for x in out)
    m1 = tc.b1 * m + (1 - tc.b1) * g
    v1 = tc.b2 * v + (1 - tc.b2) * torch.square(g)
    mh = m1 / bc1
    vh = v1 / bc2
    p1 = p32 - lr * (mh / (torch.sqrt(vh) + tc.eps) + tc.weight_decay * p32)
    return p1, m1, v1


DONATE_CHUNK = 1 << 24          # elements an in-place update takes at a time


def _update_in_place(p, p32, g, m, v, lr, bc1, bc2, tc: TrainConfig,
                     scale=None):
    """:func:`_leaf_update`'s arithmetic written into ``p32``, ``m``,
    ``v`` (contiguous) and then ``p`` (in its dtype), a chunk of at most
    ``DONATE_CHUNK`` elements at a time, so its temporaries are bounded by
    a chunk, not a leaf.  The same operations, so the same values."""
    p32f, mf, vf = (x.view(-1) for x in (p32, m, v))
    gf = g.reshape(-1)
    for s in range(0, p32f.numel(), DONATE_CHUNK):
        sl = slice(s, s + DONATE_CHUNK)
        gc = gf[sl].to(torch.float32)
        if scale is not None:
            gc = gc * scale
        pc, mc, vc = p32f[sl], mf[sl], vf[sl]
        mc.mul_(tc.b1).add_((1 - tc.b1) * gc)
        vc.mul_(tc.b2).add_((1 - tc.b2) * torch.square(gc))
        pc.sub_(lr * ((mc / bc1) / (torch.sqrt(vc / bc2) + tc.eps)
                      + tc.weight_decay * pc))
    p.copy_(p32)


def adamw_apply(params, grads, opt: Dict[str, Any], lr, tc: TrainConfig,
                use_kernel: bool = False, donate: bool = False,
                grad_scale=None) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step.  Returns (new params in each param's dtype, new
    state).  ``lr`` is a float or a 0-d f32 tensor.  ``grad_scale`` (a 0-d
    f32 tensor, e.g. a clip computed elsewhere) multiplies each float32
    gradient.  ``donate`` (the elementwise update): ``params`` and
    ``opt``'s m, v and master are updated in place and returned, as a jit
    whose arguments are donated reuses their buffers, with temporaries of
    a chunk (:func:`_update_in_place`)."""
    step = opt["step"] + 1
    t = step.to(torch.float32)
    # the bias corrections in f32, as JAX computes b ** step.astype(f32)
    # (filled on the device: a host-made tensor would wait for the queue)
    bc1 = 1.0 - torch.pow(torch.full((), tc.b1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.full((), tc.b2, dtype=torch.float32,
                                     device=t.device), t)
    if tc.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, tc.grad_clip)
    if donate:
        if use_kernel:
            raise ValueError("donate updates elementwise, not through the "
                             "fused kernel")
        tree_map(lambda p, p32, g, m0, v0: _update_in_place(
            p, p32, g, m0, v0, lr, bc1, bc2, tc, grad_scale),
            params, opt["master"], grads, opt["m"], opt["v"])
        return params, {**opt, "step": step}
    hyper = (fused_adamw.hyper(lr, bc1, bc2, b1=tc.b1, b2=tc.b2, eps=tc.eps,
                               wd=tc.weight_decay, device=t.device)
             if use_kernel else None)
    upd = tree_map(lambda p32, g, m0, v0: _leaf_update(
        p32, g, m0, v0, lr, bc1, bc2, tc, hyper, grad_scale),
        opt["master"], grads, opt["m"], opt["v"])
    # upd holds a (p, m, v) tuple at each leaf; tuples are leaves
    master, m, v = (tree_map(lambda u, i=i: u[i], upd) for i in range(3))
    new_params = tree_map(lambda mp, p: mp.to(p.dtype), master, params)
    return new_params, {"m": m, "v": v, "master": master, "step": step}
