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
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config import TrainConfig
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


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _leaf_update(p32, g, m, v, lr, bc1, bc2, tc: TrainConfig, hyper=None):
    """One leaf's (p', m', v'); through the fused kernel when ``hyper``
    (its (8,) operand) is given and the leaf's size is a multiple of
    1024."""
    g = g.to(torch.float32)
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


def adamw_apply(params, grads, opt: Dict[str, Any], lr, tc: TrainConfig,
                use_kernel: bool = False) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step.  Returns (new params in each param's dtype, new
    state).  ``lr`` is a float or a 0-d f32 tensor."""
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
    hyper = (fused_adamw.hyper(lr, bc1, bc2, b1=tc.b1, b2=tc.b2, eps=tc.eps,
                               wd=tc.weight_decay, device=t.device)
             if use_kernel else None)
    upd = tree_map(lambda p32, g, m0, v0: _leaf_update(p32, g, m0, v0, lr,
                                                       bc1, bc2, tc, hyper),
                   opt["master"], grads, opt["m"], opt["v"])
    # upd holds a (p, m, v) tuple at each leaf; tuples are leaves
    master, m, v = (tree_map(lambda u, i=i: u[i], upd) for i in range(3))
    new_params = tree_map(lambda mp, p: mp.to(p.dtype), master, params)
    return new_params, {"m": m, "v": v, "master": master, "step": step}
