"""Mixture-of-Experts FFN with top-k routing and capacity dispatch (port of
``repro/models/moe.py``, paper section III.A.c).

Dispatch is the JAX package's group-wise one-hot einsum formulation
(Mesh-TF / Switch lineage): tokens are split into (batch x seq-subchunk)
groups of ``G = gcd(group_size, S)``; each (token, slot) takes a place in
its expert's queue by a slot-major cumsum, and places past the capacity C
are dropped.  The one-hot ``dispatch`` / ``combine`` tensors keep the
reference's order of sums, so the port's outputs follow JAX's.  With
``use_kernel`` on the card, one CUDA kernel (``ops.moe_route``) computes
the whole route, from the router logits to dispatch, combine and the
loads; its plain version (``kernels/ref.moe_route``) is the reference's
code, and dispatch and combine are exact, so both give the same bits.  The
expert products are plain batched matrix products (``torch.bmm``), as the
JAX package leaves them to XLA, one batch entry per expert.  Where JAX asks
for a float32 result (``preferred_element_type``: the gate and up products
and the final combine) the port takes one too and rounds to the model
dtype where JAX does: after the activation, and after the combine.

Aux outputs: the Switch load-balance loss, the router z-loss and the
per-expert load counts.  The serving path is ported; MoE training with
``core/load_balance.rebalance_experts`` comes later (``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels import ref
from repro_torch.models import layers


def router_topk(logits: torch.Tensor, k: int, use_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., E) logits -> (gates (..., k), idx (..., k), probs (..., E)).

    ``use_kernel`` routes through :func:`repro_torch.kernels.ops.moe_router`
    (the CUDA kernel on the card, its plain version on the CPU).  Otherwise
    a stable descending sort gives ``lax.top_k``'s order: equal probs keep
    the lower expert index first (``torch.topk`` promises no tie order on
    CUDA)."""
    if use_kernel:
        from repro_torch.kernels import ops
        shp = logits.shape
        g2, i2, p2 = ops.moe_router(logits.reshape(-1, shp[-1]), k)
        return (g2.reshape(shp[:-1] + (k,)), i2.reshape(shp[:-1] + (k,)),
                p2.reshape(shp))
    probs = torch.softmax(logits.float(), dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], order[..., :k]
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _capacity(group: int, k: int, E: int, factor: float) -> int:
    c = int(group * k / E * factor)
    return max(8, -(-c // 8) * 8)   # round up to 8


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` with a float32 result from operands in their own
    dtype: JAX's ``preferred_element_type=jnp.float32``.  On CUDA one cuBLAS
    call writes float32; the CPU has no such kernel, so there the operands
    are upcast one batch entry (one expert) at a time: a stacked 16-bit
    expert leaf is never copied to float32 whole."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.stack([x.float() @ y.float() for x, y in zip(a, b)])


def moe_ffn(cfg: ArchConfig, params: Dict, x: torch.Tensor, *,
            capacity_factor: float = 1.25, group_size: int = 1024,
            use_kernel: bool = False, live=None):
    """x: (B, S, d) -> (out, aux) where aux has losses + expert loads.

    ``use_kernel``: the routing through one ``moe_route`` kernel launch,
    from the router logits to the dispatch and combine tensors (its plain
    version on the CPU).

    ``live`` (optional (B, S) 0/1 mask -- serving prefill): masked-out
    positions are dropped from routing entirely -- they occupy no expert
    capacity (pad garbage can never evict a real token from its expert),
    contribute nothing to dispatch/combine or ``expert_load``, and get
    zero FFN output."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    G = min(group_size, S)
    if S % G:
        G = math.gcd(G, S)
    g = B * (S // G)
    C = _capacity(G, k, E, capacity_factor)
    xg = x.reshape(g, G, d)

    logits = xg.float() @ params["router"]                       # (g, G, E)
    dt = x.dtype
    live_g = None if live is None else live.reshape(g, G)
    if use_kernel:
        # one kernel: routing, queue places, dispatch/combine, loads
        from repro_torch.kernels import ops
        route = ops.moe_route(logits, k, C, live_g, dt)
    else:
        route = ref.moe_dispatch(*router_topk(logits, k), C, live_g, dt)
    dispatch, combine = route.dispatch, route.combine
    # expert-major (E, g*C, d): one batch entry per expert for the bmms
    expert_in = torch.einsum("gtec,gtd->egcd", dispatch, xg).reshape(
        E, g * C, d)
    act = layers.activation(cfg.act)
    if cfg.mlp_gated:
        h = act(_bmm_f32(expert_in, params["wi_gate"])) \
            * _bmm_f32(expert_in, params["wi_up"])
    else:
        h = act(_bmm_f32(expert_in, params["wi"]))
    expert_out = torch.bmm(h.to(dt), params["wo"])               # (E,gC,d)
    expert_out = expert_out.reshape(E, g, C, d).transpose(0, 1).reshape(
        g, E * C, d)
    out = _bmm_f32(combine.reshape(g, G, E * C), expert_out)     # (g,G,d)

    # aux statistics (Switch LB loss over all tokens)
    mean_prob = torch.mean(route.probs, dim=(0, 1))
    lb_loss = E * torch.sum(route.top1 * mean_prob)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "expert_load": route.load}
    return out.to(dt).reshape(B, S, d), aux
