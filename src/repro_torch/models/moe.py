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
per-expert load counts.

Training runs the plain route (``router_topk`` then ``ref.moe_dispatch``):
the CUDA router and route kernels refuse autograd, as the JAX package has
no backward for its Pallas router.  Autograd reaches the router through
the kept gates in ``combine`` and through ``probs`` in the load-balance
loss, as ``jax.grad`` does through ``lax.top_k`` and the softmax; the
places, the capacity mask and the one-hots carry no gradient in either.

Under the hybrid train step (``tp``, the plan's
:class:`~repro_torch.core.sharding.TPHooks`) the experts lie over
``model`` (expert parallelism), as GSPMD lays out the JAX step's
``expert_stack``: every ``model`` rank routes all of its dp shard's tokens
with the replicated router, keeps its ``E / tp`` experts' slice of
dispatch and combine, runs those experts and sums its partial output over
``model`` in float32.  The aux losses are the global (micro-)batch's, as
JAX's means over every group of the dp axes make them.
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


class _BmmF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=torch.float32)`` on 16-bit CUDA operands,
    with the backward that overload lacks: the float32 cotangent rounded
    to the operands' dtype, then a plain ``bmm`` with the other operand
    in that dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = torch.bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] \
            else None
        gb = torch.bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] \
            else None
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` with a float32 result from operands in their own
    dtype: JAX's ``preferred_element_type=jnp.float32``.  On CUDA one cuBLAS
    call writes float32 (:class:`_BmmF32`); the CPU has no such kernel, so
    there the operands are upcast one batch entry (one expert) at a time: a
    stacked 16-bit expert leaf is never copied to float32 whole."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _BmmF32.apply(a, b)
    return torch.stack([x.float() @ y.float() for x, y in zip(a, b)])


def moe_ffn(cfg: ArchConfig, params: Dict, x: torch.Tensor, *,
            capacity_factor: float = 1.25, group_size: int = 1024,
            use_kernel: bool = False, live=None, tp=None):
    """x: (B, S, d) -> (out, aux) where aux has losses + expert loads.

    ``use_kernel``: the routing through one ``moe_route`` kernel launch,
    from the router logits to the dispatch and combine tensors (its plain
    version on the CPU).

    ``live`` (optional (B, S) 0/1 mask -- serving prefill): masked-out
    positions are dropped from routing entirely -- they occupy no expert
    capacity (pad garbage can never evict a real token from its expert),
    contribute nothing to dispatch/combine or ``expert_load``, and get
    zero FFN output.

    ``tp`` (the hybrid step's hooks): ``x`` is this rank's residual stream
    (under SP a sequence shard) and enters through ``tp.enter``; the
    output leaves through ``tp.exit`` (summed over ``model``).  ``params``
    hold this rank's experts (and, under the FSDP-expert rule, its
    ``d_ff`` shard of each, gathered here at use).  The aux values are
    this rank's shares of the global batch's: ``frac_tokens`` is the mean
    over the batch axes, the probs and the z-loss are summed over this
    rank's tokens and divided by the global token count (``tp.mean``), so
    that their sums over the dp axes are JAX's values and gradients; the
    losses' gradients are counted once over ``model`` (``tp.once``)."""
    if tp is not None:
        x = tp.enter(x)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    G = min(group_size, S)
    if S % G:
        G = math.gcd(G, S)
    g = B * (S // G)
    C = _capacity(G, k, E, capacity_factor)
    xg = x.reshape(g, G, d)

    router = params["router"] if tp is None else tp.copy(params["router"])
    logits = xg.float() @ router                                 # (g, G, E)
    dt = x.dtype
    live_g = None if live is None else live.reshape(g, G)
    if use_kernel:
        # one kernel: routing, queue places, dispatch/combine, loads
        from repro_torch.kernels import ops
        route = ops.moe_route(logits, k, C, live_g, dt)
    else:
        route = ref.moe_dispatch(*router_topk(logits, k), C, live_g, dt)
    dispatch, combine = route.dispatch, route.combine
    w = {name: v for name, v in params.items() if name != "router"}
    n_e = E
    if tp is not None:
        if tp.experts is not None:          # EP: this rank's experts only
            lo, hi = tp.experts
            dispatch, combine = dispatch[:, :, lo:hi], combine[:, :, lo:hi]
            n_e = hi - lo
        # (E, d, f) and wo (E, f, d): d_ff gathered under FSDP experts
        w = {name: tp.expert_weight(v, 1 if name == "wo" else 2)
             for name, v in w.items()}
    # expert-major (E, g*C, d): one batch entry per expert for the bmms
    expert_in = torch.einsum("gtec,gtd->egcd", dispatch, xg).reshape(
        n_e, g * C, d)
    act = layers.activation(cfg.act)
    if cfg.mlp_gated:
        h = act(_bmm_f32(expert_in, w["wi_gate"])) \
            * _bmm_f32(expert_in, w["wi_up"])
    else:
        h = act(_bmm_f32(expert_in, w["wi"]))
    expert_out = torch.bmm(h.to(dt), w["wo"])                    # (E,gC,d)
    expert_out = expert_out.reshape(n_e, g, C, d).transpose(0, 1).reshape(
        g, n_e * C, d)
    out = _bmm_f32(combine.reshape(g, G, n_e * C), expert_out)   # (g,G,d)

    # aux statistics (Switch LB loss over all tokens)
    if tp is None:
        mean_prob = torch.mean(route.probs, dim=(0, 1))
        lb_loss = E * torch.sum(route.top1 * mean_prob)
        z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
        aux = {"lb_loss": lb_loss, "z_loss": z_loss,
               "expert_load": route.load}
        return out.to(dt).reshape(B, S, d), aux
    n = logits.new_tensor(float(g * G))
    mean_prob = tp.mean(torch.sum(route.probs, dim=(0, 1)), n)
    lb_loss = E * torch.sum(tp.batch_mean(route.top1) * mean_prob)
    z_loss = tp.mean(torch.sum(torch.square(torch.logsumexp(logits, -1))), n)
    aux = {"lb_loss": tp.once(lb_loss), "z_loss": tp.once(z_loss),
           "expert_load": route.load / tp.rep}
    # the partial sums over this rank's experts, summed over model in f32
    return tp.exit(out.reshape(B, S, d)).to(dt), aux
