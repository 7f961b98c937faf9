"""Core layer primitives (port of ``repro/models/layers.py``): norms, rotary
embeddings, MLPs, the embedding and the LM head, and the cross-entropy
loss with the JAX package's custom backward passes (embedding, NLL).

Functions on tensors over a plain parameter dict keyed like the JAX pytree;
weights are stored ``(in, out)`` and used as ``x @ W``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ArchConfig, d: Optional[int] = None, device=None):
    d = d or cfg.d_model
    if cfg.norm_type == "rmsnorm":                       # gemma-style (1+scale)
        return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "nonparam_ln":
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(cfg: ArchConfig, params, x, eps: float = 1e-6):
    """Computed in float32 and cast back to x's dtype."""
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if cfg.norm_type == "layernorm":
            y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


def rms_norm_simple(x, scale, eps: float = 1e-6):
    """Standalone RMSNorm used for qk-norm (scale is multiplicative 1+s)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half, not interleaved)
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)                     # (D/2,)
    angles = positions[..., :, None, None].float() * freqs      # (...,S,1,D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def position_embedding(cfg: ArchConfig, x, positions):
    if cfg.pos_type == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.pos_type == "none":
        return x
    raise NotImplementedError(
        f"pos_type {cfg.pos_type!r} is not ported yet (ROADMAP.md)")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def apply_mlp(cfg: ArchConfig, params, x):
    act = activation(cfg.act)
    if cfg.mlp_gated:
        h = act(x @ params["wi_gate"]) * (x @ params["wi_up"])
    else:
        h = act(x @ params["wi"])
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding and LM head
# ---------------------------------------------------------------------------

class _EmbedLookup(torch.autograd.Function):
    """``emb[tokens]`` whose backward is the JAX package's: a sum of the
    output gradient over the tokens of each row, accumulated in float32 and
    cast to the table's dtype.  JAX writes it as a one-hot einsum;
    ``index_add_`` computes the same sum in another order."""

    @staticmethod
    def forward(ctx, emb, tokens):
        ctx.save_for_backward(tokens)
        ctx.table = (emb.shape[0], emb.dtype)
        return emb[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        rows, dtype = ctx.table
        d = torch.zeros((rows, g.shape[-1]), dtype=torch.float32,
                        device=g.device)
        d.index_add_(0, tokens.reshape(-1), g.reshape(-1, g.shape[-1]).float())
        return d.to(dtype), None


def embed_tokens(emb, tokens):
    return _EmbedLookup.apply(emb, tokens)


def lm_logits(cfg: ArchConfig, params, h):
    """All ``padded_vocab`` columns, as the JAX head returns them."""
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------

def _lse32(logits):
    """logsumexp with float32 accumulation (the max is a constant)."""
    m = torch.amax(logits, dim=-1).detach().float()
    s = torch.sum(torch.exp(logits.float() - m[..., None]), dim=-1)
    return m + torch.log(s)


class _NLL(torch.autograd.Function):
    """Per-position negative log-likelihood with the JAX package's lean
    backward: only (logits, targets, lse) are saved, and the gradient is
    ``g * (softmax - onehot)`` in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, targets):
        lse = _lse32(logits)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        ctx.save_for_backward(logits, targets, lse)
        return lse - gold.float()

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        d = torch.exp(logits.float() - lse[..., None])        # softmax
        d.scatter_add_(-1, targets[..., None].long(),
                       torch.full(targets.shape + (1,), -1.0, device=d.device))
        return (g[..., None] * d).to(logits.dtype), None


def _nll(logits, targets):
    return _NLL.apply(logits, targets)


def cross_entropy_loss(logits, targets, mask=None, tp=None):
    """Next-token CE over (..., V_padded) logits; ``mask`` zeroes padded
    positions.  Padded vocab columns are never targets.  ``tp`` (a
    :class:`repro_torch.core.sharding.TPHooks`): the logits are this
    rank's vocab shard, and the mean is over the global batch."""
    if tp is None:
        nll = _nll(logits, targets)
        if mask is None:
            return torch.mean(nll)
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    nll = tp.nll(logits, targets)
    if mask is None:
        return tp.mean(torch.sum(nll), torch.tensor(
            float(nll.numel()), device=nll.device))
    mask = mask.float()
    return tp.mean(torch.sum(nll * mask), torch.sum(mask))
