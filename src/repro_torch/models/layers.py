"""Core layer primitives (port of ``repro/models/layers.py``): norms, rotary
embeddings, MLPs, the embedding and the LM head.

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

def embed_tokens(emb, tokens):
    return emb[tokens]


def lm_logits(cfg: ArchConfig, params, h):
    """All ``padded_vocab`` columns, as the JAX head returns them."""
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]
