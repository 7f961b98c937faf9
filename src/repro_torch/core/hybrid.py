"""The decode-step FLOP model of ``repro/core/hybrid.py`` (a copy of its
``decode_model_flops``), which the serving engine's traced ``decode_step``
spans carry.

The rest of that module, the hybrid-parallelism planner over a TPU mesh,
is not ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

from repro_torch.config import ArchConfig


def decode_model_flops(cfg: ArchConfig, cache_len: int, batch: int) -> float:
    """One serve_step: 2*N_active per token + attention over the cache.

    No encoder (whisper's runs once at prefill, not per decode step); the
    dominant attention cost is q . K_cache over ``cache_len`` positions."""
    f = 2.0 * cfg.active_params()
    for kind in cfg.layer_kinds():
        if kind == "attn":
            f += 2 * cache_len * cfg.q_dim * 2
        elif kind == "local_attn":
            f += 2 * min(cache_len, cfg.sliding_window or cache_len) \
                * cfg.q_dim * 2
    if cfg.encoder_layers:
        # encoder weights are not touched per decode step; cross-attention
        # reads the precomputed enc K/V cache instead
        f -= 2.0 * cfg.encoder_layers * cfg._layer_params("attn")
        f += cfg.num_layers * 2 * cfg.encoder_frames * cfg.q_dim * 2
    return f * batch
