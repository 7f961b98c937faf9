"""Modeled decode-state bytes (the byte models of
``repro/serving/roofline.py`` that the engine reads).

``ServingEngine`` integrates :func:`resident_kv_bytes` over decode steps
into ``summary["kv_bytes_per_step"]``: every slot pinned at ``max_len``
rows for a dense layout, the mapped pool blocks for a paged one.  Bytes
are priced at 2 per element (bf16) whatever the model dtype, and int8 at 1
plus an f32 scale per (position, head), as in the JAX package, so the
summary equals the JAX engine's under every layout.  A traced
``decode_step`` span carries :func:`decode_attn_read_bytes`, the JAX
package's model of the KV bytes one step streams (its ``block_k=128`` is
the TPU kernel's tile, kept so the span args equal the JAX engine's; the
CUDA kernel reads 64-key spans).  :func:`cf_lookup_bytes` is the serving
CF lookup's wire-byte model under each table plan.  The JAX module's
time terms (TPU-model FLOP and bandwidth constants) are not copied: no
speed figure of that chip applies here.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

from repro_torch.config import ArchConfig


def _kv_pos_bytes(head_dim: int, n_kv: int, kv_bits: int) -> float:
    """Bytes per cached (position, k+v) across the kv heads."""
    if kv_bits == 8:
        per_head = head_dim + 4          # int8 values + one f32 scale
    elif kv_bits == 16:
        per_head = 2 * head_dim
    else:
        raise ValueError(f"kv_bits must be 8 or 16, got {kv_bits}")
    return 2 * n_kv * per_head           # k and v


def decode_state_bytes(cfg: ArchConfig, cache_len: int,
                       kv_bits: int = 16) -> float:
    """Resident decode-state bytes for ONE slot at ``cache_len`` positions.
    The port serves attention layers (the uniform family) and rwkv6
    layers; other layer kinds raise until their families are ported."""
    dt = 2                               # model dtype (bf16) itemsize
    kv_pos = _kv_pos_bytes(cfg.head_dim, cfg.num_kv_heads, kv_bits)
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind == "attn":
            total += cache_len * kv_pos
        elif kind == "rwkv6":
            hs = cfg.rwkv_head_size
            total += (cfg.d_model // hs) * hs * hs * 4      # f32 wkv state
            total += 2 * cfg.d_model * dt                   # shift states
        else:
            raise NotImplementedError(
                f"decode-state bytes of {kind!r} layers are not ported yet "
                "(ROADMAP.md)")
    return total


def _paged_split_bytes(cfg: ArchConfig, max_len: int, kv_bits: int):
    """(bytes per pooled KV *position*, per-slot bytes of state that stays
    slot-resident under the paged layout).  Only full-cache self-attention
    rows page (the JAX package keeps window-bounded rings, recurrent rows
    and cross-KV slot-resident; of these the port has rwkv6's rows)."""
    kv_pos = _kv_pos_bytes(cfg.head_dim, cfg.num_kv_heads, kv_bits)
    n_full_attn = sum(1 for kind in cfg.layer_kinds() if kind == "attn")
    paged_pos = n_full_attn * kv_pos
    resident = decode_state_bytes(cfg, max_len, kv_bits) \
        - max_len * paged_pos
    return paged_pos, resident


def resident_kv_bytes(cfg: ArchConfig, n_slots: int, max_len: int,
                      layout, used_blocks: int) -> float:
    """Resident decode-state bytes of a serving batch under ``layout``.

    Dense: every slot pins ``max_len`` KV rows whether live or not.
    Paged: the pooled layers cost only the ``used_blocks`` actually mapped,
    plus the per-slot resident remainder."""
    if not layout.paged:
        return n_slots * decode_state_bytes(cfg, max_len, layout.kv_bits)
    paged_pos, resident = _paged_split_bytes(cfg, max_len, layout.kv_bits)
    return (used_blocks * layout.block_size * paged_pos
            + n_slots * resident)


def decode_attn_read_bytes(cfg: ArchConfig, lengths: Sequence[int],
                           s_max: int, impl: str = "dense",
                           kv_bits: int = 16,
                           block_k: int = 128) -> Dict[str, float]:
    """KV-cache bytes ONE decode step streams through attention, per impl.

    ``lengths`` are the live per-slot prefixes (ragged); ``s_max`` the
    padded cache capacity.  ``impl="dense"`` models the einsum over the
    whole padded cache -- every slot pays ``s_max`` positions per
    attention layer regardless of its length.  ``impl="flash"`` models a
    length-aware flash-decode kernel: a slot streams only its live KV
    blocks, ``max(ceil(len/block_k), 1)`` blocks of ``block_k`` positions.
    Sliding-window layers cap a slot's live positions at the window on
    both paths.  ``kv_bits=8`` prices the int8-fused variant.
    """
    kv_pos = _kv_pos_bytes(cfg.head_dim, cfg.num_kv_heads, kv_bits)
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind == "attn":
            cap = s_max
        elif kind == "local_attn":
            cap = min(cfg.sliding_window or s_max, s_max)
        else:
            continue                     # recurrent layers hold no KV rows
        if impl == "dense":
            total += len(lengths) * cap * kv_pos
        elif impl == "flash":
            for ln in lengths:
                bk = min(block_k, cap)
                n_blocks = max(math.ceil(min(int(ln), cap) / bk), 1)
                total += min(n_blocks * bk, cap) * kv_pos
        else:
            raise ValueError(f"impl {impl!r} (want dense|flash)")
    if cfg.encoder_layers:
        total += len(lengths) * cfg.num_layers * cfg.encoder_frames * kv_pos
    return {
        "impl": impl, "kv_bits": kv_bits, "block_k": block_k,
        "n_slots": len(lengths), "s_max": s_max,
        "mean_utilization": (sum(int(x) for x in lengths)
                             / max(len(lengths) * s_max, 1)),
        "attn_read_bytes_per_step": total,
    }


def cf_lookup_bytes(spec, plan, mesh_shape: Dict[str, int], batch: int,
                    hit_rate: float = 0.0,
                    dp_axis: str = "data") -> Dict[str, float]:
    """Modeled per-request wire bytes of the serving CF lookup, cached
    vs uncached.

    The serving path is forward-only (no gradient conjugate, no DP table
    sync), so the terms are the lookup half of
    :func:`repro_torch.embeddings.table.exchange_bytes`: an all-reduce of
    (U, D/nc) partials over the row shards and/or an id all-gather + (B,
    D/nc) all-to-all over the column shards, on the same ring model
    (all-reduce ``2n(P-1)/P``, all-gather / all-to-all ``n(P-1)/P``).
    ``batch`` is ids looked up per request (user + candidates);
    ``hit_rate`` is the hot-row cache's measured hit fraction: hits are
    served from the replicated head and move **zero** wire bytes, so the
    cached exchange is the uncached one scaled by the miss fraction.  The
    replicated plan exchanges nothing on either path (its cost is
    full-table memory).
    """
    if not 0.0 <= hit_rate <= 1.0:
        raise ValueError(f"hit_rate must be in [0, 1], got {hit_rate}")
    itemsize = 4                        # f32 factor tables
    nr = mesh_shape.get(plan.row_axis, 1) if plan.row_axis else 1
    nc = mesh_shape.get(plan.col_axis, 1) if plan.col_axis else 1
    ring = lambda n: (n - 1) / n if n > 1 else 0.0  # noqa: E731

    def exchange(ids: float) -> float:
        b = 0.0
        if plan.row_axis:                # all-reduce of (U, D/nc) partials
            b += 2 * ids * (spec.dim // nc) * itemsize * ring(nr)
        if plan.col_axis:                # id all-gather + column all-to-all
            b += ids * 4 * ring(nc)
            b += ids * (spec.dim // nc) * itemsize * ring(nc)
        return b

    uncached = exchange(float(batch))
    cached = exchange(float(batch) * (1.0 - hit_rate))
    return {
        "plan": plan.kind, "batch": batch, "hit_rate": hit_rate,
        "uncached_bytes": uncached, "cached_bytes": cached,
        "saved_frac": 1.0 - cached / uncached if uncached else 0.0,
    }
