"""One explicit KV-cache layout spec (a copy of ``repro/cache_layout.py``).

Fields:

``kind``
    ``"dense"`` — per-slot padded rows ``(n_slots, S_max, ...)``;
    ``"paged"`` — a shared block pool plus per-slot block tables.
``kv_bits``
    16 (model dtype) or 8 (int8 values + per-(position, head) f32 scales).
``impl``
    decode-attention implementation: ``"dense"`` (one einsum over the
    padded cache), ``"flash"`` (the CUDA flash-decode kernel, which loops
    over the live KV range only), or ``"ref"`` (the plain PyTorch oracle).
``block_size`` / ``num_blocks`` / ``prefix_sharing``
    paged only: tokens per pool block, pool capacity (0 = auto), and
    prompt-prefix block sharing.
``window`` / ``ring``
    masking variant of one attention call: a sliding-window band over a
    linear cache, or gemma's wraparound ring buffer.
``block_k``
    the TPU flash-decode KV tile; the CUDA kernel picks its own tiling and
    does not read it.

Every (kind, kv_bits, impl) cell is served for the uniform family; the
int8 layouts take the full-cache mask only (``window``/``ring`` raise), as
in the JAX package.
"""
from __future__ import annotations

import dataclasses

__all__ = ["CacheLayout", "blocks_per_slot", "resolved_num_blocks"]


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    kind: str = "dense"          # dense | paged
    kv_bits: int = 16            # 16 | 8
    impl: str = "dense"          # ref | dense | flash
    block_size: int = 16         # paged: tokens per pool block
    num_blocks: int = 0          # paged: pool capacity (0 = auto)
    prefix_sharing: bool = True  # paged: hash-share full prompt blocks
    window: int = 0              # sliding-window band (one attention call)
    ring: bool = False           # ring-buffer window layout
    block_k: int = 128           # TPU flash-decode KV tile (unused here)

    def __post_init__(self):
        if self.kind not in ("dense", "paged"):
            raise ValueError(f"kind {self.kind!r} (want dense|paged)")
        if self.kv_bits not in (8, 16):
            raise ValueError(f"kv_bits {self.kv_bits!r} (want 8|16)")
        if self.impl not in ("ref", "dense", "flash"):
            raise ValueError(f"impl {self.impl!r} (want ref|dense|flash)")
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive: {self.block_size}")
        if self.ring and self.window <= 0:
            raise ValueError("ring=True needs window > 0")

    @property
    def paged(self) -> bool:
        return self.kind == "paged"

    @property
    def quantized(self) -> bool:
        return self.kv_bits == 8

    def replace(self, **kw) -> "CacheLayout":
        return dataclasses.replace(self, **kw)


def blocks_per_slot(layout: CacheLayout, max_len: int) -> int:
    """Block-table width: virtual blocks covering one slot's serving window.
    ``max_len`` must be a multiple of ``block_size`` so dense and paged
    states describe the same position space."""
    if max_len % layout.block_size:
        raise ValueError(
            f"max_len={max_len} must be a multiple of "
            f"block_size={layout.block_size} for the paged layout")
    return max_len // layout.block_size


def resolved_num_blocks(layout: CacheLayout, n_slots: int,
                        max_len: int) -> int:
    """Pool capacity in blocks: ``layout.num_blocks``, or (when 0) the
    dense-equivalent ``n_slots * max_len / block_size``; either way plus
    one: block 0 is the reserved null sink (never allocated; dead table
    entries point at it)."""
    nb = blocks_per_slot(layout, max_len)
    cap = layout.num_blocks if layout.num_blocks > 0 else n_slots * nb
    return cap + 1
