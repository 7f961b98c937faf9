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

This slice serves ``kind="dense"`` with ``kv_bits=16`` only; the consumers
(:func:`repro_torch.kernels.ops.decode_attention`,
:func:`repro_torch.serving.engine.make_backend`) raise
``NotImplementedError`` for the other layouts.
"""
from __future__ import annotations

import dataclasses

__all__ = ["CacheLayout", "require_dense16"]


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


def require_dense16(layout: CacheLayout) -> None:
    """Raise for every layout this slice of the port does not serve."""
    if layout.paged or layout.quantized:
        raise NotImplementedError(
            f"cache layout kind={layout.kind!r} kv_bits={layout.kv_bits} is "
            "not ported yet (this slice serves dense 16-bit caches; the "
            "paged and int8 layouts are queued in ROADMAP.md)")
