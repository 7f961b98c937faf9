"""Architecture and training configs, and the architecture registry (a
copy of ``repro/config.py``).

Every architecture in :mod:`repro_torch.configs` registers an
:class:`ArchConfig` here; :class:`TrainConfig` holds the optimizer and loop
settings; :class:`ParallelConfig`, :class:`ShapeConfig` and ``SHAPES`` the
hybrid-parallelism plan and the assigned input shapes.  The TPU hardware
constants of the JAX package are left out: no speed number of that chip
applies to the port.  The planner (``core/hybrid.py``) reads the H100's
constants below instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Hardware model: one NVIDIA H100 SXM5 (80 GB), as the planner reads it
# (``auto_plan``'s remat rule the memory; the step model of the pipelined
# slice, ``modeled_parallel_step``, the other two).
# ---------------------------------------------------------------------------

H100_HBM_BYTES = 80 * 1024**3       # device memory per card
H100_PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor-core FLOP/s
H100_NVLINK_BW = 450e9              # NVLink 4, B/s per direction per card


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A transformer-family architecture (exact public config)."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1             # 1 => every FFN is MoE; jamba uses 2
    # --- attention pattern ---
    sliding_window: int = 0         # >0 => local attention window for "local" layers
    local_global_pattern: int = 0   # N>0 => N local layers then 1 global, repeated
    qk_norm: bool = False
    # --- norm / act ---
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm | nonparam_ln
    mlp_gated: bool = True          # SwiGLU-style (3 mats) vs plain (2 mats)
    act: str = "silu"               # silu | gelu | relu2
    # --- positions ---
    pos_type: str = "rope"          # rope | mrope | learned | none
    rope_theta: float = 1e4
    # --- ssm / hybrid ---
    ssm_type: str = ""              # "rwkv6" | "mamba" (hybrid)
    attn_period: int = 0            # jamba: one attn layer per period of N layers
    ssm_d_state: int = 16           # mamba state dim
    ssm_d_conv: int = 4             # mamba conv width
    ssm_expand: int = 2             # mamba inner expansion
    rwkv_head_size: int = 64
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_frames: int = 0         # stub frontend: precomputed frames fed directly
    # --- vlm (qwen2-vl) ---
    mrope_sections: Tuple[int, ...] = ()   # head_dim split across (t, h, w)
    image_prefix_frac: float = 0.0         # fraction of seq that is patch embeds
    # --- misc ---
    tie_embeddings: bool = False
    vocab_pad_to: int = 256
    dtype: str = "bfloat16"
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string: 'attn' | 'local_attn' | 'mamba' | 'rwkv6'."""
        kinds = []
        for i in range(self.num_layers):
            if self.ssm_type == "rwkv6":
                kinds.append("rwkv6")
            elif self.ssm_type == "mamba" and self.attn_period > 0:
                kinds.append("attn" if i % self.attn_period == 0 else "mamba")
            elif self.local_global_pattern > 0:
                p = self.local_global_pattern
                kinds.append("attn" if (i % (p + 1)) == p else "local_attn")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def num_params(self) -> int:
        """Analytic parameter count (embedding + per-layer)."""
        n = self.padded_vocab * self.d_model          # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model     # lm head
        for i, kind in enumerate(self.layer_kinds()):
            n += self._layer_params(kind, layer_idx=i)
        if self.encoder_layers:
            n += self.encoder_layers * self._layer_params("attn", cross=False)
            # decoder cross-attention blocks
            n += self.num_layers * (2 * self.d_model * self.kv_dim
                                    + self.d_model * self.q_dim
                                    + self.q_dim * self.d_model)
        return n

    def _ffn_params(self, layer_idx: int = 0) -> int:
        mats = 3 if self.mlp_gated else 2
        if self.is_moe and (layer_idx % self.moe_period == self.moe_period - 1):
            router = self.d_model * self.num_experts
            return router + self.num_experts * mats * self.d_model * self.d_ff
        if self.is_moe and self.moe_period > 1:
            # dense interleave layers in a partially-MoE model reuse d_ff
            return mats * self.d_model * self.d_ff
        if self.is_moe:
            return (self.d_model * self.num_experts
                    + self.num_experts * mats * self.d_model * self.d_ff)
        return mats * self.d_model * self.d_ff

    def _layer_params(self, kind: str, cross: bool = False, layer_idx: int = 0) -> int:
        d = self.d_model
        if kind in ("attn", "local_attn"):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        elif kind == "mamba":
            d_in = self.ssm_expand * d
            attn = (d * 2 * d_in                   # in_proj (x, z)
                    + d_in * self.ssm_d_conv       # conv
                    + d_in * (2 * self.ssm_d_state + 1)  # B, C, dt proj (simplified)
                    + d_in * self.ssm_d_state      # A_log
                    + d_in * d)                    # out_proj
        elif kind == "rwkv6":
            h = d // self.rwkv_head_size
            attn = (4 * d * d                      # r, k, v, output
                    + d * d                        # gate
                    + 6 * d                        # time-mix lerps (lora-less approx)
                    + h * self.rwkv_head_size)     # time_first
        else:
            raise ValueError(kind)
        return attn + self._ffn_params(layer_idx)

    def active_params(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.num_params()
        n = self.padded_vocab * self.d_model * (1 if self.tie_embeddings else 2)
        mats = 3 if self.mlp_gated else 2
        for i, kind in enumerate(self.layer_kinds()):
            full = self._layer_params(kind, layer_idx=i)
            if i % self.moe_period == self.moe_period - 1:
                moe_full = self.num_experts * mats * self.d_model * self.d_ff
                moe_act = self.experts_per_token * mats * self.d_model * self.d_ff
                full = full - moe_full + moe_act
            n += full
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The hybrid-parallelism plan (paper C1/C2/C5/C6/C8)."""

    dp: int = 1
    tp: int = 1
    pp: int = 1                       # pipeline stages (separate mesh when > 1)
    microbatches: int = 1             # pipeline micro-batches
    pp_schedule: str = "1f1b"         # 1f1b | gpipe
    multi_pod: bool = False
    # activation sharding
    seq_shard_activations: bool = True   # Megatron-SP residual stream
    remat: str = "full"               # none | full (checkpoint on layer bodies)
    # gradient sync (paper C5/C6)
    grad_sync: str = "auto"           # auto | hierarchical | compressed
    compression: str = "none"         # none | onebit | topk
    topk_frac: float = 0.01
    # async (paper C7; simulation only)
    async_mode: bool = False
    max_staleness: int = 4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    zero1: bool = True                # shard optimizer state over dp axis
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    checkpoint_dir: str = "/tmp/repro_ckpt"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (populates registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(_REGISTRY))


def reduced(cfg: ArchConfig, *, layers: Optional[int] = None) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        num_layers=layers if layers is not None else min(cfg.num_layers, 2),
        d_model=64,
        num_heads=max(2, min(cfg.num_heads, 4)),
        num_kv_heads=1 if cfg.num_kv_heads < cfg.num_heads else max(2, min(cfg.num_heads, 4)),
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        vocab_pad_to=32,
    )
    if cfg.is_moe:
        kw.update(num_experts=4, experts_per_token=2)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_frames=8)
    if cfg.ssm_type == "rwkv6":
        kw.update(rwkv_head_size=16, num_heads=4, head_dim=16)
    if cfg.attn_period:
        kw.update(num_layers=max(cfg.attn_period, 4), attn_period=4)
    if cfg.local_global_pattern:
        kw.update(num_layers=6, local_global_pattern=2, sliding_window=8)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(4, 2, 2))
    return dataclasses.replace(cfg, **kw)
