"""Hybrid parallelism auto-planner (paper C8, the DeepSpeed/Megatron
auto-scheduled hybrid scheme of Table 2, row 4); port of
``repro/core/hybrid.py``.

Given (arch, mesh, shape) it derives a per-layer cost model and emits a
:class:`Plan`: which tensors take TP, whether activations are
sequence-sharded, remat policy, gradient-sync mode and, on a mesh with a
``stage`` axis, the layer->stage bounds.  Every choice is the JAX
planner's except remat, which weighs the activations against one H100's
memory (``config.H100_HBM_BYTES``) instead of a TPU chip's.
``decode_model_flops`` is the FLOP model the serving engine's traced
``decode_step`` spans carry; :func:`modeled_parallel_step` prices a DP x
TP x PP step on H100 constants.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.config import (ArchConfig, H100_HBM_BYTES, H100_NVLINK_BW,
                                H100_PEAK_FLOPS_BF16, ParallelConfig,
                                ShapeConfig)
from repro_torch.core import load_balance
from repro_torch.core.pipeline import schedule_cost
from repro_torch.core.sharding import ShardingPlan, make_plan


def layer_flops(cfg: ArchConfig, kind: str, layer_idx: int, seq: int) -> float:
    """Forward FLOPs for one layer at batch=1, given sequence length."""
    d = cfg.d_model
    if kind in ("attn", "local_attn"):
        proj = 2 * seq * d * (cfg.q_dim + 2 * cfg.kv_dim + cfg.q_dim)
        ctx_len = min(seq, cfg.sliding_window) if kind == "local_attn" and \
            cfg.sliding_window else seq
        attn = 2 * seq * ctx_len * cfg.q_dim * 2
        f = proj + attn
    elif kind == "mamba":
        d_in = cfg.ssm_expand * d
        f = 2 * seq * d * 2 * d_in + 2 * seq * d_in * d \
            + seq * d_in * cfg.ssm_d_state * 6
    elif kind == "rwkv6":
        f = 2 * seq * d * d * 5 + seq * d * cfg.rwkv_head_size * 4
    else:
        raise ValueError(kind)
    # FFN
    mats = 3 if cfg.mlp_gated else 2
    if cfg.is_moe and layer_idx % cfg.moe_period == cfg.moe_period - 1:
        f += 2 * seq * mats * d * cfg.d_ff * cfg.experts_per_token
    else:
        f += 2 * seq * mats * d * cfg.d_ff
    return float(f)


def model_flops(cfg: ArchConfig, seq: int, batch: int,
                training: bool = True) -> float:
    """6*N*D-style total: fwd (+2x bwd when training) over all layers."""
    f = sum(layer_flops(cfg, kind, i, seq)
            for i, kind in enumerate(cfg.layer_kinds()))
    if cfg.encoder_layers:
        f += cfg.encoder_layers * layer_flops(cfg, "attn", 0,
                                              cfg.encoder_frames)
    f += 2 * seq * cfg.d_model * cfg.padded_vocab      # lm head
    f *= batch
    return f * 3 if training else f


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


@dataclasses.dataclass(frozen=True)
class Plan:
    sharding: ShardingPlan
    pcfg: ParallelConfig
    remat: bool
    grad_sync: str                    # auto | flat | hierarchical | compressed
    stage_bounds: Optional[Tuple[int, ...]] = None
    notes: Tuple[str, ...] = ()

    @property
    def pp_schedule(self) -> str:
        return self.pcfg.pp_schedule

    @property
    def n_micro(self) -> int:
        return max(self.pcfg.microbatches, 1)


def auto_plan(cfg: ArchConfig, mesh, shape: ShapeConfig,
              pcfg: ParallelConfig = ParallelConfig(),
              embed_plans=None) -> Plan:
    """The plan for ``cfg`` training or serving ``shape`` on ``mesh`` (a
    :class:`~repro_torch.core.hierarchical.DPMesh`, or anything with its
    ``shape`` dict and ``axis_names``).  ``embed_plans`` (top-level
    param key -> :class:`~repro_torch.embeddings.EmbedPlan`, the sharded
    CF tables) passes through to the sharding plan."""
    notes: List[str] = []
    training = shape.kind == "train"
    n_chips = math.prod(mesh.shape.values())

    # --- remat: without it, the backward keeps every layer's inner
    # intermediates (attention chunk tensors, MLP hiddens): O(10-50x) the
    # residual stream.  Remat whenever even a conservative 8x of the
    # residual-stream floor would pressure one H100's memory.
    tokens = shape.global_batch * shape.seq_len
    act_bytes = tokens * cfg.d_model * 2 * cfg.num_layers / n_chips
    remat = training and 8 * act_bytes > 0.05 * H100_HBM_BYTES
    if remat:
        notes.append(f"remat on (residual floor {act_bytes/1e9:.2f}GB/chip)")

    # --- sequence sharding: only when seq divides and is long enough -------
    tp = mesh.shape.get("model", 1)
    seq_shard = pcfg.seq_shard_activations and shape.seq_len % max(tp, 1) == 0 \
        and shape.seq_len >= 16 * max(tp, 1)

    # --- hybrid choice (paper C8): Megatron TP x DP vs dp_heavy (batch over
    # every axis + FSDP weight gathering).  Napkin per-step collective cost:
    #   megatron ~ 5 activation reshards/layer x 3 passes
    #   dp_heavy ~ weight bytes x (3 gathers + 1 grad reduce-scatter)
    dp_heavy = False
    dp_n = math.prod(mesh.shape[a] for a in mesh.axis_names if a != "model")
    if (training and not cfg.is_moe and tp > 1
            and shape.global_batch % n_chips == 0):
        act_bytes = (shape.global_batch // dp_n) * shape.seq_len \
            * cfg.d_model * 2
        megatron_coll = 5 * act_bytes * 3 * cfg.num_layers
        weight_bytes = 2 * cfg.num_params()
        dp_heavy_coll = 4 * weight_bytes
        if dp_heavy_coll < megatron_coll:
            dp_heavy = True
            notes.append(
                f"dp_heavy plan (est coll {dp_heavy_coll/1e9:.0f}GB vs "
                f"megatron {megatron_coll/1e9:.0f}GB)")

    sharding = make_plan(mesh, pcfg, seq_shard=seq_shard, dp_heavy=dp_heavy,
                         embed_plans=embed_plans)
    if embed_plans:
        notes.append("embed tables via EmbedPlan: " + ", ".join(
            f"{k}={p.kind}" for k, p in sorted(embed_plans.items())))

    # --- gradient sync mode -------------------------------------------------
    grad_sync = pcfg.grad_sync
    if grad_sync == "auto":
        grad_sync = "hierarchical" if "pod" in mesh.axis_names else "auto"

    # --- pipeline partition (only when a stage axis exists) -----------------
    bounds = None
    if "stage" in mesh.axis_names:
        costs = [layer_flops(cfg, kind, i, shape.seq_len)
                 for i, kind in enumerate(cfg.layer_kinds())]
        bounds = tuple(load_balance.balance_stages(costs,
                                                   mesh.shape["stage"]))
        notes.append(f"stage bounds {bounds}")
        if mesh.shape["stage"] > 1:
            bub = schedule_cost(pcfg.pp_schedule, mesh.shape["stage"],
                                max(pcfg.microbatches, 1))["bubble_frac"]
            notes.append(f"pp {pcfg.pp_schedule} x{pcfg.microbatches} "
                         f"bubble {bub:.2f}")

    return Plan(sharding=sharding, pcfg=pcfg, remat=remat,
                grad_sync=grad_sync, stage_bounds=bounds,
                notes=tuple(notes))


# ---------------------------------------------------------------------------
# Analytic DP x TP x PP step model (the ``train-parallel`` benchmark rows)
# ---------------------------------------------------------------------------

def modeled_parallel_step(cfg: ArchConfig, shape: ShapeConfig, *,
                          dp: int = 1, tp: int = 1, pp: int = 1,
                          n_micro: int = 8, schedule: str = "1f1b",
                          zero1: bool = True) -> Dict[str, float]:
    """A roofline for one training step under a DP x TP x PP plan, on
    the H100's constants: ``config.H100_PEAK_FLOPS_BF16`` (989 TFLOP/s
    dense bf16), ``H100_NVLINK_BW`` (450 GB/s a direction a card) and
    ``H100_HBM_BYTES`` (80 GiB).  These are the card's figures, not a
    measurement; JAX's model takes a TPU v5e chip's.

    Terms (per device, ring-collective byte model):

    * compute -- ``model_flops / (n_dev * peak)``;
    * DP -- gradient all-reduce of this rank's parameter shard;
    * TP -- Megatron activation all-reduces: 2 branch reductions per layer
      forward and their backward conjugates (4 activation-sized
      all-reduces per layer-pass) over the device's ``L/pp`` layers;
    * PP -- boundary activation sends (fwd) + cotangent sends (bwd);
    * bubble -- the schedule's idle fraction (``pipeline.schedule_cost``)
      stretches the busy span by ``1/(1-bubble)`` when pp > 1.

    Memory feasibility is part of the model: per-device bytes = params
    (bf16) + grads (f32) + optimizer (m, v, master in f32; ZeRO-1 over dp
    when ``zero1``); an infeasible plan reports ``throughput = 0`` with
    ``fits = False``.
    """
    n_dev = dp * tp * pp
    N = cfg.num_params()
    flops = model_flops(cfg, shape.seq_len, shape.global_batch,
                        training=True)
    t_compute = flops / (n_dev * H100_PEAK_FLOPS_BF16)

    def ring(k, b):
        return 2 * b * (k - 1) / k if k > 1 else 0.0
    # DP: all-reduce this rank's grad shard (f32 master grads)
    t_dp = ring(dp, 4 * N / (tp * pp)) / H100_NVLINK_BW
    # TP: 4 act-sized all-reduces per layer over the device's local layers
    L = cfg.num_layers
    act = (shape.global_batch // max(dp, 1)) * shape.seq_len * cfg.d_model * 2
    t_tp = ring(tp, 4 * (L / pp) * act) / H100_NVLINK_BW
    # PP: neighbour sends, activation fwd + cotangent bwd per micro-batch
    t_pp = (2 * act * 2 / H100_NVLINK_BW) if pp > 1 else 0.0
    t_coll = t_dp + t_tp + t_pp

    bubble = schedule_cost(schedule, pp, n_micro)["bubble_frac"] \
        if pp > 1 else 0.0
    t_busy = max(t_compute, t_coll)
    t_step = t_busy / max(1.0 - bubble, 1e-9)

    # memory feasibility from the resident state: weights bf16 + grads f32
    # + adamw m/v/master f32 (ZeRO-1 over dp); activations left out
    state = (2 + 4) * N / (tp * pp) + 12 * N / (tp * pp * (dp if zero1
                                                           else 1))
    fits = state < H100_HBM_BYTES
    tput = shape.global_batch / t_step if fits else 0.0
    return {"dp": dp, "tp": tp, "pp": pp, "n_micro": n_micro,
            "schedule": schedule, "fits": bool(fits),
            "state_gb_per_dev": state / 1e9,
            "t_compute_ms": t_compute * 1e3, "t_dp_ms": t_dp * 1e3,
            "t_tp_ms": t_tp * 1e3, "t_pp_ms": t_pp * 1e3,
            "bubble_frac": bubble, "t_step_ms": t_step * 1e3,
            "modeled_throughput": tput}
