"""Qwen3-30B-A3B — MoE 128 experts top-8, qk-norm [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                       # per-expert FFN dim
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    qk_norm=True,
    norm_type="rmsnorm",
    mlp_gated=True,
    act="silu",
    pos_type="rope",
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
