"""Moonlight-16B-A3B (kimi/moonshot) — MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                      # per-expert FFN dim
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    norm_type="rmsnorm",
    mlp_gated=True,
    act="silu",
    pos_type="rope",
    rope_theta=5e4,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
))
