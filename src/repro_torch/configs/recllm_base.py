"""RecLLM — the paper's own LLM-based recommendation backbone (~100M class).

A decoder-only LM over item-token sequences fused with CF embeddings (Fig. 1);
trained with next-item prediction on the Amazon-Electronics-like dataset.
"""
from repro_torch.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recllm-base",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=63001 + 3,           # item vocab (#items + pad/bos/mask)
    norm_type="rmsnorm",
    mlp_gated=True,
    act="silu",
    pos_type="rope",
    tie_embeddings=True,
    source="paper §IV (Amazon Electronics, 63,001 items)",
))
