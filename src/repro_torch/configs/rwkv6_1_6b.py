"""RWKV-6 (Finch) 1.6B — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,                   # d_model / rwkv_head_size
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    ssm_type="rwkv6",
    rwkv_head_size=64,
    norm_type="layernorm",
    mlp_gated=False,                # rwkv channel-mix (r,k,v mats; relu^2)
    act="relu2",
    pos_type="none",
    source="arXiv:2404.05892; unverified",
))
