"""DeepSeek-LLM-7B — llama-arch dense decoder [arXiv:2401.02954; hf]."""
from repro_torch.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    norm_type="rmsnorm",
    mlp_gated=True,
    act="silu",
    pos_type="rope",
    rope_theta=1e4,
    source="arXiv:2401.02954; hf",
))
