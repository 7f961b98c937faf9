"""OLMo-1B — dense decoder with non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from repro_torch.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparam_ln",       # OLMo: LN without scale/bias
    mlp_gated=True,                # OLMo uses SwiGLU
    act="silu",
    pos_type="rope",
    rope_theta=1e4,
    tie_embeddings=True,
    source="arXiv:2402.00838; hf",
))
