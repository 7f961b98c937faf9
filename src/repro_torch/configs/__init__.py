"""Architecture registry: importing this package registers every config the
port serves (RecLLM-base, the dense uniform archs, the MoE uniform archs
and rwkv6-1.6b; the other archs come with their families)."""
from repro_torch.configs import (deepseek_7b, internlm2_20b,
                                 moonshot_v1_16b_a3b, olmo_1b,
                                 qwen3_moe_30b_a3b, recllm_base, rwkv6_1_6b)

ALL = (deepseek_7b.CONFIG, internlm2_20b.CONFIG, moonshot_v1_16b_a3b.CONFIG,
       olmo_1b.CONFIG, qwen3_moe_30b_a3b.CONFIG, recllm_base.CONFIG,
       rwkv6_1_6b.CONFIG)
