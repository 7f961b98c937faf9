"""Architecture registry: importing this package registers every config the
port serves (RecLLM-base, the MoE uniform archs and rwkv6-1.6b; the other
archs come with their families)."""
from repro_torch.configs import (moonshot_v1_16b_a3b, qwen3_moe_30b_a3b,
                                 recllm_base, rwkv6_1_6b)

ALL = (moonshot_v1_16b_a3b.CONFIG, qwen3_moe_30b_a3b.CONFIG,
       recllm_base.CONFIG, rwkv6_1_6b.CONFIG)
