"""Architecture registry: importing this package registers every config the
port serves (RecLLM-base and the MoE uniform archs; the other archs come
with their families)."""
from repro_torch.configs import (moonshot_v1_16b_a3b, qwen3_moe_30b_a3b,
                                 recllm_base)

ALL = (moonshot_v1_16b_a3b.CONFIG, qwen3_moe_30b_a3b.CONFIG,
       recllm_base.CONFIG)
