"""Architecture registry: importing this package registers every config the
port serves (RecLLM-base in this slice; the other archs come with their
families)."""
from repro_torch.configs.recllm_base import CONFIG as recllm_base

ALL = (recllm_base,)
