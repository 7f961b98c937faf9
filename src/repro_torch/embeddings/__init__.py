"""Embedding tables: the unsharded specs, init and dedup lookup that
RecLLM's CF factors need (the sharded plans are not ported yet)."""
from repro_torch.embeddings.lookup import dedup_ids, dedup_lookup  # noqa: F401
from repro_torch.embeddings.table import EmbedSpec, init_table  # noqa: F401
