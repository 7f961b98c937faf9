"""Embedding tables: the unsharded specs, init and dedup lookup that
RecLLM's CF factors need, the rows-touched gradient sync, and the serving
lookup with its hot-row cache (the sharded plans are not ported yet)."""
from repro_torch.embeddings.lookup import dedup_ids, dedup_lookup  # noqa: F401
from repro_torch.embeddings.serving import (  # noqa: F401
    CacheConfig, CachedLookup, FreqTracker, HotRowCache, make_cached_lookup)
from repro_torch.embeddings.table import EmbedSpec, init_table  # noqa: F401
from repro_torch.embeddings.update import (  # noqa: F401
    gather_grad_rows, make_row_compressor, rows_touched, scatter_rows,
    sparse_grad_from_lookup, sparse_row_sync)
