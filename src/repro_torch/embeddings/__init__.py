"""Sharded sparse-embedding subsystem (port of ``repro/embeddings``).

* :mod:`repro_torch.embeddings.table`  -- placement: EmbedSpec/EmbedPlan,
  shard shapes/bytes, partition specs, the modeled exchange-cost summary.
* :mod:`repro_torch.embeddings.lookup` -- dedup lookup (unique -> gather
  -> inverse) and the sharded lookups of each plan over a mesh.
* :mod:`repro_torch.embeddings.update` -- rows-touched sparse-gradient DP
  sync and segment-sum gradients, with optional payload compression.
* :mod:`repro_torch.embeddings.serving` -- the serving-side hot-row
  replica in front of the sharded lookup.
"""
from repro_torch.embeddings.table import (  # noqa: F401
    PLANS, EmbedPlan, EmbedSpec, exchange_bytes, init_table, make_plan,
    named_sharding, plan_summary, pspec, shard_bytes, shard_shape,
    sparse_exchange_bytes)
from repro_torch.embeddings.lookup import (  # noqa: F401
    dedup_ids, dedup_lookup, make_sharded_lookup, replicated_lookup,
    sharded_lookup_body)
from repro_torch.embeddings.update import (  # noqa: F401
    gather_grad_rows, make_row_compressor, rows_touched, scatter_rows,
    sparse_grad_from_lookup, sparse_row_sync)
from repro_torch.embeddings.serving import (  # noqa: F401
    CacheConfig, CachedLookup, FreqTracker, HotRowCache, make_cached_lookup)
