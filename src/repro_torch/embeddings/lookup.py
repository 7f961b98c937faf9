"""Dedup embedding lookup (port of the unsharded part of
``repro/embeddings/lookup.py``): unique -> gather -> inverse.

A batch of n ids hits U <= n unique rows, so the gather moves U rows.
``jnp.unique(size=n)`` keeps the shapes static by padding the unique ids
with repeats of the smallest one; :func:`dedup_ids` reproduces that
padding.  ``use_kernel=True`` gathers the unique rows with the
``gather_rows`` CUDA kernel (forward only, as in JAX: the kernel has no
backward).  The sharded plans are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def dedup_ids(ids: torch.Tensor, cap: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique ids (cap,), inverse (n,)): sorted unique ids padded with
    repeats of the smallest id; ``u[inv]`` reconstructs ``ids``.  ``cap``
    (default n) must be at least the number of unique ids."""
    flat = ids.reshape(-1)
    u, inv = torch.unique(flat, sorted=True, return_inverse=True)
    size = cap or flat.shape[0]
    if u.shape[0] > size:
        raise ValueError(f"{u.shape[0]} unique ids exceed cap {size}")
    u = torch.cat([u, u[:1].expand(size - u.shape[0])])
    return u, inv.reshape(-1)


def dedup_lookup(table: torch.Tensor, ids: torch.Tensor,
                 use_kernel: bool = False) -> torch.Tensor:
    """``table[ids]`` via unique -> gather -> inverse; equal to the direct
    gather, moving U <= n rows."""
    u, inv = dedup_ids(ids)
    rows = ops.embedding_gather(table, u) if use_kernel else table[u]
    return rows[inv].reshape(ids.shape + (table.shape[-1],))
