"""Sparse-gradient updates: sync only the rows a step touched (port of
``repro/embeddings/update.py`` over ``torch.distributed``).

The backward of an embedding lookup is zero everywhere except the rows the
batch hit, yet a dense DP sync all-reduces the whole (V, D) gradient every
step.  The rows-touched exchange replaces it:

    u    = unique(local ids)                # (U,) + sentinel padding
    rows = dense_grad[u]                    # (U, D): all the mass there is
    all-gather (u, rows) over the dp axes   # wire: P * U * (D*4 + 4) bytes
    scatter-add into (V, D), divide by P    # == the mean of dense_grad

``make_row_compressor("topk", k)`` keeps the top-k magnitudes of each
exchanged row (the ``topk_sparsify`` kernel, block = D).  On a world of
one, :func:`sparse_row_sync` equals the dense gradient bit for bit.

``use_kernel`` routes the two row operations through the CUDA kernels:
the gather of the touched rows through ``gather_rows`` (on the clamped
ids, then the sentinel mask; the JAX ``gather_grad_rows`` has no such
switch) and the scatter through ``scatter_add_rows``.  Both are exact, so
either route computes what the JAX functions compute.

``torch.unique`` on CUDA waits for the device once per call (its output
size is data-dependent).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.hierarchical import DPMesh, all_gather
from repro_torch.embeddings.lookup import dedup_ids
from repro_torch.kernels import ops


def rows_touched(ids: torch.Tensor, n_rows: int,
                 cap: Optional[int] = None) -> torch.Tensor:
    """Sorted unique ids padded to ``cap`` (default: the number of ids)
    with the out-of-range sentinel ``n_rows``.  Like ``jnp.unique(size=
    cap)``, more than ``cap`` unique ids are cut to the ``cap`` smallest,
    silently: the dropped rows get no gradient."""
    flat = ids.reshape(-1)
    size = cap or flat.shape[0]
    u = torch.unique(flat, sorted=True)[:size]
    return torch.cat([u, u.new_full((size - u.shape[0],), n_rows)])


def gather_grad_rows(dense_grad: torch.Tensor, u: torch.Tensor,
                     use_kernel: bool = False) -> torch.Tensor:
    """(U, D) gradient rows for unique ids; sentinel entries read as 0."""
    v = dense_grad.shape[0]
    valid = u < v
    safe = torch.clamp(u, 0, v - 1)
    rows = (ops.embedding_gather(dense_grad, safe) if use_kernel
            else dense_grad[safe.long()])
    return torch.where(valid[:, None], rows, rows.new_zeros(()))


def scatter_rows(u: torch.Tensor, rows: torch.Tensor, n_rows: int,
                 use_kernel: bool = False) -> torch.Tensor:
    """(V, D) dense gradient from (ids, rows); sentinel ids land on a dump
    row ``n_rows`` that is sliced off."""
    idx = torch.clamp(u, max=n_rows)
    impl = "kernel" if use_kernel else "ref"
    return ops.embedding_scatter_add(rows, idx, n_rows + 1,
                                     impl=impl)[:n_rows]


def make_row_compressor(mode: str, k: int = 8, use_kernel: bool = True
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-row payload compressor for the exchanged gradient rows: ``topk``
    keeps the k largest-magnitude entries of each row (block = the
    embedding dim) through the top-k sparsifier."""
    if mode != "topk":
        raise ValueError(f"unknown row compressor {mode!r}")

    def compress(rows: torch.Tensor) -> torch.Tensor:
        u, d = rows.shape
        kept, _ = ops.topk_sparsify(rows.reshape(-1), min(k, d), block=d,
                                    impl="kernel" if use_kernel else "ref")
        return kept.reshape(u, d)

    return compress


def sparse_row_sync(dense_grad: torch.Tensor, ids: torch.Tensor,
                    mesh: DPMesh, axes: Sequence[str], *,
                    cap: Optional[int] = None,
                    compress: Optional[Callable] = None,
                    use_kernel: bool = False) -> torch.Tensor:
    """The mean DP gradient of one table by the rows-touched all-gather.

    dense_grad: this rank's (V, D) gradient; ids: the local batch's ids
    (any shape).  Returns the (V, D) mean over the dp ``axes``, gathering
    over each axis in turn (tiled, in the axes' order, as the JAX sync
    does), so duplicate rows add in the reference's order.  ``cap`` as in
    :func:`rows_touched`: it must cover the batch's unique ids."""
    v = dense_grad.shape[0]
    u = rows_touched(ids, v, cap)
    rows = gather_grad_rows(dense_grad, u, use_kernel)
    if compress is not None:
        rows = compress(rows)
    n_ranks = 1
    for ax in axes:
        u = all_gather(u, mesh, ax, tiled=True)
        rows = all_gather(rows, mesh, ax, tiled=True)
        n_ranks *= mesh.shape[ax]
    return scatter_rows(u, rows, v, use_kernel) / n_ranks


def sparse_grad_from_lookup(dout: torch.Tensor, ids: torch.Tensor,
                            n_rows: int, cap: Optional[int] = None,
                            use_kernel: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique ids, per-unique-row gradient) from the lookup cotangent:
    the segment-sum form, for optimizers that update touched rows only.

    dout: (..., D) cotangent of ``table[ids]``; returns (u (cap,),
    rows (cap, D)) with ``scatter_rows(u, rows, n_rows)`` equal to the
    dense gradient.  ``u`` is padded with repeats of the smallest id, as
    ``jnp.unique(size=cap)`` pads; only the first of them accumulates
    anything.  Unlike JAX, a ``cap`` below the unique count raises."""
    del n_rows                      # the padding needs no sentinel row
    d = dout.shape[-1]
    u, inv = dedup_ids(ids, cap)
    impl = "kernel" if use_kernel else "ref"
    rows = ops.embedding_scatter_add(dout.reshape(-1, d), inv, u.shape[0],
                                     impl=impl)
    return u, rows
