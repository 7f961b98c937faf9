"""Embedding row gather and exact segment-sum scatter-add: the wrappers of
``csrc/embedding_ops.cu``.

Ports of the Pallas TPU kernels ``repro/kernels/embedding_ops.py``:
``gather_rows`` is ``table[ids]``; ``scatter_add_rows`` accumulates
``out[idx[i]] += x[i]`` into zeros, duplicate ids summed in input order
(the TPU kernel's sequential loop), with no float atomics and no sort.
The kernels' design notes are at the top of the CUDA source.

CPU tensors go to the plain versions (:mod:`repro_torch.kernels.ref`);
CUDA tensors launch the kernel or raise.  Each wrapper counts its launches
in ``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def gather_rows(table, ids):
    """table (V, D) of any dtype, ids (n,) integer in [0, V) -> (n, D)."""
    _build.refuse_grad("gather_rows", table)
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"gather_rows: table {tuple(table.shape)}, ids "
                         f"{tuple(ids.shape)} (want (V, D) and (n,))")
    if table.device.type == "cpu":
        return ref.gather_rows(table, ids)
    ids32 = ids.to(torch.int32).contiguous()
    _build.check_dense("gather_rows", (table, table.dtype),
                       (ids32, torch.int32))
    V, D = table.shape
    n = ids32.shape[0]
    out = torch.empty((n, D), dtype=table.dtype, device=table.device)
    err = _build.entry("repro_gather_rows")(
        table.data_ptr(), ids32.data_ptr(), out.data_ptr(), n, V,
        D * table.element_size(),
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check("gather_rows", err)
    gather_rows.launches += 1
    return out


def scatter_add_rows(x, idx, n_rows: int):
    """x (n, D) f32, idx (n,) integer in [0, n_rows) -> (n_rows, D) f32
    with ``out[idx[i]] += x[i]`` from zeros, in input order.  On the card
    one kernel launch: each block sums the ids that land in its slab of
    the output in input order and writes the slab once (no sort, no
    separate zero-fill); ids outside [0, n_rows) are skipped."""
    _build.refuse_grad("scatter_add_rows", x)
    if x.dim() != 2 or idx.shape != x.shape[:1]:
        raise ValueError(f"scatter_add_rows: x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)} (want (n, D) and (n,))")
    if x.device.type == "cpu":
        return ref.scatter_add_rows(x, idx, n_rows)
    idx32 = idx.to(torch.int32).contiguous()   # no copy for int32 ids
    _build.check_dense("scatter_add_rows", (x, torch.float32),
                       (idx32, torch.int32))
    n, D = x.shape
    out = torch.empty((n_rows, D), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    err = _build.entry("repro_scatter_add_rows")(
        x.data_ptr(), idx32.data_ptr(), out.data_ptr(), n, D, n_rows,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("scatter_add_rows", err)
    scatter_add_rows.launches += 1
    return out


# kernel launches since the last reset
gather_rows.launches = 0
scatter_add_rows.launches = 0
