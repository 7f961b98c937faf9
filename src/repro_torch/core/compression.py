"""Compressed gradient sync with error feedback (paper C6, Eq. 10-11); port
of ``repro/core/compression.py`` over ``torch.distributed``.

* 1-bit (EF-signSGD): each rank packs sign bits 8 per uint8 with per-block
  L1 scales (the ``onebit_quantize`` kernel), all-gathers the uint8
  payload and the scales over the dp group (wire bytes N/8 + 4N/(8 block)
  against 4N for f32), dequantizes all P payloads in one launch and
  averages them.  The quantization error stays in a per-rank residual
  that is added to the next step's gradient (error feedback, Eq. 11).
* top-k: each rank picks each block's k largest magnitudes and the
  residual they leave in one pass (the ``topk_select`` entry of the
  ``topk_sparsify`` kernel), all-gathers exactly k (value, int32 index)
  pairs per block (8k bytes per block) and scatter-adds them locally.

Both return (synced mean gradient, new residual).  The flat vector takes
the leaves in the JAX pytree's order, so residuals line up element for
element with the JAX package's.  The mean over ranks divides a sum by P.
"""
from __future__ import annotations

from functools import partial
from typing import List, Tuple

import torch

from repro_torch.core.hierarchical import DPMesh, all_gather
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_unflatten


def _flatten(tree):
    leaves = tree_leaves(tree)
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])
    return flat, (tree, [x.shape for x in leaves])


def _unflatten(flat, meta):
    like, shapes = meta
    out: List[torch.Tensor] = []
    off = 0
    for shape in shapes:
        n = shape.numel()
        out.append(flat[off:off + n].reshape(shape))
        off += n
    return tree_unflatten(like, out)


def flat_size(tree, mult: int) -> int:
    n = sum(x.numel() for x in tree_leaves(tree))
    return n + ((-n) % mult)


def _padded(grads, residual):
    flat, meta = _flatten(grads)
    npad = residual.shape[0] - flat.shape[0]
    return torch.cat([flat, flat.new_zeros(npad)]) + residual, meta, npad


def onebit_sync(grads, residual: torch.Tensor, *, mesh: DPMesh,
                axis: str = "data", block: int = 512,
                use_kernel: bool = True) -> Tuple[object, torch.Tensor]:
    """EF-signSGD sync.  residual: this rank's flat (N_pad,) f32."""
    flat, meta, npad = _padded(grads, residual)
    impl = "kernel" if use_kernel else "ref"
    packed, scales = ops.onebit_quantize(flat, block, impl=impl)
    local_hat = ops.onebit_dequantize(packed, scales, block, impl=impl)
    new_residual = flat - local_hat
    # exchange compressed payloads (uint8 + per-block scales on the wire)
    packed_all = all_gather(packed, mesh, axis)           # (P, N/8) u8
    scales_all = all_gather(scales, mesh, axis)           # (P, nb) f32
    deq = ops.onebit_dequantize(packed_all, scales_all, block, impl=impl)
    g_hat = deq.sum(dim=0) / mesh.shape[axis]
    n = flat.shape[0] - npad
    return _unflatten(g_hat[:n], meta), new_residual


def topk_sync(grads, residual: torch.Tensor, *, mesh: DPMesh,
              axis: str = "data", block: int = 2048, k: int = 32,
              use_kernel: bool = True) -> Tuple[object, torch.Tensor]:
    """Top-k sparsified sync (Eq. 11).  residual: flat (N_pad,) f32."""
    flat, meta, npad = _padded(grads, residual)
    # exactly k (value, index) pairs per block -> the wire payload (ties
    # beyond k fall back into the residual: error feedback keeps them)
    idx, vals, new_residual = ops.topk_select(
        flat, k, block, impl="kernel" if use_kernel else "ref")
    vals_all = all_gather(vals, mesh, axis)               # (P, nb, k)
    idx_all = all_gather(idx, mesh, axis)
    acc = flat.new_zeros((flat.shape[0] // block, block))
    for p in range(mesh.shape[axis]):
        acc.scatter_add_(-1, idx_all[p].long(), vals_all[p])
    g_hat = (acc / mesh.shape[axis]).reshape(-1)
    n = flat.shape[0] - npad
    return _unflatten(g_hat[:n], meta), new_residual


def make_compressed_sync(mode: str, *, mesh: DPMesh, axis: str = "data",
                         block: int = 512, k: int = 32,
                         use_kernel: bool = True):
    """Returns sync(grads, residual) -> (mean grads, new residual)."""
    if mode == "onebit":
        return partial(onebit_sync, mesh=mesh, axis=axis, block=block,
                       use_kernel=use_kernel)
    if mode == "topk":
        return partial(topk_sync, mesh=mesh, axis=axis, block=block, k=k,
                       use_kernel=use_kernel)
    raise ValueError(mode)
