"""Block-local top-k sparsification and the top-k sync's selection: the
wrappers of ``csrc/topk_sparsify.cu``.

Port of the Pallas TPU kernel ``repro/kernels/topk_sparsify.py`` (paper
Eq. 11) with its semantics: per row, k rounds of max-and-mask give the
threshold t, the k-th largest *distinct* magnitude (or -1, keeping the
row, when it has fewer than k distinct magnitudes); kept = x where |x| >=
t, resid = x - kept.  The sort-based threshold of ``kernels/ref.py``
(magnitudes counted with repeats) is ``ops.topk_sparsify(impl="ref")``.
:func:`topk_select` is the same kernel's second entry point: the k
(index, value) pairs of each row that the top-k sync sends, and the
residual they leave.  The kernel's design notes are at the top of the
CUDA source.

CPU tensors go to the plain versions (:func:`repro_torch.kernels.ref
.topk_sparsify_rounds`, :func:`repro_torch.kernels.ref.topk_select`); CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_BLOCK = 4096       # 32 lanes x 32 float4 register slots (csrc)


def _checked(name, x2d, k):
    _build.refuse_grad(name, x2d)
    if k < 0:
        raise ValueError(f"{name}: k={k}")
    if x2d.device.type == "cpu":
        return False
    if x2d.shape[1] > MAX_BLOCK:
        raise ValueError(f"{name}: block {x2d.shape[1]} > {MAX_BLOCK}, the "
                         "longest row the kernel keeps in registers")
    _build.check_dense(name, (x2d, torch.float32))
    return True


def topk_sparsify(x2d, k: int):
    """x2d (nb, block) f32 -> (kept, resid), same shape."""
    if not _checked("topk_sparsify", x2d, k):
        return ref.topk_sparsify_rounds(x2d, k)
    nb, block = x2d.shape
    kept = torch.empty_like(x2d)
    resid = torch.empty_like(x2d)
    err = _build.entry("repro_topk_sparsify")(
        x2d.data_ptr(), kept.data_ptr(), resid.data_ptr(), nb, block, k,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check("topk_sparsify", err)
    topk_sparsify.launches += 1
    return kept, resid


def topk_select(x2d, k: int):
    """x2d (nb, block) f32, k <= block -> (idx (nb, k) int32, vals (nb, k)
    f32, resid_sent (nb, block) f32), as :func:`ref.topk_select`."""
    if k > x2d.shape[1]:
        raise ValueError(f"topk_select: k={k} > block {x2d.shape[1]}")
    if not _checked("topk_select", x2d, k):
        return ref.topk_select(x2d, k)
    nb, block = x2d.shape
    idx = torch.empty((nb, k), dtype=torch.int32, device=x2d.device)
    vals = torch.empty((nb, k), dtype=torch.float32, device=x2d.device)
    resid = torch.empty_like(x2d)
    err = _build.entry("repro_topk_select")(
        x2d.data_ptr(), idx.data_ptr(), vals.data_ptr(), resid.data_ptr(),
        nb, block, k, torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check("topk_select", err)
    topk_select.launches += 1
    return idx, vals, resid


topk_sparsify.launches = 0    # kernel launches since the last reset
topk_select.launches = 0
