"""Block-local top-k sparsification: the wrapper of
``csrc/topk_sparsify.cu``.

Port of the Pallas TPU kernel ``repro/kernels/topk_sparsify.py`` (paper
Eq. 11) with its semantics: per row, k rounds of max-and-mask give the
threshold t, the k-th largest *distinct* magnitude (or -1, keeping the
row, when it has fewer than k distinct magnitudes); kept = x where |x| >=
t, resid = x - kept.  The sort-based threshold of ``kernels/ref.py``
(magnitudes counted with repeats) is ``ops.topk_sparsify(impl="ref")``.
The kernel's design notes are at the top of the CUDA source.

CPU tensors go to the plain version (:func:`repro_torch.kernels.ref
.topk_sparsify_rounds`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_BLOCK = 4096       # 256 threads x 16 register slots (csrc)


def topk_sparsify(x2d, k: int):
    """x2d (nb, block) f32 -> (kept, resid), same shape."""
    _build.refuse_grad("topk_sparsify", x2d)
    nb, block = x2d.shape
    if k < 0:
        raise ValueError(f"topk_sparsify: k={k}")
    if x2d.device.type == "cpu":
        return ref.topk_sparsify_rounds(x2d, k)
    if block > MAX_BLOCK:
        raise ValueError(f"topk_sparsify: block {block} > {MAX_BLOCK}, the "
                         "longest row the kernel keeps in registers")
    _build.check_dense("topk_sparsify", (x2d, torch.float32))
    kept = torch.empty_like(x2d)
    resid = torch.empty_like(x2d)
    err = _build.entry("repro_topk_sparsify")(
        x2d.data_ptr(), kept.data_ptr(), resid.data_ptr(), nb, block, k,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check("topk_sparsify", err)
    topk_sparsify.launches += 1
    return kept, resid


topk_sparsify.launches = 0    # kernel launches since the last reset
