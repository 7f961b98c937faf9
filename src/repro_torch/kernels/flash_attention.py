"""Prefill flash attention: the wrapper of ``csrc/flash_attention.cu``.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``: blocked
online-softmax attention, forward only, causal and/or sliding-window mask,
GQA without repeating K/V.  Layout q (B, H, Sq, D); k, v (B, Hk, Sk, D), any
strides with a contiguous last dim (the ops layer hands in transposed views
of the model's (B, S, H, D) tensors).  bfloat16 runs on the tensor cores
(``mma.sync``): a block takes 16 query rows of one head and up to 4 warps
split their key range in 16-key tiles, merging at the end; float32 keeps
FMAs (one warp a query row), since TF32 would miss float32's tolerance.
The design notes are at the top of the CUDA source.

CPU tensors go to the plain version (:func:`repro_torch.kernels.ref
.flash_attention`); CUDA tensors launch the kernel or raise.  There is no
backward kernel yet, so a call that autograd would record raises, on the
CPU too.  The TPU
kernel's ``block_q``/``block_k``/``interpret`` arguments have no
counterpart: the CUDA kernel fixes its own tiling.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def flash_attention(q, k, v, *, causal=True, window=0, softmax_scale=None):
    """Returns (B, H, Sq, D) in q's dtype, laid out like q."""
    _build.refuse_grad("flash_attention", q, k, v)
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    if H % Hk:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hk}")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softmax_scale=scale)
    _build.check_inputs("flash_attention", q, k, v)
    out = torch.empty_like(q)          # keeps q's strides
    if Sq == 0:
        return out
    fn = _build.entry("repro_flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), B, H, Hk, Sq, Sk, D,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], float(scale), int(causal), int(window),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0    # kernel launches since the last reset
