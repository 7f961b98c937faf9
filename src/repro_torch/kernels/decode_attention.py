"""Length-aware flash-decode: the wrapper of ``csrc/flash_decode.cu``.

Port of the Pallas TPU kernel ``flash_decode_attention``
(``repro/kernels/decode_attention.py``): one decode step attends each slot's
query rows against the slot's live KV prefix only (full, sliding-window and
ring masks; k-row speculative verify through ``q_lens``; exact zeros for
empty slots and dead rows).  The kernel's design notes, including where it
departs from the TPU kernel's structure, are at the top of the CUDA source.

Layout q (B, Sq, H, D); caches (B, S, Hk, D), read through their strides
(a layer's view of the stacked cache needs no copy); lengths and q_lens
(B,) integers on the caches' device.

CPU tensors go to the plain version (:func:`repro_torch.kernels.ref
.decode_attention`); CUDA tensors launch the kernel or raise.  The TPU
kernel's ``block_k``/``interpret`` arguments have no counterpart: the CUDA
kernel loops over the live range at key granularity.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def flash_decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                           ring: bool = False, softmax_scale=None,
                           q_lens=None):
    """Returns (B, Sq, H, D) in q's dtype.  Draft row ``j`` attends with
    effective length ``lengths + j``; ``q_lens=None`` makes every row
    live."""
    B, Sq, H, D = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    if H % Hk:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hk}")
    if ring and window <= 0:
        raise ValueError("ring=True needs window > 0")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths,
                                    window=window, ring=ring,
                                    softmax_scale=scale, q_lens=q_lens)
    _build.check_inputs("flash_decode", q, k_cache, v_cache)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if q_lens is not None:
        q_lens = q_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    fn = _build.entry("flash_decode")
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             out.data_ptr(), lengths.data_ptr(),
             q_lens.data_ptr() if q_lens is not None else None,
             int(q.dtype == torch.bfloat16), B, Sq, H, Hk, S, D,
             *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
             *out.stride()[:3], float(scale), int(window), int(ring),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_decode", err)
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0    # kernel launches since the last reset
