"""Chunked WKV6: the wrapper of ``csrc/wkv6.cu``.

Port of the Pallas TPU kernel ``repro/kernels/wkv6.py``: the RWKV-6
time-mix recurrence over (B, H, T, hs) streams from a zero state, a chunk
of ``chunk`` tokens at a time; beyond the TPU kernel it also returns the
final (B, H, hs, hs) state, which the serving prefill needs.  The kernel's
design notes are at the top of the CUDA source.

CPU tensors go to the plain version (:func:`repro_torch.kernels.ref
.wkv6_chunked_state`, the chunked math of the model's plain path); CUDA
tensors launch the kernel or raise.  The wrapper counts its launches in
``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_HS = 64          # head size: the (hs, hs) state and seven (chunk, hs + 1)
MAX_CHUNK = 64       # tiles in one block's shared memory (csrc)


def wkv6_chunked(r, k, v, w, u, *, chunk: int = 32):
    """r, k, v, w (B, H, T, hs), w in (0, 1]; u (H, hs) -> (o (B, H, T, hs)
    in r's dtype, final state (B, H, hs, hs) f32); zero initial state,
    T % chunk == 0, float32 arithmetic."""
    _build.refuse_grad("wkv6_chunked", r, k, v, w, u)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        shapes = [tuple(t.shape) for t in (r, k, v, w)]
        raise ValueError("wkv6_chunked: r, k, v, w must share one (B, H, T, "
                         f"hs) shape, got {shapes}")
    B, H, T, hs = r.shape
    if tuple(u.shape) != (H, hs):
        raise ValueError(f"wkv6_chunked: u {tuple(u.shape)} (want ({H}, "
                         f"{hs}))")
    if not 1 <= chunk <= MAX_CHUNK or T % chunk:
        raise ValueError(f"wkv6_chunked: chunk={chunk} must divide T={T} and "
                         f"lie in [1, {MAX_CHUNK}]")
    if hs > MAX_HS:
        raise ValueError(f"wkv6_chunked: head size {hs} > {MAX_HS}, the "
                         "widest state the kernel keeps in shared memory")
    if r.device.type == "cpu":
        o, S = ref.wkv6_chunked_state(r, k, v, w, u, chunk)
        return o.to(r.dtype), S
    ins = [t.to(torch.float32).contiguous() for t in (r, k, v, w, u)]
    _build.check_dense("wkv6_chunked", *((t, torch.float32) for t in ins))
    o = torch.empty((B, H, T, hs), dtype=torch.float32, device=r.device)
    S = torch.empty((B, H, hs, hs), dtype=torch.float32, device=r.device)
    err = _build.entry("repro_wkv6_chunked")(
        *(t.data_ptr() for t in ins), o.data_ptr(), S.data_ptr(), B, H, T,
        hs, chunk, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check("wkv6_chunked", err)
    wkv6_chunked.launches += 1
    return o.to(r.dtype), S


wkv6_chunked.launches = 0      # kernel launches since the last reset
