"""Chunked WKV6: the wrapper of ``csrc/wkv6.cu``.

Port of the Pallas TPU kernel ``repro/kernels/wkv6.py``: the RWKV-6
time-mix recurrence over (B, H, T, hs) streams from a zero state, a chunk
of ``chunk`` tokens at a time; beyond the TPU kernel it also returns the
final (B, H, hs, hs) state, which the serving prefill needs.  The kernel's
design notes are at the top of the CUDA source: two launches a call (the
chunks in parallel, then the state carried across them), one when T <= 16.

CPU tensors go to the plain version (:func:`repro_torch.kernels.ref
.wkv6_chunked_state`, the chunked math of the model's plain path); CUDA
tensors launch the kernel or raise.  Float32 inputs are read through their
strides (the last one 1), not copied, and the output is laid out as r is:
the model's transposed (B, T, H, hs) views come back as such.  The wrapper
counts its calls in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_HS = 64          # head size: the (hs, hs) state in the kernel's tiles
MAX_CHUNK = 64       # the chunk of the plain version (the kernel's own tile
                     # is 16 or 32 tokens, see the source)


def workspace_floats(B: int, H: int, T: int) -> int:
    """Floats of the kernel's workspace when T spans more than one tile of
    L tokens: one record a tile (csrc ``wkv_record``) and the state
    entering each carry segment of 32 records but the first."""
    L = 16 if T <= 64 else 32
    nc = -(-T // L)
    if nc <= 1:
        return 0
    return B * H * (nc * (2 * L * 64 + 64 * 64 + 64)
                    + (-(-nc // 32) - 1) * 64 * 64)


def _launch(entry, r, k, v, w, u):
    """Run C entry ``entry`` on float32 r, k, v, w (B, H, T, hs) with last
    stride 1 and contiguous u: (o laid out as r, final state)."""
    B, H, T, hs = r.shape
    o = torch.empty_like(r)
    S = torch.empty((B, H, hs, hs), dtype=torch.float32, device=r.device)
    n_ws = workspace_floats(B, H, T)
    ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (r, k, v, w, o) for s in t.stride()[:3]))
    stream = (torch.cuda.current_stream(r.device).cuda_stream
              if r.device.type == "cuda" else None)
    err = entry(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), o.data_ptr(), S.data_ptr(), ws.data_ptr(),
                strides, n_ws, B, H, T, hs, stream)
    _build.check("wkv6_chunked", err)
    return o, S


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
    ins = [t if t.dtype == torch.float32 and t.stride(-1) == 1
           else t.to(torch.float32).contiguous() for t in (r, k, v, w)]
    u32 = u.to(torch.float32).contiguous()
    if r.device.type != "cuda" or any(t.device != r.device
                                      for t in (*ins, u32)):
        raise ValueError("wkv6_chunked: kernel inputs must be CUDA tensors "
                         "on one device")
    o, S = _launch(_build.entry("repro_wkv6_chunked"), *ins, u32)
    wkv6_chunked.launches += 1
    return o.to(r.dtype), S


wkv6_chunked.launches = 0      # wrapper calls that launched the kernel
