"""Length-aware flash-decode: the wrappers of ``csrc/flash_decode.cu``.

Ports of the Pallas TPU kernels of ``repro/kernels/decode_attention.py``:
one decode step attends each slot's query rows against the slot's live KV
prefix only (k-row speculative verify through ``q_lens``; exact zeros for
empty slots and dead rows), over four cache layouts:

* :func:`flash_decode_attention` -- dense 16-bit rows (full, sliding-window
  and ring masks);
* :func:`flash_decode_attention_quant` -- dense int8 values with
  per-(position, head) f32 scales, dequantized in the kernel (full mask);
* :func:`flash_decode_attention_paged` -- a shared block pool read through
  per-slot block tables (full, window and ring masks over virtual
  positions);
* :func:`flash_decode_attention_paged_quant` -- int8 through the tables.

The four share one CUDA body, split over the KV range: one block per
(64-key span, KV head, slot) scores every query row of the KV head against
its span and writes a float32 partial (m, l, acc) to a workspace, and a
second kernel merges a slot's live spans into o.  Its design notes are at
the top of the CUDA source.

Layouts: q (B, Sq, H, D); dense caches (B, S, Hk, D), scales (B, S, Hk);
pools (N, bs, Hk, D), scale pools (N, bs, Hk), tables (B, nb) -- all read
through their strides (a layer's view of the stacked cache needs no copy);
lengths, q_lens (B,) integers.

CPU tensors go to the plain versions (:mod:`repro_torch.kernels.ref`);
CUDA tensors launch the kernel or raise.  There are no backward kernels,
so a call that autograd would record raises, on the CPU too.  The TPU kernels'
``block_k``/``interpret`` arguments have no counterpart: the CUDA kernel's
span is fixed at :data:`SPLIT_KEYS` keys and its live range is found at key
granularity.  Each wrapper counts its calls in ``.launches`` (one a call,
though a call runs two CUDA kernels).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_NO_STRIDES = (0, 0, 0)
# keys a block of the split kernel takes (FD_SPLIT in csrc/flash_decode.cu,
# which refuses any other value): sizes the partials' workspace
SPLIT_KEYS = 64


def _scale_and_check(q, Hk: int, softmax_scale, window: int, ring: bool):
    D, H = q.shape[3], q.shape[2]
    if H % Hk:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hk}")
    if ring and window <= 0:
        raise ValueError("ring=True needs window > 0")
    return softmax_scale if softmax_scale is not None else D ** -0.5


def _launch(fn_name: str, q, k, v, lengths, q_lens, scale, *, S: int,
            k_scale=None, v_scale=None, tables=None, bs: int = 0,
            window: int = 0, ring: bool = False):
    """Launch one decode entry point of ``csrc/flash_decode.cu`` on CUDA
    tensors (its split and merge kernels); returns the (B, Sq, H, D)
    output in q's dtype."""
    scales = () if k_scale is None else (k_scale, v_scale)
    _build.check_inputs(fn_name, q, k, v, scales=scales)
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    dev = q.device
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if q_lens is not None:
        q_lens = q_lens.to(device=dev, dtype=torch.int32).contiguous()
    if tables is not None:
        tables = tables.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    if B == 0 or Sq == 0:
        return out
    # one float32 partial (acc, then m and l) per (slot, KV head, span, row)
    n_split = -(-(S * bs if tables is not None else S) // SPLIT_KEYS)
    ws = torch.empty(B * Hk * n_split * Sq * (H // Hk) * (D + 2),
                     dtype=torch.float32, device=dev)
    strides = (*q.stride()[:3], *out.stride()[:3], *k.stride()[:3],
               *v.stride()[:3],
               *(k_scale.stride() if k_scale is not None else _NO_STRIDES),
               *(v_scale.stride() if v_scale is not None else _NO_STRIDES),
               tables.stride(0) if tables is not None else 0)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = _build.entry(fn_name)(
        q.data_ptr(), out.data_ptr(), k.data_ptr(), v.data_ptr(),
        ptr(k_scale), ptr(v_scale), lengths.data_ptr(), ptr(q_lens),
        ptr(tables), int(q.dtype == torch.bfloat16), B, Sq, H, Hk, S, bs, D,
        (ctypes.c_longlong * len(strides))(*strides), float(scale),
        int(window), int(ring), ws.data_ptr(), SPLIT_KEYS,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(fn_name, err)
    return out


def flash_decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                           ring: bool = False, softmax_scale=None,
                           q_lens=None):
    """Dense 16-bit caches.  Returns (B, Sq, H, D) in q's dtype.  Draft row
    ``j`` attends with effective length ``lengths + j``; ``q_lens=None``
    makes every row live."""
    _build.refuse_grad("flash_decode_attention", q, k_cache, v_cache)
    scale = _scale_and_check(q, k_cache.shape[2], softmax_scale, window,
                             ring)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths,
                                    window=window, ring=ring,
                                    softmax_scale=scale, q_lens=q_lens)
    out = _launch("repro_flash_decode", q, k_cache, v_cache, lengths, q_lens,
                  scale, S=k_cache.shape[1], window=window, ring=ring)
    flash_decode_attention.launches += 1
    return out


def flash_decode_attention_quant(q, k_q, k_s, v_q, v_s, lengths, *,
                                 softmax_scale=None, q_lens=None):
    """Dense int8 cache: k_q/v_q (B, S, Hk, D) int8, k_s/v_s (B, S, Hk) f32
    per-(position, head) scales; full-cache mask.  ``lengths`` may pass S
    (free serving slots keep counting): the kernel clamps the live range."""
    _build.refuse_grad("flash_decode_attention_quant", q, k_q, k_s, v_q, v_s)
    scale = _scale_and_check(q, k_q.shape[2], softmax_scale, 0, False)
    if q.device.type == "cpu":
        return ref.decode_attention_quant(q, k_q, k_s, v_q, v_s, lengths,
                                          softmax_scale=scale, q_lens=q_lens)
    out = _launch("repro_flash_decode_quant", q, k_q, v_q, lengths, q_lens,
                  scale, S=k_q.shape[1], k_scale=k_s, v_scale=v_s)
    flash_decode_attention_quant.launches += 1
    return out


def flash_decode_attention_paged(q, k_pool, v_pool, block_tables, lengths, *,
                                 window: int = 0, ring: bool = False,
                                 softmax_scale=None, q_lens=None):
    """Paged 16-bit cache: pools (N, bs, Hk, D) shared across slots,
    block_tables (B, nb) physical block ids; virtual position ``p`` of slot
    ``b`` is row ``p % bs`` of block ``block_tables[b, p // bs]``, over a
    virtual space of ``nb * bs`` positions."""
    _build.refuse_grad("flash_decode_attention_paged", q, k_pool, v_pool)
    scale = _scale_and_check(q, k_pool.shape[2], softmax_scale, window, ring)
    if q.device.type == "cpu":
        return ref.decode_attention_paged(q, k_pool, v_pool, block_tables,
                                          lengths, window=window, ring=ring,
                                          softmax_scale=scale, q_lens=q_lens)
    out = _launch("repro_flash_decode_paged", q, k_pool, v_pool, lengths,
                  q_lens, scale, S=block_tables.shape[1], tables=block_tables,
                  bs=k_pool.shape[1], window=window, ring=ring)
    flash_decode_attention_paged.launches += 1
    return out


def flash_decode_attention_paged_quant(q, k_q_pool, k_s_pool, v_q_pool,
                                       v_s_pool, block_tables, lengths, *,
                                       softmax_scale=None, q_lens=None):
    """Paged int8 cache: value pools (N, bs, Hk, D) int8, scale pools
    (N, bs, Hk) f32, block_tables (B, nb); full-cache mask."""
    _build.refuse_grad("flash_decode_attention_paged_quant", q, k_q_pool,
                       k_s_pool, v_q_pool, v_s_pool)
    scale = _scale_and_check(q, k_q_pool.shape[2], softmax_scale, 0, False)
    if q.device.type == "cpu":
        return ref.decode_attention_paged_quant(
            q, k_q_pool, k_s_pool, v_q_pool, v_s_pool, block_tables, lengths,
            softmax_scale=scale, q_lens=q_lens)
    out = _launch("repro_flash_decode_paged_quant", q, k_q_pool, v_q_pool,
                  lengths, q_lens, scale, S=block_tables.shape[1],
                  k_scale=k_s_pool, v_scale=v_s_pool, tables=block_tables,
                  bs=k_q_pool.shape[1])
    flash_decode_attention_paged_quant.launches += 1
    return out


# kernel launches since the last reset, one counter per entry point
flash_decode_attention.launches = 0
flash_decode_attention_quant.launches = 0
flash_decode_attention_paged.launches = 0
flash_decode_attention_paged_quant.launches = 0
