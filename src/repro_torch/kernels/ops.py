"""Public entry points of the kernels (port of ``repro/kernels/ops.py``).

``impl="kernel"`` runs the kernel wrapper, which launches the CUDA kernel
for CUDA tensors and runs the plain version for CPU tensors; ``impl="ref"``
forces the plain version.  :func:`decode_attention` is the one decode entry
point keyed off a :class:`~repro_torch.cache_layout.CacheLayout`, over the
whole (dense | paged) x (16-bit | int8) x (ref | dense | flash) matrix.
The gradient-compression entry points take the flat gradient, as JAX's do;
so do the embedding gather / scatter-add and the fused AdamW update;
:func:`moe_router` takes the (tokens, experts) router logits and
:func:`moe_route` the (groups, tokens, experts) ones, and
:func:`wkv6_chunked` the RWKV-6 streams in the kernel's (B, H, T, hs)
layout.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    flash_decode_attention, flash_decode_attention_paged,
    flash_decode_attention_paged_quant, flash_decode_attention_quant)
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels import embedding_ops as _embed
from repro_torch.kernels import fused_adamw as _adamw
from repro_torch.kernels import grad_compress as _gc
from repro_torch.kernels import moe_router as _router
from repro_torch.kernels import topk_sparsify as _topk
from repro_torch.kernels import wkv6 as _wkv6


def _check_impl(impl: str) -> None:
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl {impl!r} (want kernel|ref)")


# -- flash attention ---------------------------------------------------------

def flash_attention_bhsd(q, k, v, *, causal=True, window=0,
                         softmax_scale=None, impl="kernel"):
    """Layout (B, H, S, D)."""
    _check_impl(impl)
    if impl == "ref":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softmax_scale=softmax_scale)
    return _flash(q, k, v, causal=causal, window=window,
                  softmax_scale=softmax_scale)


def flash_attention(q, k, v, *, causal=True, window=0, softmax_scale=None,
                    impl="kernel"):
    """Layout (B, S, H, D) -- the model-stack layout.  The kernel reads the
    transposed views through their strides; nothing is copied."""
    o = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window,
                             softmax_scale=softmax_scale, impl=impl)
    return o.transpose(1, 2)


# -- flash-decode attention ---------------------------------------------------

def decode_attention(q, cache, lengths, *, layout, softmax_scale=None,
                     q_lens=None):
    """THE decode-attention entry point, keyed off one CacheLayout.

    ``cache`` holds ``{"k", "v"}`` (16-bit) or ``{"k_q", "k_s", "v_q",
    "v_s"}`` (int8) as per-slot rows (B, S, Hk, D) or, for a paged layout,
    as pools (N, bs, Hk, D) plus ``"block_table"`` (B, nb).
    ``layout.impl`` selects the plain oracle (``ref``), the dense einsum
    over the (gathered) cache (``dense``) or the CUDA flash-decode kernel
    of the layout (``flash``); ``layout.window``/``layout.ring`` the masking
    variant (int8 takes full-cache masking only, as the kernels do);
    ``q_lens`` (B,) the live draft rows of a k-row verify."""
    if layout.quantized and (layout.window or layout.ring):
        raise ValueError("int8 decode supports full-cache masking only")
    table = cache["block_table"] if layout.paged else None

    def dense_view(x):
        return ref.paged_gather(x, table) if layout.paged else x

    if layout.quantized:
        args = (cache["k_q"], cache["k_s"], cache["v_q"], cache["v_s"])
        if layout.impl == "ref":
            return ref.decode_attention_quant(
                q, *(dense_view(a) for a in args), lengths,
                softmax_scale=softmax_scale, q_lens=q_lens)
        if layout.impl == "dense":
            from repro_torch.models import kvquant
            return kvquant.decode_attention_quant(
                q, *(dense_view(a) for a in args), lengths,
                softmax_scale=softmax_scale, impl="dense", q_lens=q_lens)
        if layout.paged:
            return flash_decode_attention_paged_quant(
                q, *args, table, lengths, softmax_scale=softmax_scale,
                q_lens=q_lens)
        return flash_decode_attention_quant(q, *args, lengths,
                                            softmax_scale=softmax_scale,
                                            q_lens=q_lens)
    kw = dict(window=layout.window, ring=layout.ring,
              softmax_scale=softmax_scale, q_lens=q_lens)
    if layout.impl == "ref":
        return ref.decode_attention(q, dense_view(cache["k"]),
                                    dense_view(cache["v"]), lengths, **kw)
    if layout.impl == "dense":
        from repro_torch.models import attention
        return attention.decode_attention(q, dense_view(cache["k"]),
                                          dense_view(cache["v"]), lengths,
                                          impl="dense", **kw)
    if layout.paged:
        return flash_decode_attention_paged(q, cache["k"], cache["v"], table,
                                            lengths, **kw)
    return flash_decode_attention(q, cache["k"], cache["v"], lengths, **kw)


def flash_decode(q, k_cache, v_cache, lengths, *, window=0, ring=False,
                 softmax_scale=None, impl="kernel", q_lens=None):
    """Decode over per-slot live cache prefixes.  q (B, Sq, H, D); caches
    (B, S, Hk, D); lengths (B,); q_lens (B,) live draft rows when Sq > 1."""
    _check_impl(impl)
    if impl == "ref":
        return ref.decode_attention(q, k_cache, v_cache, lengths,
                                    window=window, ring=ring,
                                    softmax_scale=softmax_scale,
                                    q_lens=q_lens)
    return flash_decode_attention(q, k_cache, v_cache, lengths,
                                  window=window, ring=ring,
                                  softmax_scale=softmax_scale, q_lens=q_lens)


def flash_decode_quant(q, k_q, k_s, v_q, v_s, lengths, *, softmax_scale=None,
                       impl="kernel", q_lens=None):
    """Int8 decode over per-slot live cache prefixes: values (B, S, Hk, D)
    int8, per-(position, head) f32 scales (B, S, Hk), dequantized in the
    kernel."""
    _check_impl(impl)
    if impl == "ref":
        return ref.decode_attention_quant(q, k_q, k_s, v_q, v_s, lengths,
                                          softmax_scale=softmax_scale,
                                          q_lens=q_lens)
    return flash_decode_attention_quant(q, k_q, k_s, v_q, v_s, lengths,
                                        softmax_scale=softmax_scale,
                                        q_lens=q_lens)


# -- MoE router ---------------------------------------------------------------

def moe_router(logits, k: int, impl="kernel"):
    """logits (T, E), E <= 128 -> (gates (T, k) f32, idx (T, k) int32,
    probs (T, E) f32): softmax, top-k with the first-occurrence tie-break,
    gates renormalized over the k."""
    _check_impl(impl)
    if impl == "ref":
        return ref.moe_router(logits, k)
    return _router.moe_router(logits, k)


def moe_route(logits, k: int, C: int, live=None, dtype=torch.float32,
              impl="kernel"):
    """logits (g, G, E), E <= 128, G <= 1024 -> ``ref.Route``: the router
    on every token, then per group the slot-major capacity places and the
    (g, G, E, C) dispatch and combine tensors in ``dtype``, the expert
    loads and the top-1 shares; ``live`` (g, G) takes dead tokens out of
    the queues."""
    _check_impl(impl)
    fn = ref.moe_route if impl == "ref" else _router.moe_route
    return fn(logits, k, C, live, dtype)


# -- chunked WKV6 -------------------------------------------------------------

def wkv6_chunked(r, k, v, w, u, chunk: int = 32, impl="kernel",
                 return_state: bool = False):
    """r, k, v, w (B, H, T, hs) -> (B, H, T, hs) in r's dtype; zero initial
    state, T % chunk == 0.  ``return_state`` also returns the final (B, H,
    hs, hs) f32 state.  ``impl="ref"`` is the sequential scan (the JAX
    package's oracle); ``impl="kernel"`` the chunked kernel."""
    _check_impl(impl)
    if impl == "ref":
        o, S = ref.wkv6_scan(r, k, v, w, u)
        o = o.to(r.dtype)
    else:
        o, S = _wkv6.wkv6_chunked(r, k, v, w, u, chunk=chunk)
    return (o, S) if return_state else o


# -- 1-bit compression -------------------------------------------------------

def onebit_quantize(g, block: int = 512, impl="kernel"):
    """Flat (N,) f32, N % (8 * block) == 0 -> (packed (N/8,) u8, scales
    (N / (8 * block),) f32)."""
    _check_impl(impl)
    g2d = g.reshape(8, g.shape[0] // 8)
    if impl == "ref":
        return ref.onebit_quantize(g2d, block)
    return _gc.onebit_quantize(g2d, block)


def onebit_dequantize(packed, scales, block: int = 512, impl="kernel"):
    """packed (M,) -> flat (8M,) f32; a batch (R, M) of payloads with
    scales (R, M / block) -> (R, 8M) in one launch."""
    _check_impl(impl)
    fn = ref.onebit_dequantize if impl == "ref" else _gc.onebit_dequantize
    g = fn(packed, scales, block)
    return g.reshape(packed.shape[:-1] + (8 * packed.shape[-1],))


# -- top-k sparsification ----------------------------------------------------

def topk_sparsify(g, k: int, block: int = 2048, impl="kernel"):
    """Flat (N,) f32 -> (kept (N,), residual (N,)); block-local top-k.
    ``impl="kernel"`` has the TPU kernel's distinct-magnitude threshold,
    ``impl="ref"`` the sort of ``kernels/ref.py`` (they differ only where
    magnitudes tie inside a block's top k)."""
    _check_impl(impl)
    N = g.shape[0]
    if N % block:
        raise ValueError(f"N={N} is not a multiple of block={block}")
    x2d = g.reshape(N // block, block)
    fn = ref.topk_sparsify if impl == "ref" else _topk.topk_sparsify
    kept, resid = fn(x2d, k)
    return kept.reshape(N), resid.reshape(N)


def topk_select(g, k: int, block: int = 2048, impl="kernel"):
    """Flat (N,) f32 -> (idx (N/block, k) int32, vals (N/block, k),
    resid_sent (N,)): each block's k largest magnitudes (largest first,
    ties to the lowest index), their signed values, and g minus them.  The
    top-k sync's payload; both impls give the same (the selection does
    not depend on the sparsifier's threshold)."""
    _check_impl(impl)
    N = g.shape[0]
    if N % block:
        raise ValueError(f"N={N} is not a multiple of block={block}")
    x2d = g.reshape(N // block, block)
    fn = ref.topk_select if impl == "ref" else _topk.topk_select
    idx, vals, resid = fn(x2d, k)
    return idx, vals, resid.reshape(N)


# -- embedding gather / scatter-add -------------------------------------------

def embedding_gather(table, ids, impl="kernel"):
    """table (V, D), ids (n,) -> (n, D) = table[ids] (ids in range)."""
    _check_impl(impl)
    if impl == "ref":
        return ref.gather_rows(table, ids)
    return _embed.gather_rows(table, ids)


def embedding_scatter_add(x, idx, n_rows: int, impl="kernel"):
    """x (n, D), idx (n,) -> (n_rows, D) segment sum (duplicates added in
    input order, exactly)."""
    _check_impl(impl)
    if impl == "ref":
        return ref.scatter_add_rows(x, idx, n_rows)
    return _embed.scatter_add_rows(x, idx, n_rows)


# -- fused AdamW -------------------------------------------------------------

def adamw_update(p, g, m, v, lr, bc1, bc2, *, b1=0.9, b2=0.95, eps=1e-8,
                 wd=0.1, impl="kernel"):
    """Flat (N,) f32 p, g, m, v -> (p', m', v').  ``lr``, ``bc1``, ``bc2``
    may be Python numbers or 0-d tensors; the kernel gets them, with the
    constants, as one (8,) f32 tensor on p's device."""
    _check_impl(impl)
    if impl == "ref":
        return ref.adamw_update(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                                wd=wd, bc1=bc1, bc2=bc2)
    return _adamw.adamw_update(p, g, m, v, _adamw.hyper(
        lr, bc1, bc2, b1=b1, b2=b2, eps=eps, wd=wd, device=p.device))
