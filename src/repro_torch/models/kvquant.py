"""Int8 KV-cache quantization (port of ``repro/models/kvquant.py``).

Per-(position, head) symmetric int8: values int8 ``(..., S, Hk, D)``, scales
f32 ``(..., S, Hk)`` -- amax over the head dim over 127.  Half the cache
bytes of bf16 plus a scale per row.  Decode attention reads the int8 cache
directly (``impl="flash"``: the CUDA int8 flash-decode kernels, dense or
paged; ``impl="dense"``: one einsum with the scales folded in), so no
dequantized copy of the cache is ever made.

As in :mod:`repro_torch.models.transformer`, the caches are written in
place, by the one-token step and by its speculative k-row twin
(:func:`quant_decode_spec`).  The ``*_tree`` helpers of the generic int8
composition are not ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.cache_layout import CacheLayout
from repro_torch.models import layers
from repro_torch.models import transformer as tf

NEG_INF = -1e30


def quantize_kv(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) float -> (int8 values, f32 scales (...,)).  ``torch.round``
    rounds half to even, as ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale[..., None]).to(dtype)


def init_quant_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                     layers_: int, device=None) -> Dict:
    """Stacked per-layer quantized K/V cache."""
    dev = resolve_device(device)
    vals = (layers_, batch, max_len, n_kv, head_dim)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {"k_q": zeros(vals, torch.int8),
            "k_s": zeros(vals[:-1], torch.float32),
            "v_q": zeros(vals, torch.int8),
            "v_s": zeros(vals[:-1], torch.float32),
            "len": zeros((batch,), torch.int32)}


def cache_insert(cache_q, cache_s, pos, k_new):
    """Insert one token's K or V (B, Hk, D) at per-row positions, in place.
    A row whose ``pos`` is already past the cache writes nothing: JAX drops
    an out-of-range scatter, and free serving slots keep counting up."""
    B, S = cache_q.shape[:2]
    q, s = quantize_kv(k_new)
    rows = torch.arange(B, device=pos.device)
    slot = torch.clamp(pos, max=S - 1).long()
    keep = pos < S
    cache_q[rows, slot] = torch.where(keep[:, None, None], q,
                                      cache_q[rows, slot])
    cache_s[rows, slot] = torch.where(keep[:, None], s, cache_s[rows, slot])
    return cache_q, cache_s


def cache_insert_paged(pool_q, pool_s, phys, off, k_new):
    """Paged twin of :func:`cache_insert`: pools (N, bs, Hk, D) / (N, bs,
    Hk); ``phys``/``off`` (B,) physical block and in-block row per slot
    (write-table resolved: unowned slots target the null block 0)."""
    q, s = quantize_kv(k_new)
    pool_q[phys, off] = q
    pool_s[phys, off] = s
    return pool_q, pool_s


def init_model_quant_cache(cfg, batch: int, max_len: int,
                           device=None) -> Dict:
    """Quantized decode cache shaped for an ArchConfig (uniform family)."""
    tf.check_ported(cfg)
    return init_quant_cache(batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                            cfg.num_layers, device=device)


def init_paged_quant_cache(cfg, n_slots: int, max_len: int, *,
                           num_blocks: int, block_size: int,
                           device=None) -> Dict:
    """Paged int8 decode cache (uniform family): pooled int8 values
    ``(L, num_blocks, block_size, Hk, D)`` + pooled f32 scales
    ``(L, num_blocks, block_size, Hk)``, with the read/write block tables
    of :func:`transformer.init_paged_slots`."""
    tf.check_ported(cfg)
    if max_len % block_size:
        raise ValueError(f"max_len={max_len} not a multiple of "
                         f"block_size={block_size}")
    dev = resolve_device(device)
    vals = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
            cfg.head_dim)
    tbl = (n_slots, max_len // block_size)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {"k_q": zeros(vals, torch.int8),
            "k_s": zeros(vals[:-1], torch.float32),
            "v_q": zeros(vals, torch.int8),
            "v_s": zeros(vals[:-1], torch.float32),
            "block_table": zeros(tbl, torch.int32),
            "write_table": zeros(tbl, torch.int32),
            "len": zeros((n_slots,), torch.int32)}


def quant_decode_step(cfg, params, cache: Dict, tokens, ctx=None):
    """One decode step against the int8 cache -- the quantized twin of
    ``transformer.decode_step``.  tokens (B, 1) -> (logits (B, 1, V), the
    cache with ``len + 1``).  Each layer's new K/V row is quantized on
    insert; attention reads the int8 cache through
    :func:`decode_attention_quant`, or, for a paged cache (``"block_table"``
    present), inserts through the write table and attends through the read
    table via the layout dispatch."""
    tf.check_ported(cfg)
    if ctx is None:
        ctx = tf.ModelCtx()
    from repro_torch.kernels import ops
    B = tokens.shape[0]
    pos = cache["len"]                          # (B,) per-row lengths
    h = layers.embed_tokens(params["embed"], tokens)
    paged = "block_table" in cache
    if paged:
        bs, nb = cache["k_q"].shape[2], cache["block_table"].shape[1]
        rows = torch.arange(B, device=pos.device)
        # clamped as JAX clamps an out-of-range gather (free slots count on)
        blk = torch.clamp(pos // bs, max=nb - 1).long()
        phys = cache["write_table"][rows, blk].long()
        off = (pos % bs).long()
        layout = CacheLayout(kind="paged", kv_bits=8, impl=ctx.decode_impl,
                             block_size=bs)
    for i, blk_p in enumerate(tf._layers(params, cfg)):
        k_q, k_s, v_q, v_s = (cache[n][i] for n in ("k_q", "k_s", "v_q",
                                                     "v_s"))
        hn = layers.apply_norm(cfg, blk_p["attn"]["norm"], h)
        q, k, v = tf._qkv(cfg, blk_p["attn"], hn, pos[:, None])
        if paged:
            cache_insert_paged(k_q, k_s, phys, off, k[:, 0])
            cache_insert_paged(v_q, v_s, phys, off, v[:, 0])
            o = ops.decode_attention(
                q, {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s,
                    "block_table": cache["block_table"]},
                torch.clamp(pos + 1, max=nb * bs), layout=layout)
        else:
            cache_insert(k_q, k_s, pos, k[:, 0])
            cache_insert(v_q, v_s, pos, v[:, 0])
            # unclamped, as in the JAX package: the dense path masks
            # pos < len, the kernel clamps its live range at S
            o = decode_attention_quant(q, k_q, k_s, v_q, v_s, pos + 1,
                                       impl=ctx.decode_impl)
        h = h + o.reshape(B, 1, cfg.q_dim) @ blk_p["attn"]["wo"]
        h = h + tf.ffn_apply(cfg, blk_p["ffn"], h, ctx)[0]
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return layers.lm_logits(cfg, params, h), dict(cache, len=pos + 1)


def quant_decode_spec(cfg, params, cache: Dict, tokens, ctx=None,
                      q_lens=None):
    """Speculative k-row twin of :func:`quant_decode_step` (dense or paged
    int8 cache).  tokens (B, k) -> (logits (B, k, V), accepts (B,), the
    cache with ``len += accepts``).  The k rows' K/V are quantized and land
    at ``len + j`` before attention (dense: :func:`transformer.spec_rows`,
    which keeps JAX's drop of rows past the end; paged: through the write
    table, rows past the virtual space into the null block); draft row
    ``j`` attends with effective length ``len + 1 + j`` and ``q_lens``
    caps the live rows.  Rejected rows leave int8 garbage at dead
    positions only, as in the 16-bit linear caches."""
    tf.check_spec(cfg)
    tf.check_ported(cfg)
    if ctx is None:
        ctx = tf.ModelCtx()
    from repro_torch.kernels import ops
    B, Sq = tokens.shape
    if q_lens is None:
        q_lens = torch.full((B,), Sq, dtype=torch.int32, device=tokens.device)
    q_lens = q_lens.to(torch.int32)
    lens = cache["len"]
    pos = tf.spec_positions(lens, Sq)
    h = layers.embed_tokens(params["embed"], tokens)
    paged = "block_table" in cache
    if paged:
        bs, nb = cache["k_q"].shape[2], cache["block_table"].shape[1]
        S = nb * bs
        phys, off = tf.paged_spec_targets(lens, Sq, cache["write_table"], bs)
        layout = CacheLayout(kind="paged", kv_bits=8, impl=ctx.decode_impl,
                             block_size=bs)
    else:
        S = cache["k_q"].shape[2]
        tgt, src = tf.spec_rows(lens, Sq, S)
    for i, blk_p in enumerate(tf._layers(params, cfg)):
        k_q, k_s, v_q, v_s = (cache[n][i] for n in ("k_q", "k_s", "v_q",
                                                     "v_s"))
        hn = layers.apply_norm(cfg, blk_p["attn"]["norm"], h)
        q, k, v = tf._qkv(cfg, blk_p["attn"], hn, pos)
        new = (*quantize_kv(k), *quantize_kv(v))
        if paged:
            for pool, rows in zip((k_q, k_s, v_q, v_s), new):
                pool[phys, off] = rows
            o = ops.decode_attention(
                q, {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s,
                    "block_table": cache["block_table"]},
                torch.clamp(lens + 1, max=S), layout=layout, q_lens=q_lens)
        else:
            for rows_c, rows in zip((k_q, k_s, v_q, v_s), new):
                tf.write_spec_rows(rows_c, tgt, src, rows)
            # unclamped, as in the JAX package (see quant_decode_step)
            o = decode_attention_quant(q, k_q, k_s, v_q, v_s, lens + 1,
                                       impl=ctx.decode_impl, q_lens=q_lens)
        h = h + o.reshape(B, Sq, cfg.q_dim) @ blk_p["attn"]["wo"]
        h = h + tf.ffn_apply(cfg, blk_p["ffn"], h, ctx)[0]
    h = layers.apply_norm(cfg, params["final_norm"], h)
    logits = layers.lm_logits(cfg, params, h)
    accepts = tf.verify_greedy(tokens, logits, q_lens)
    return logits, accepts, dict(cache, len=lens + accepts)


def quant_prefill_kv(cfg, params, batch: Dict, ctx=None, true_len=None):
    """Full-sequence prefill forward returning quantized per-layer K/V:
    (logits (B, S, V), (k_q, k_s, v_q, v_s)) with values (L, B, S, Hk, D)
    and scales (L, B, S, Hk).  Prefill attention runs through
    ``ctx.attn_impl`` (the flash-attention kernel under ``"flash"``).

    ``true_len`` masks right-padding out of MoE routing, as the 16-bit
    prefill does (:func:`transformer.forward_hidden`).  The JAX package's
    ``quant_prefill_kv`` takes no ``true_len``, so there pad tokens route
    and can take a real token's expert place when the capacity is tight;
    here they never do (``ROADMAP.md``, section 3)."""
    if ctx is None:
        ctx = tf.ModelCtx()
    logits, _, (k, v) = tf.forward(cfg, params, batch, ctx, collect_kv=True,
                                   true_len=true_len)
    k_q, k_s = quantize_kv(k)
    v_q, v_s = quantize_kv(v)
    return logits, (k_q, k_s, v_q, v_s)


def decode_attention_quant(q, k_q, k_s, v_q, v_s, lengths,
                           softmax_scale=None, impl="dense", q_lens=None):
    """Decode against an int8 cache.  q (B, Sq, H, D); k_q/v_q (B, S, Hk, D)
    int8; k_s/v_s (B, S, Hk).  Draft row ``j`` attends with effective
    length ``lengths + j``; ``q_lens`` (B,) caps live rows.  ``impl``:
    ``"dense"`` is one einsum over the whole cache with the scales folded
    in (k_s after QK, v_s into the probabilities); ``"flash"`` is the CUDA
    int8 flash-decode kernel, which reads only the live range.  Empty slots
    produce exact zeros on both."""
    if impl == "flash":
        from repro_torch.kernels import ops
        return ops.flash_decode_quant(q, k_q, k_s, v_q, v_s, lengths,
                                      softmax_scale=softmax_scale,
                                      q_lens=q_lens)
    if impl != "dense":
        raise ValueError(f"decode impl {impl!r} (want dense|flash)")
    B, Sq, H, D = q.shape
    S, Hk = k_q.shape[1], k_q.shape[2]
    G = H // Hk
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q_lens is None:
        q_lens = torch.full((B,), Sq, dtype=torch.int32, device=q.device)
    qg = q.reshape(B, Sq, Hk, G, D)
    s = torch.einsum("bjhgd,bkhd->bhjgk", qg.float(), k_q.float())
    s = s * k_s.transpose(1, 2)[:, :, None, None, :] * scale
    pos_k = torch.arange(S, device=q.device)[None, None, :]
    rows = torch.arange(Sq, device=q.device)[None, :]
    eff = (lengths[:, None] + rows)[:, :, None]
    valid = pos_k < eff
    valid &= (rows < q_lens[:, None])[:, :, None]
    valid = valid[:, None, :, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))           # len==0 -> 0
    pv = torch.einsum("bhjgk,bkhd->bjhgd",
                      p * v_s.transpose(1, 2)[:, :, None, None, :],
                      v_q.float())
    return pv.reshape(B, Sq, H, D).to(q.dtype)
