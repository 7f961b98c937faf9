"""Attention: GQA with causal / sliding-window masking (port of
``repro/models/attention.py``).

Implementations of one math contract, selected by ``impl``:

* ``"naive"``   -- materialized (Sq, Sk) scores; test oracle.
* ``"chunked"`` -- online softmax over KV chunks (the JAX ``lax.scan`` as a
  Python loop); the plain path the serving engine runs by default.  With
  ``flash_vjp`` (training, whole sequences) it runs through
  :func:`flash_chunked_attention`, whose hand-written backward recomputes
  each chunk's scores instead of keeping them (the JAX ``_flash`` custom
  VJP, in plain PyTorch as the JAX backward is jnp).
* ``"flash"``   -- the CUDA prefill kernel
  (:mod:`repro_torch.kernels.flash_attention`).  It stands for the JAX
  package's ``"pallas"`` value of ``ModelCtx.attn_impl``: same math, the
  TPU kernel's CUDA port.

Decode attention (:func:`decode_attention`) has ``"dense"`` (one einsum
over the padded cache) and ``"flash"`` (the CUDA flash-decode kernel, which
reads only each slot's live KV range), as in the JAX package.

Layouts: q (B, Sq, H, D); k/v (B, Sk, Hk, D).  GQA is computed group-wise
without materializing repeated KV heads.  Scores and softmax are float32;
the probabilities are cast to the value dtype before the PV product, as
the JAX code does (its einsums take low-precision operands with float32
accumulation).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _mask(pos_q, pos_k, *, causal: bool, window: int, kv_len=None):
    """Boolean mask (..., Sq, Sk): True = attend."""
    pq = pos_q[..., :, None]
    pk = pos_k[..., None, :]
    m = torch.ones(torch.broadcast_shapes(pq.shape, pk.shape),
                   dtype=torch.bool, device=pos_q.device)
    if causal:
        m = m & (pk <= pq)
    if window > 0:
        m = m & (pk > pq - window)
    if kv_len is not None:
        m = m & (pk < kv_len[..., None, None])
    return m


def _scores(qg, k, scale):
    """(B,Sq,Hk,G,D) x (B,Sk,Hk,D) -> (B,Hk,G,Sq,Sk) float32 scores."""
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale


def _pv(p, v):
    """(B,Hk,G,Sq,Sk) probabilities x (B,Sk,Hk,D) -> (B,Sq,Hk,G,D) f32."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_len=None, softmax_scale=None):
    """Reference implementation. q:(B,Sq,H,D) k,v:(B,Sk,Hk,D)."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    scores = _scores(q.reshape(B, Sq, Hk, G, D), k, scale)
    pos_q = q_offset + torch.arange(Sq, device=q.device)
    pos_k = torch.arange(Sk, device=q.device)
    m = _mask(pos_q, pos_k, causal=causal, window=window, kv_len=kv_len)
    m = m[None, None, None] if m.ndim == 2 else m[:, None, None]
    scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return _pv(p, v).reshape(B, Sq, H, D).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      kv_len=None, chunk=1024, softmax_scale=None):
    """Flash-style attention: a loop over KV chunks with running (m, l, acc).

    Memory high-water per step is O(Sq * chunk) instead of O(Sq * Sk)."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    chunk = min(chunk, Sk)
    if Sk % chunk:                                   # pad KV to chunk multiple
        pad = chunk - Sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = torch.full((B,), Sk, dtype=torch.int32, device=q.device)
        Sk = Sk + pad
    scale = softmax_scale if softmax_scale is not None else D ** -0.5

    qg = q.reshape(B, Sq, Hk, G, D)
    pos_q = q_offset + torch.arange(Sq, device=q.device)
    m_run = torch.full((B, Hk, G, Sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, Hk, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hk, G, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, chunk):
        kb, vb = k[:, k0:k0 + chunk], v[:, k0:k0 + chunk]
        pos_k = k0 + torch.arange(chunk, device=q.device)
        s = _scores(qg, kb, scale)
        msk = _mask(pos_q, pos_k, causal=causal, window=window, kv_len=kv_len)
        msk = msk[None, None, None] if msk.ndim == 2 else msk[:, None, None]
        s = torch.where(msk, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        # fully masked rows (m_new == NEG_INF): exp(0)=1, re-masked to 0
        p = torch.exp(s - m_new[..., None])
        p = torch.where(msk, p, torch.zeros_like(p))
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + _pv(p, vb)
        m_run = m_new
    l_f = torch.clamp(l_run, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return (acc / l_f).reshape(B, Sq, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Flash-style backward (port of ``_chunked_fwd_lse`` / ``_flash_fwd`` /
# ``_flash_bwd``): autograd through the chunked loop keeps every chunk's
# probabilities; this backward recomputes s/p per chunk and keeps only
# (q, k, v, out, lse).
# ---------------------------------------------------------------------------

def _chunked_fwd_lse(q, k, v, *, causal, window, chunk, scale):
    """The chunked forward (``Sk % chunk == 0``, no ``kv_len``); also
    returns lse (B, Hk, G, Sq)."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q.reshape(B, Sq, Hk, G, D)
    pos_q = torch.arange(Sq, device=q.device)
    m_run = torch.full((B, Hk, G, Sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, Hk, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hk, G, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, chunk):
        kb, vb = k[:, k0:k0 + chunk], v[:, k0:k0 + chunk]
        pos_k = k0 + torch.arange(chunk, device=q.device)
        msk = _mask(pos_q, pos_k, causal=causal, window=window)[None, None,
                                                                None]
        s = torch.where(msk, _scores(qg, kb, scale), NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + _pv(p, vb)
        m_run = m_new
    l_run = torch.clamp(l_run, min=1e-30)
    out = (acc / l_run.permute(0, 3, 1, 2)[..., None]).to(q.dtype)
    return out.reshape(B, Sq, H, D), m_run + torch.log(l_run)


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, scale):
        out, lse = _chunked_fwd_lse(q, k, v, causal=causal, window=window,
                                    chunk=chunk, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.knobs = (causal, window, chunk, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, chunk, scale = ctx.knobs
        B, Sq, H, D = q.shape
        Sk, Hk = k.shape[1], k.shape[2]
        G = H // Hk
        qg = q.reshape(B, Sq, Hk, G, D)
        dog = do.reshape(B, Sq, Hk, G, D)
        # delta = rowsum(do * out): (B, Hk, G, Sq) f32
        delta = torch.einsum("bqhgd,bqhgd->bhgq", dog.float(),
                             out.reshape(B, Sq, Hk, G, D).float())
        pos_q = torch.arange(Sq, device=q.device)
        dq = torch.zeros((B, Sq, Hk, G, D), dtype=torch.float32,
                         device=q.device)
        dks, dvs = [], []
        for k0 in range(0, Sk, chunk):
            kb, vb = k[:, k0:k0 + chunk], v[:, k0:k0 + chunk]
            pos_k = k0 + torch.arange(chunk, device=q.device)
            msk = _mask(pos_q, pos_k, causal=causal,
                        window=window)[None, None, None]
            p = torch.where(msk, torch.exp(_scores(qg, kb, scale)
                                           - lse[..., None]), 0.0)
            pb = p.to(vb.dtype).float()
            dvs.append(torch.einsum("bhgqk,bqhgd->bkhd", pb,
                                    dog.float()).to(v.dtype))
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dog.float(), vb.float())
            dsb = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
            dks.append(torch.einsum("bhgqk,bqhgd->bkhd", dsb,
                                    qg.float()).to(k.dtype))
            dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", dsb, kb.float())
        return (dq.reshape(B, Sq, H, D).to(q.dtype), torch.cat(dks, dim=1),
                torch.cat(dvs, dim=1), None, None, None, None)


def flash_chunked_attention(q, k, v, *, causal=True, window=0, chunk=1024,
                            softmax_scale=None):
    """chunked_attention with the hand-written flash backward.  No kv_len
    masking (the training path); a chunk that does not divide Sk falls
    back to gcd(chunk, Sk), as in the JAX package."""
    D = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    chunk = min(chunk, k.shape[1])
    if k.shape[1] % chunk:
        chunk = math.gcd(chunk, k.shape[1])
    return _Flash.apply(q, k, v, causal, window, chunk, scale)


def decode_attention(q, k_cache, v_cache, lengths, *, window=0, ring=False,
                     softmax_scale=None, impl="dense", q_lens=None):
    """Decode attention. q:(B,Sq,H,D); caches:(B,S,Hk,D); lengths:(B,) valid
    len for query row 0.  Sq > 1 is speculative k-row verification: draft
    row ``j`` attends with effective length ``lengths + j`` and rows
    ``>= q_lens`` produce exactly-zero outputs.  ``window``/``ring`` select
    the sliding band or the wraparound ring; empty slots (``len == 0``)
    produce exactly-zero outputs.

    ``impl``: ``"dense"`` streams the whole padded cache through one
    einsum; ``"flash"`` is the CUDA flash-decode kernel
    (:mod:`repro_torch.kernels.decode_attention`), which reads only each
    slot's live KV range."""
    if impl == "flash":
        from repro_torch.kernels import ops
        return ops.flash_decode(q, k_cache, v_cache, lengths, window=window,
                                ring=ring, softmax_scale=softmax_scale,
                                q_lens=q_lens)
    if impl != "dense":
        raise ValueError(f"decode impl {impl!r} (want dense|flash)")
    B, Sq, H, D = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q_lens is None:
        q_lens = torch.full((B,), Sq, dtype=torch.int32, device=q.device)
    qg = q.reshape(B, Sq, Hk, G, D)
    s = torch.einsum("bjhgd,bkhd->bhjgk", qg.float(), k_cache.float()) * scale
    pos_k = torch.arange(S, device=q.device)[None, None, :]
    rows = torch.arange(Sq, device=q.device)[None, :]
    eff = (lengths[:, None] + rows)[:, :, None]
    if ring and window > 0:
        valid = pos_k < torch.clamp(eff, max=S)
        valid &= torch.remainder(eff - 1 - pos_k, S) < window
    else:
        valid = pos_k < eff
        if window > 0:
            valid &= pos_k > (eff - 1 - window)
    valid &= (rows < q_lens[:, None])[:, :, None]
    valid = valid[:, None, :, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))           # len==0 -> 0
    out = torch.einsum("bhjgk,bkhd->bjhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0, q_offset=0, kv_len=None,
              impl="chunked", chunk=1024, softmax_scale=None,
              flash_vjp=False):
    """Public dispatch used by the transformer stack."""
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len,
                               softmax_scale=softmax_scale)
    if impl == "chunked":
        if flash_vjp and q_offset == 0 and kv_len is None \
                and q.shape[1] == k.shape[1]:
            return flash_chunked_attention(q, k, v, causal=causal,
                                           window=window, chunk=chunk,
                                           softmax_scale=softmax_scale)
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len,
                                 chunk=chunk, softmax_scale=softmax_scale)
    if impl == "flash":
        if q_offset or kv_len is not None:
            raise NotImplementedError(
                "the flash prefill kernel takes whole prompts (q_offset=0, "
                "no kv_len), as the TPU kernel does")
        from repro_torch.kernels import ops
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   softmax_scale=softmax_scale)
    raise ValueError(f"attention impl {impl!r} (want naive|chunked|flash)")
