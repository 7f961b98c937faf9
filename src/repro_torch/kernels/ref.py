"""Plain PyTorch versions of the CUDA kernels (ports of the oracles in
``repro/kernels/ref.py``).

Each kernel wrapper runs its plain version when handed CPU tensors, and the
GPU smoke run compares every kernel with it on the card.  All arithmetic is
float32 whatever the input type; outputs come back in q's dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# flash attention (layout: q (B,H,Sq,D); k,v (B,Hk,Sk,D))
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal=True, window=0, softmax_scale=None,
                    kv_len=None):
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    kr = k.repeat_interleave(G, dim=1).float()
    vr = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    pos_q = torch.arange(Sq, device=q.device)[:, None]
    pos_k = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= pos_k <= pos_q
    if window > 0:
        m &= pos_k > pos_q - window
    if kv_len is not None:
        m &= pos_k < kv_len
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# flash-decode attention (layout: q (B,Sq,H,D); caches (B,S,Hk,D)): per-slot
# live prefixes, sliding-window band or ring wraparound masking.  Draft row
# ``j`` attends with effective length ``lengths + j``; rows ``>= q_lens``
# and empty slots (len == 0) produce exactly-zero outputs.
# ---------------------------------------------------------------------------

def _decode_mask(lengths, S: int, window: int, ring: bool):
    """(B, S) bool: which cache rows a slot's single query may attend."""
    pos = torch.arange(S, device=lengths.device)[None, :]
    lengths = lengths[:, None]
    if ring and window > 0:
        valid = pos < torch.clamp(lengths, max=S)
        valid &= torch.remainder(lengths - 1 - pos, S) < window
    else:
        valid = pos < lengths
        if window > 0:
            valid &= pos > lengths - 1 - window
    return valid


def _decode_mask_rows(lengths, q_lens, Sq: int, S: int, window: int,
                      ring: bool):
    """(B, Sq, S) bool: rows draft row ``j`` of each slot may attend.

    Row ``j``'s effective length is ``lengths + j``; rows ``>= q_lens``
    (speculation padding) attend nothing.  ``torch.remainder`` is the floor
    modulo of ``jnp.mod``: the ring offset ``eff - 1 - pos`` can be
    negative."""
    dev = lengths.device
    pos = torch.arange(S, device=dev)[None, None, :]
    rows = torch.arange(Sq, device=dev)[None, :]
    eff = (lengths[:, None] + rows)[:, :, None]
    if ring and window > 0:
        valid = pos < torch.clamp(eff, max=S)
        valid &= torch.remainder(eff - 1 - pos, S) < window
    else:
        valid = pos < eff
        if window > 0:
            valid &= pos > eff - 1 - window
    valid &= (rows < q_lens[:, None])[:, :, None]
    return valid


def decode_attention(q, k, v, lengths, *, window=0, ring=False,
                     softmax_scale=None, q_lens=None):
    B, Sq, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    lengths = lengths.to(torch.int64)
    if q_lens is None:
        q_lens = torch.full((B,), Sq, dtype=torch.int64, device=q.device)
    qg = q.reshape(B, Sq, Hk, G, D).float()
    s = torch.einsum("bjhgd,bkhd->bhjgk", qg, k.float()) * scale
    valid = _decode_mask_rows(lengths, q_lens.to(torch.int64), Sq, S,
                              window, ring)[:, None, :, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))           # len==0 -> 0
    out = torch.einsum("bhjgk,bkhd->bjhgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_quant(q, k_q, k_s, v_q, v_s, lengths, *,
                           softmax_scale=None, q_lens=None):
    """Int8 cache: values (B, S, Hk, D) int8, scales (B, S, Hk) f32; full
    mask.  ``k_s`` folds into the scores after QK; ``v_s`` into the
    probabilities after the softmax, before PV."""
    B, Sq, H, D = q.shape
    S, Hk = k_q.shape[1], k_q.shape[2]
    G = H // Hk
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    lengths = lengths.to(torch.int64)
    if q_lens is None:
        q_lens = torch.full((B,), Sq, dtype=torch.int64, device=q.device)
    qg = q.reshape(B, Sq, Hk, G, D).float()
    s = torch.einsum("bjhgd,bkhd->bhjgk", qg, k_q.float())
    s = s * k_s.transpose(1, 2)[:, :, None, None, :] * scale
    valid = _decode_mask_rows(lengths, q_lens.to(torch.int64), Sq, S, 0,
                              False)[:, None, :, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))
    pv = torch.einsum("bhjgk,bkhd->bjhgd",
                      p * v_s.transpose(1, 2)[:, :, None, None, :],
                      v_q.float())
    return pv.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_splits(q, k, v, lengths, *, span: int, window=0,
                            ring=False, softmax_scale=None, q_lens=None,
                            k_s=None, v_s=None):
    """The CUDA decode kernels' split-and-merge, step for step: what
    :func:`decode_attention` (``k_s``/``v_s`` None) or
    :func:`decode_attention_quant` (int8 ``k``/``v`` with their scales)
    computes, taken as float32 partials over spans of ``span`` keys and
    merged.  A span sees only the slot's live keys [lo, hi) (hi =
    min(lengths + q_lens - 1, S); lo = lengths - window for a linear
    window band, else 0), each row's masked ones at probability 0; its
    partial is the row's max score m (NEG_INF when none is valid), the sum
    l of exp(s - m) and acc = sum of exp(s - m) * v_s * v.  The merge reads
    the partials of the live spans only, rescales each by exp(m - max m),
    and divides by the rescaled l floored at 1e-30: an empty span adds
    nothing, a row with no live key is exactly 0.  (Past 8 live spans the
    CUDA merge folds them in 8 at a time into a running max: the same sums
    up to rounding.)  The serving path does not run it; the tests hold it
    to the plain versions."""
    B, Sq, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    dev = q.device
    lengths = lengths.to(torch.int64)
    q_lens = (torch.full((B,), Sq, dtype=torch.int64, device=dev)
              if q_lens is None else q_lens.to(torch.int64))
    n = -(-S // span)
    pad = n * span - S

    def spans(x, fill):             # (B, S, ...) -> (B, n, span, ...)
        x = torch.cat([x, x.new_full((B, pad) + tuple(x.shape[2:]), fill)], 1)
        return x.reshape((B, n, span) + tuple(x.shape[2:]))

    hi = torch.clamp(torch.minimum(lengths + q_lens - 1,
                                   torch.tensor(S, device=dev)), min=0)
    lo = (torch.clamp(lengths - window, min=0) if window > 0 and not ring
          else torch.zeros_like(lengths))
    pos = torch.arange(S, device=dev)[None, :]
    staged = (pos >= lo[:, None]) & (pos < hi[:, None])          # (B, S)
    valid = (_decode_mask_rows(lengths, q_lens, Sq, S, window, ring)
             & staged[:, None, :])                               # (B, Sq, S)
    valid = spans(valid.transpose(1, 2), False)                  # (B,n,sp,Sq)
    qg = q.reshape(B, Sq, Hk, G, D).float()
    s = torch.einsum("bjhgd,bnkhd->bhjgnk", qg, spans(k.float(), 0.0))
    if k_s is not None:
        s = s * spans(k_s.float(), 0.0).permute(0, 3, 1, 2)[:, :, None, None]
    s = s * scale
    mask = valid.permute(0, 3, 1, 2)[:, None, :, None]       # (B,1,Sq,1,n,sp)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)                                # (B,Hk,Sq,G,n)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = torch.sum(p, dim=-1)
    if v_s is not None:
        p = p * spans(v_s.float(), 0.0).permute(0, 3, 1, 2)[:, :, None, None]
    acc = torch.einsum("bhjgnk,bnkhd->bhjgnd", p, spans(v.float(), 0.0))
    # the merge: the live spans [lo // span, ceil(hi / span)) only
    sp = torch.arange(n, device=dev)[None, :]
    live = ((sp >= (lo // span)[:, None]) & (sp < (-(-hi // span))[:, None])
            & (lo < hi)[:, None])[:, None, None, None, :]    # (B,1,1,1,n)
    m = torch.where(live, m, torch.full_like(m, NEG_INF))
    mx = torch.amax(m, dim=-1, keepdim=True)
    c = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
    lsum = torch.sum(l * c, dim=-1)
    out = torch.sum(acc * c[..., None], dim=-2) / torch.clamp(
        lsum, min=1e-30)[..., None]                          # (B,Hk,Sq,G,D)
    return out.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# paged layouts: a shared pool (N, bs, ...) + per-slot block tables (B, nb)
# ---------------------------------------------------------------------------

def paged_gather(pool, table):
    """The slot-contiguous view a paged cache virtualizes: pool (N, bs, ...)
    + table (B, nb) -> (B, nb * bs, ...).  Dead entries gather the null
    block's rows, which every consumer masks by length."""
    B, nb = table.shape
    bs = pool.shape[1]
    return pool[table.reshape(-1).long()].reshape(
        (B, nb * bs) + tuple(pool.shape[2:]))


def decode_attention_paged(q, k_pool, v_pool, block_tables, lengths, *,
                           window=0, ring=False, softmax_scale=None,
                           q_lens=None):
    """Gather the pool blocks into the dense layout, then attend."""
    return decode_attention(q, paged_gather(k_pool, block_tables),
                            paged_gather(v_pool, block_tables), lengths,
                            window=window, ring=ring,
                            softmax_scale=softmax_scale, q_lens=q_lens)


def decode_attention_paged_quant(q, k_q_pool, k_s_pool, v_q_pool, v_s_pool,
                                 block_tables, lengths, *,
                                 softmax_scale=None, q_lens=None):
    return decode_attention_quant(
        q, paged_gather(k_q_pool, block_tables),
        paged_gather(k_s_pool, block_tables),
        paged_gather(v_q_pool, block_tables),
        paged_gather(v_s_pool, block_tables), lengths,
        softmax_scale=softmax_scale, q_lens=q_lens)


# ---------------------------------------------------------------------------
# MoE router: softmax + top-k (first-occurrence argmax tie-break)
# ---------------------------------------------------------------------------

def moe_router(logits, k: int):
    """logits (T, E) -> (gates (T, k) f32, idx (T, k) int32, probs (T, E)
    f32): k rounds of max-and-mask, each taking the lowest index among
    equal maxima, then the gates renormalized over the k."""
    probs = torch.softmax(logits.float(), dim=-1)
    E = probs.shape[-1]
    iota = torch.arange(E, device=probs.device)
    tmp = probs
    gates, idxs = [], []
    for _ in range(k):
        m = torch.amax(tmp, dim=-1)
        is_max = tmp == m[:, None]
        idx = torch.amin(torch.where(is_max, iota, E), dim=-1)
        gates.append(m)
        idxs.append(idx)
        tmp = torch.where(iota[None] == idx[:, None],
                          torch.full_like(tmp, float("-inf")), tmp)
    gates = torch.stack(gates, -1)
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    return gates, torch.stack(idxs, -1).to(torch.int32), probs


# ---------------------------------------------------------------------------
# MoE route: the router, then each (token, slot)'s place in its expert's
# capacity-C queue and the one-hot dispatch / combine tensors
# (repro/models/moe.py, moe_ffn between the router and the expert products)
# ---------------------------------------------------------------------------

class Route(NamedTuple):
    dispatch: torch.Tensor   # (g, G, E, C) model dtype: 1 where kept
    combine: torch.Tensor    # (g, G, E, C) model dtype: the kept gate
    gates: torch.Tensor      # (g, G, k) f32, renormalized over the k
    idx: torch.Tensor        # (g, G, k) expert ids
    probs: torch.Tensor      # (g, G, E) f32 softmax
    place: torch.Tensor      # (g, G, k) int32 queue place (0 for dead
    #                          tokens); kept where place < C
    top1: torch.Tensor       # (E,) f32 share of the g * G tokens whose first
    #                          choice is e (live tokens only)
    load: torch.Tensor       # (E,) f32 live (token, slot) pairs per expert


def _one_hot(idx, n: int) -> torch.Tensor:
    """float32 one-hot over a new last dim of size n (any integer dtype)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_dispatch(gates, idx, probs, C: int, live=None, dtype=torch.float32):
    """Routing (gates, idx (g, G, k), probs (g, G, E)) -> :class:`Route`:
    the reference's capacity dispatch.  Places are counted slot-major
    within a group (every token's slot 0 before any token's slot 1), dead
    tokens (``live`` (g, G) 0) take none, and places >= C are dropped."""
    g, G, k = idx.shape
    E = probs.shape[-1]
    onehot = _one_hot(idx, E)                                    # (g,G,k,E)
    if live is not None:
        # dead (pad) tokens leave the expert queues before positions are
        # assigned: real tokens' capacity slots are pad-independent
        onehot = onehot * live.reshape(g, G).float()[..., None, None]
    # position of each (token, slot) within its expert queue, per group
    flat = onehot.transpose(1, 2).reshape(g, k * G, E)           # slot-major
    pos = torch.cumsum(flat, dim=1) - flat                       # (g,kG,E)
    pos = pos.reshape(g, k, G, E).transpose(1, 2)                # (g,G,k,E)
    pos_in_e = torch.sum(pos * onehot, dim=-1)                   # (g,G,k)
    keep = pos_in_e < C                                  # capacity drop
    place = pos_in_e.to(torch.int32)
    pos_in_e = torch.where(keep, pos_in_e, 0).to(torch.int64)
    gates_k = gates * keep
    poshot = _one_hot(pos_in_e, C) * keep[..., None]             # (g,G,k,C)
    # dispatch/combine without materializing the k-dim outer product
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot, poshot).to(dtype)
    combine = torch.einsum("gtke,gtkc->gtec", onehot * gates_k[..., None],
                           poshot).to(dtype)
    return Route(dispatch, combine, gates, idx, probs, place,
                 torch.mean(onehot[..., 0, :], dim=(0, 1)),
                 torch.sum(onehot, dim=(0, 1, 2)))


def moe_route(logits, k: int, C: int, live=None, dtype=torch.float32):
    """logits (g, G, E) -> :class:`Route`: :func:`moe_router` on every
    token, then :func:`moe_dispatch`."""
    g, G, E = logits.shape
    gates, idx, probs = moe_router(logits.reshape(-1, E), k)
    return moe_dispatch(gates.reshape(g, G, k), idx.reshape(g, G, k),
                        probs.reshape(g, G, E), C, live, dtype)


# ---------------------------------------------------------------------------
# 1-bit gradient compression (paper Eq. 10).  Layout: the flat gradient as
# (8, M); bit j of packed[c] is the sign of g2d[j, c] (x >= 0 packs 1); one
# float32 mean |g| scale per (8, block) tile of columns.
# ---------------------------------------------------------------------------

def onebit_quantize(g2d, block: int):
    """g2d (8, M) f32 -> (packed (M,) uint8, scales (M / block,) f32)."""
    _, M = g2d.shape
    if M % block:
        raise ValueError(f"M={M} is not a multiple of block={block}")
    bits = (g2d >= 0).to(torch.int32)
    weights = (2 ** torch.arange(8, dtype=torch.int32,
                                 device=g2d.device))[:, None]
    packed = torch.sum(bits * weights, dim=0).to(torch.uint8)
    scales = torch.mean(torch.abs(g2d.reshape(8, M // block, block)),
                        dim=(0, 2)).to(torch.float32)
    return packed, scales


def onebit_dequantize(packed, scales, block: int):
    """packed (..., M) uint8, scales (..., M / block) -> (..., 8, M) f32:
    +scale where the bit is set, -scale where it is not."""
    j = torch.arange(8, dtype=torch.int32, device=packed.device)[:, None]
    bits = (packed.to(torch.int32)[..., None, :] >> j) & 1
    signs = 2.0 * bits.to(torch.float32) - 1.0
    return signs * torch.repeat_interleave(scales, block, dim=-1)[..., None, :]


# ---------------------------------------------------------------------------
# block-local top-k sparsification (paper Eq. 11): keep |x| >= t per row,
# residual = x - kept.  Two thresholds t, as in the JAX package:
# ---------------------------------------------------------------------------

def topk_sparsify(x2d, k: int):
    """``kernels/ref.py``'s (what JAX's ``impl="ref"`` runs): t is the k-th
    largest magnitude of the row counted with repeats (a sort)."""
    a = torch.abs(x2d)
    t = torch.sort(a, dim=-1).values[:, -k][:, None]
    kept = torch.where(a >= t, x2d, torch.zeros_like(x2d))
    return kept, x2d - kept


def topk_sparsify_rounds(x2d, k: int):
    """The TPU kernel's, and the CUDA kernel's: k rounds of "m = row max,
    mask every magnitude >= m to -1"; t is the last m, the k-th largest
    *distinct* magnitude, or -1 (keep the row) when the row has fewer than
    k distinct magnitudes."""
    a = torch.abs(x2d)
    tmp = a.clone()
    t = torch.full((x2d.shape[0], 1), float("inf"), dtype=a.dtype,
                   device=a.device)
    for _ in range(k):
        t = torch.amax(tmp, dim=-1, keepdim=True)
        tmp = torch.where(tmp >= t, torch.full_like(tmp, -1.0), tmp)
    kept = torch.where(a >= t, x2d, torch.zeros_like(x2d))
    return kept, x2d - kept


def topk_select(x2d, k: int):
    """The top-k sync's payload: (idx (nb, k) int32, vals (nb, k),
    resid_sent (nb, block)).  idx are the k largest |x| of each row,
    largest first, ties to the lowest index (``lax.top_k``'s order); vals
    the signed values there; resid_sent = x minus those values scattered
    back.  The JAX sync picks them from |kept| of either threshold above,
    which holds every one of them, so picking from |x| gives the same.
    Magnitudes are non-negative floats, whose bit patterns order like the
    values, so one int64 key per element (bits high, reversed index low)
    is unique and ``torch.topk`` over it has no ties to break."""
    block = x2d.shape[-1]
    bits = torch.abs(x2d).view(torch.int32).to(torch.int64)
    rev = block - 1 - torch.arange(block, device=x2d.device)
    idx = torch.topk((bits << 32) | rev, k, dim=-1).indices
    vals = torch.gather(x2d, -1, idx)
    sent = torch.zeros_like(x2d).scatter_(-1, idx, vals)
    return idx.to(torch.int32), vals, x2d - sent


# ---------------------------------------------------------------------------
# embedding gather / segment-sum scatter-add (the dedup-lookup pair)
# ---------------------------------------------------------------------------

def gather_rows(table, ids):
    """table (V, D), ids (n,) -> (n, D) = table[ids]."""
    return table[ids.long()]


def scatter_add_rows(x, idx, n_rows: int):
    """x (n, D), idx (n,) -> (n_rows, D) with out[idx[i]] += x[i] from
    zeros (``jnp.zeros(...).at[idx].add(x)``), each id's rows added in
    input order.  Two PyTorch calls keep that order: on the CPU
    ``index_add_`` loops over idx (a large ``index_put_`` accumulates with
    parallel atomics there); on CUDA the accumulating ``index_put_``
    stably sorts idx and adds each id's rows one after another
    (``index_add_`` uses atomics unless deterministic algorithms are
    on)."""
    out = torch.zeros((n_rows, x.shape[-1]), dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        return out.index_add_(0, idx.long(), x)
    return out.index_put_((idx.long(),), x, accumulate=True)


# ---------------------------------------------------------------------------
# fused AdamW update
# ---------------------------------------------------------------------------

def adamw_update(p, g, m, v, *, lr, b1, b2, eps, wd, bc1, bc2):
    """bc1/bc2 are the bias corrections 1 - b^t (precomputed).  The
    hyperparameters may be Python numbers or 0-d f32 tensors."""
    m1 = b1 * m + (1 - b1) * g
    v1 = b2 * v + (1 - b2) * torch.square(g)
    mh = m1 / bc1
    vh = v1 / bc2
    p1 = p - lr * (mh / (torch.sqrt(vh) + eps) + wd * p)
    return p1, m1, v1


# ---------------------------------------------------------------------------
# chunked WKV6 (layout (B, H, T, hs); float32 arithmetic, zero or given
# initial state)
# ---------------------------------------------------------------------------

def wkv6_scan(r, k, v, w, u):
    """The sequential recurrence from a zero state:
    ``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ``,
    ``o_t = r_t (S_{t-1} + diag(u) k_t v_tᵀ)``.  r, k, v, w (B, H, T, hs),
    u (H, hs) -> (o (B, H, T, hs) f32, final S (B, H, hs, hs) f32)."""
    B, H, T, hs = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uu = u.float()[..., None]                            # (H, hs, 1)
    S = r.new_zeros((B, H, hs, hs))
    out = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        out.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], S + uu * kv))
        S = w[:, :, t, :, None] * S + kv
    return torch.stack(out, dim=2), S


def wkv6_chunked(r, k, v, w, u):
    """``repro/kernels/ref.py``'s oracle: the sequential scan's output in
    r's dtype."""
    return wkv6_scan(r, k, v, w, u)[0].to(r.dtype)


def wkv6_chunked_state(r, k, v, w, u, chunk: int, S0=None):
    """The chunked recurrence of ``repro/models/ssm._wkv6_chunked`` (the
    model's plain path and the CUDA kernel's plain version), in the kernel's
    layout.  r, k, v, w (B, H, T, hs) with T % chunk == 0, u (H, hs), S0
    (B, H, hs, hs) or None for zeros -> (o f32, final S f32).

    Per chunk of C tokens, with ``cum_t = sum_{s<=t} log w_s`` (<= 0):
    ``o_t = sum_{s<t} (r_t . exp(cum_{t-1} - cum_s) k_s) v_s
    + (r_t * exp(cum_{t-1})) S + (r_t . u k_t) v_t`` and
    ``S' = exp(cum_C) S + sum_s (k_s exp(cum_C - cum_s)) v_sᵀ``; every
    exponent is <= 0, so nothing overflows."""
    B, H, T, hs = r.shape
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    nc = T // chunk

    def split(t):                                        # (nc, B, H, C, hs)
        return t.float().reshape(B, H, nc, chunk, hs).permute(2, 0, 1, 3, 4)

    rc, kc, vc, wc = map(split, (r, k, v, w))
    uu = u.float()[None, :, None, :]                     # (1, H, 1, hs)
    S = (r.new_zeros((B, H, hs, hs), dtype=torch.float32) if S0 is None
         else S0.float())
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=r.device).tril(-1)[..., None]     # s < t
    outs = []
    for rt, kt, vt, wt in zip(rc, kc, vc, wc):           # (B, H, C, hs)
        # 1e-30: a subnormal floor may flush to zero -> log(0)
        lw = torch.log(torch.clamp(wt, min=1e-30))
        cum = torch.cumsum(lw, dim=2)
        cum_prev = cum - lw
        cum_c = cum[:, :, -1:]
        expo = cum_prev[:, :, :, None] - cum[:, :, None]  # (B,H,t,s,hs)
        dec = torch.where(causal, torch.exp(torch.clamp(expo, max=0.0)),
                          0.0)
        m = torch.einsum("bhtc,bhtsc,bhsc->bhts", rt, dec, kt)
        o = torch.einsum("bhts,bhsv->bhtv", m, vt)
        o = o + torch.einsum("bhtc,bhcv->bhtv", rt * torch.exp(cum_prev), S)
        o = o + torch.sum(rt * kt * uu, dim=-1, keepdim=True) * vt
        k2 = kt * torch.exp(cum_c - cum)
        S = torch.exp(cum_c)[:, :, 0, :, None] * S \
            + torch.einsum("bhsc,bhsv->bhcv", k2, vt)
        outs.append(o)
    return torch.cat(outs, dim=2), S
