"""The uniform decoder-only stack and the attention-free rwkv6 stack (port
of those two families of ``repro/models/transformer.py``): forward,
per-slot prefill, one-token decode and, for the uniform family, the
speculative k-row verify (:func:`decode_spec`) over a stacked KV cache or
stacked recurrent states.

Parameters are a plain dict keyed like the JAX pytree; the per-layer
leaves under ``params["blocks"]`` stay stacked ``(L, ...)`` and the layers
run as a Python loop (the JAX ``lax.scan``).

**The KV cache is updated in place.**  JAX writes a new cache array each
step (``k_cache.at[...].set``); here :func:`attn_decode`,
:func:`attn_decode_paged`, their k-row twins and :func:`prefill_into_slot`
write the new rows into the stacked ``(L, n_slots, S, Hk, D)`` tensors or
``(L, N, bs, Hk, D)`` pools they were given, and return the same
tensors.  Only ``cache["len"]`` is a new tensor after a decode step.

:func:`loss_fn` and :func:`chunked_ce` give the training loss; the
backward is PyTorch's autograd through the ``chunked`` (or ``naive``)
attention path, or the flash backward of ``ModelCtx.flash_vjp``, since the
CUDA attention kernels have no backward yet.  ``ModelCtx.remat``
recomputes each layer in the backward (``torch.utils.checkpoint``, the JAX
``jax.checkpoint`` on the layer body), and ``ModelCtx.tp``, the hooks of a
sharding plan (:class:`repro_torch.core.sharding.TPHooks`), runs the
forward and the loss under Megatron tensor parallelism, sequence
parallelism, expert parallelism (the MoE archs) and the global loss mean
of the hybrid train step, for the uniform and rwkv6 families.

The pipeline's stage functions (:func:`pp_partition_params`,
:func:`make_stage_fn`, :func:`make_last_fn` and the slicing around them)
cut the stacked layers at stage bounds for the pipelined train step
(:mod:`repro_torch.core.pipeline`); they cover the dense uniform family
(:func:`check_stage_slicing`).

The rwkv6 family (:mod:`repro_torch.models.ssm`) keeps per layer a
(B, H, hs, hs) WKV state and two token-shift rows in ``cache["states"]``,
written in place by the prefill and the decode step like the KV cache.

This port covers the uniform family -- RecLLM, and the MoE archs with
qk-norm (:mod:`repro_torch.models.moe`) -- with dense and paged caches, and
the rwkv6 family: M-RoPE, learned positions, the other families (the
ring caches of gemma's speculative decode among them) and chunked
prefill raise ``NotImplementedError``; they are queued in
``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.cache_layout import CacheLayout
from repro_torch.config import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, moe, ssm
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Runtime knobs threaded through the stack (not part of params)."""
    attn_impl: str = "chunked"       # naive | chunked | flash (CUDA kernel)
    attn_chunk: int = 1024
    decode_impl: str = "dense"       # dense | flash (CUDA flash-decode)
    use_kernels: bool = False        # MoE route, rwkv6 WKV: CUDA kernels
    moe_group: int = 256
    moe_capacity_factor: float = 1.25
    remat: bool = False              # recompute each layer in the backward
    flash_vjp: bool = False          # flash backward (dp_heavy / no TP)
    tp: Optional[Any] = None         # core.sharding.TPHooks under a plan


def family(cfg: ArchConfig) -> str:
    if cfg.ssm_type == "rwkv6":
        return "rwkv6"
    if cfg.ssm_type == "mamba":
        return "jamba"
    if cfg.local_global_pattern > 0:
        return "gemma"
    if cfg.encoder_layers > 0:
        return "whisper"
    return "uniform"


# Families whose decode state is a pure KV cache (rejected draft rows can
# be abandoned); rwkv6 carries recurrent per-token state that cannot rewind
SPEC_FAMILIES = ("uniform", "gemma", "whisper")


def check_ported(cfg: ArchConfig) -> None:
    """Raise for every architecture feature the port does not cover."""
    fam = family(cfg)
    missing = [what for what, bad in (
        (f"family {fam!r}", fam not in ("uniform", "rwkv6")),
        (f"pos_type {cfg.pos_type!r}", cfg.pos_type not in ("rope", "none")),
    ) if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port "
            "serves the uniform and rwkv6 families; see ROADMAP.md)")


def _layer(blocks: Dict, i: int) -> Dict:
    """Layer ``i``'s parameter views out of the stacked ``(L, ...)`` tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _layers(params: Dict, cfg: ArchConfig) -> List[Dict]:
    return [_layer(params["blocks"], i) for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Attention and FFN blocks
# ---------------------------------------------------------------------------

def _qkv(cfg: ArchConfig, p: Dict, h, positions, tp=None):
    """q, k, v on all heads, or, under ``tp``, on this rank's q heads and
    the kv heads they read."""
    B, S, _ = h.shape
    wk, wv = (p["wk"], p["wv"]) if tp is None else tp.kv_weights(p["wk"],
                                                                 p["wv"])
    q = (h @ p["wq"]).reshape(B, S, -1, cfg.head_dim)
    k = (h @ wk).reshape(B, S, -1, cfg.head_dim)
    v = (h @ wv).reshape(B, S, -1, cfg.head_dim)
    if cfg.qk_norm and "q_norm" in p:
        qn, kn = p["q_norm"], p["k_norm"]
        if tp is not None:
            qn, kn = tp.copy(qn), tp.copy(kn)
        q = layers.rms_norm_simple(q, qn)
        k = layers.rms_norm_simple(k, kn)
    q = layers.position_embedding(cfg, q, positions)
    k = layers.position_embedding(cfg, k, positions)
    return q, k, v


def attn_apply(cfg: ArchConfig, p: Dict, x, positions, ctx: ModelCtx,
               *, return_kv: bool = False):
    """Full-sequence (train/prefill) self-attention residual branch."""
    tp = ctx.tp
    h = layers.apply_norm(cfg, p["norm"] if tp is None else tp.norm(p["norm"]),
                          x)
    if tp is not None:
        h = tp.enter(h)
    q, k, v = _qkv(cfg, p, h, positions, tp)
    o = attn_lib.attention(q, k, v, causal=True, impl=ctx.attn_impl,
                           chunk=ctx.attn_chunk, flash_vjp=ctx.flash_vjp)
    out = o.reshape(h.shape[0], h.shape[1], -1) @ p["wo"]
    if tp is not None:
        out = tp.exit(out)
    return out, ((k, v) if return_kv else None)


def attn_decode(cfg: ArchConfig, p: Dict, x, position, ctx: ModelCtx,
                k_cache, v_cache, cache_len):
    """One-token decode.  x:(B,1,d); caches (B,S,Hk,D) (views of the stacked
    cache, written in place); cache_len (B,).  Returns the residual branch.

    A slot whose ``cache_len`` is already ``S`` writes nothing: JAX drops an
    out-of-range scatter, and free slots keep counting up (see
    :func:`decode_step`)."""
    B, S = x.shape[0], k_cache.shape[1]
    h = layers.apply_norm(cfg, p["norm"], x)
    q, k, v = _qkv(cfg, p, h, position[:, None])
    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(cache_len, max=S - 1).long()
    keep = (cache_len < S)[:, None, None]
    k_cache[rows, slot] = torch.where(keep, k[:, 0].to(k_cache.dtype),
                                      k_cache[rows, slot])
    v_cache[rows, slot] = torch.where(keep, v[:, 0].to(v_cache.dtype),
                                      v_cache[rows, slot])
    valid = torch.clamp(cache_len + 1, max=S)
    o = attn_lib.decode_attention(q, k_cache, v_cache, valid,
                                  impl=ctx.decode_impl)
    return o.reshape(B, 1, cfg.q_dim) @ p["wo"]


def attn_decode_paged(cfg: ArchConfig, p: Dict, x, position, ctx: ModelCtx,
                      k_pool, v_pool, read_table, write_table, cache_len):
    """One-token decode against a paged cache.  x (B,1,d); pools
    (N, bs, Hk, D) shared across slots (written in place); tables (B, nb)
    int32; cache_len (B,).  Returns the residual branch.

    The new K/V row lands at physical block ``write_table[b, len // bs]``,
    row ``len % bs`` -- the *write* table, so slots that do not own their
    frontier block (shared prefix tails awaiting copy-on-write, or free
    slots with zeroed tables) write into the null block 0 instead of
    corrupting a neighbour.  Attention reads through the *read* table.  A
    free slot's length keeps counting past the table: as JAX clamps an
    out-of-range gather, its block index is clamped to the last column
    (an entry that is 0 for every free slot)."""
    from repro_torch.kernels import ops
    B, bs = x.shape[0], k_pool.shape[1]
    nb = read_table.shape[1]
    h = layers.apply_norm(cfg, p["norm"], x)
    q, k, v = _qkv(cfg, p, h, position[:, None])
    rows = torch.arange(B, device=x.device)
    blk = torch.clamp(cache_len // bs, max=nb - 1).long()
    phys = write_table[rows, blk].long()
    off = (cache_len % bs).long()
    k_pool[phys, off] = k[:, 0].to(k_pool.dtype)
    v_pool[phys, off] = v[:, 0].to(v_pool.dtype)
    layout = CacheLayout(kind="paged", impl=ctx.decode_impl, block_size=bs)
    valid = torch.clamp(cache_len + 1, max=nb * bs)
    o = ops.decode_attention(q, {"k": k_pool, "v": v_pool,
                                 "block_table": read_table}, valid,
                             layout=layout)
    return o.reshape(B, 1, cfg.q_dim) @ p["wo"]


def spec_rows(cache_len, Sq: int, S: int):
    """Where the ``Sq`` rows of a k-row verify land in linear caches of
    ``S`` rows: ``(target (B, Sq), source (B, Sq))``, both int64.

    Row ``j`` belongs at ``cache_len + j``; JAX drops a row past the end
    (``mode="drop"``).  ``index_put_`` cannot drop, and a clamp alone would
    race a dead row's write against the live write of row ``S - 1``, so a
    row past the end is sent to ``S - 1`` carrying the value of the row
    that lands there: ``source = target - cache_len`` is the row whose
    value each target receives, and is negative when no row of this step
    lands at ``S - 1`` (``cache_len >= S``: the old value stays).  Every
    duplicate target then carries one value."""
    lens = cache_len.long()[:, None]
    tgt = torch.clamp(lens + torch.arange(Sq, device=lens.device), max=S - 1)
    return tgt, tgt - lens


def write_spec_rows(cache, tgt, src, new) -> None:
    """``cache[b, tgt[b, j]] = new[b, src[b, j]]`` in place, keeping the
    old row where ``src < 0`` (see :func:`spec_rows`).  ``cache`` (B, S,
    ...), ``new`` (B, Sq, ...)."""
    b = torch.arange(cache.shape[0], device=cache.device)[:, None]
    keep = (src >= 0).reshape(src.shape + (1,) * (new.dim() - 2))
    cache[b, tgt] = torch.where(keep, new[b, torch.clamp(src, min=0)].to(
        cache.dtype), cache[b, tgt])


def paged_spec_targets(cache_len, Sq: int, write_table, bs: int):
    """(physical block, in-block row) ``(B, Sq)`` int64 of each verify row
    ``cache_len + j`` through the write table; a row past the virtual
    space (``nb * bs``) goes to the null block 0, as in JAX (the block
    index is clamped, as JAX clamps an out-of-range gather)."""
    nb = write_table.shape[1]
    B = write_table.shape[0]
    pos = cache_len.long()[:, None] + torch.arange(Sq, device=cache_len.device)
    blk = torch.clamp(pos // bs, max=nb - 1)
    phys = write_table[torch.arange(B, device=pos.device)[:, None],
                       blk].long()
    phys = torch.where(pos < nb * bs, phys, torch.zeros_like(phys))
    return phys, pos % bs


def attn_decode_spec(cfg: ArchConfig, p: Dict, x, position, ctx: ModelCtx,
                     k_cache, v_cache, cache_len, q_lens, *,
                     window: int = 0, snapshot: bool = False):
    """Speculative k-row decode.  x (B, k, d); position (B, k); caches
    (B, S, Hk, D) (views of the stacked cache, written in place);
    cache_len (B,) committed rows; q_lens (B,) in [1, k] live rows per
    slot.  Returns the residual branch.

    All k rows' K/V land at ``cache_len + j`` before the attention; the
    k-row decode path gives draft row ``j`` the effective length
    ``cache_len + 1 + j`` and zeroes rows ``>= q_lens``.  Rejected rows
    leave garbage only past the committed length, masked until later
    appends overwrite it, so a linear cache needs no rollback.  The ring
    branch (``window > 0``, gemma's local layers and its row snapshots)
    is not ported."""
    if window > 0 or snapshot:
        raise NotImplementedError(
            "speculative decode over a ring cache (window > 0: gemma's "
            "local layers) is not ported yet (ROADMAP.md)")
    B, Sq = x.shape[:2]
    S = k_cache.shape[1]
    h = layers.apply_norm(cfg, p["norm"], x)
    q, k, v = _qkv(cfg, p, h, position)
    tgt, src = spec_rows(cache_len, Sq, S)
    write_spec_rows(k_cache, tgt, src, k)
    write_spec_rows(v_cache, tgt, src, v)
    o = attn_lib.decode_attention(q, k_cache, v_cache,
                                  torch.clamp(cache_len + 1, max=S),
                                  impl=ctx.decode_impl, q_lens=q_lens)
    return o.reshape(B, Sq, cfg.q_dim) @ p["wo"]


def attn_decode_paged_spec(cfg: ArchConfig, p: Dict, x, position,
                           ctx: ModelCtx, k_pool, v_pool, read_table,
                           write_table, cache_len, q_lens):
    """Speculative k-row twin of :func:`attn_decode_paged`: row ``j``
    lands at physical block ``write_table[b, (len + j) // bs]``, row
    ``(len + j) % bs`` (:func:`paged_spec_targets`).  The engine owns
    every block of the live span before the step
    (:meth:`~repro_torch.serving.block_pool.SlotTables.ensure_writable_span`),
    so accepted rows land in readable blocks; rejected rows leave garbage
    at dead positions or in the null block only."""
    from repro_torch.kernels import ops
    B, Sq = x.shape[:2]
    bs = k_pool.shape[1]
    S = read_table.shape[1] * bs
    h = layers.apply_norm(cfg, p["norm"], x)
    q, k, v = _qkv(cfg, p, h, position)
    phys, off = paged_spec_targets(cache_len, Sq, write_table, bs)
    k_pool[phys, off] = k.to(k_pool.dtype)
    v_pool[phys, off] = v.to(v_pool.dtype)
    layout = CacheLayout(kind="paged", impl=ctx.decode_impl, block_size=bs)
    o = ops.decode_attention(q, {"k": k_pool, "v": v_pool,
                                 "block_table": read_table},
                             torch.clamp(cache_len + 1, max=S),
                             layout=layout, q_lens=q_lens)
    return o.reshape(B, Sq, cfg.q_dim) @ p["wo"]


def ffn_apply(cfg: ArchConfig, p: Dict, x, ctx: ModelCtx, live=None):
    """FFN residual branch: (out, aux).  ``live`` (optional (B, S) mask,
    serving prefill): positions masked out are excluded from MoE
    routing/capacity -- see :func:`moe.moe_ffn`.  Dense MLPs are per-token,
    so the mask is irrelevant there (aux None)."""
    tp = ctx.tp
    h = layers.apply_norm(cfg, p["norm"] if tp is None else tp.norm(p["norm"]),
                          x)
    if "moe" in p:                     # under tp: expert parallelism
        return moe.moe_ffn(cfg, p["moe"], h, group_size=ctx.moe_group,
                           capacity_factor=ctx.moe_capacity_factor,
                           use_kernel=ctx.use_kernels, live=live, tp=tp)
    if tp is None:
        return layers.apply_mlp(cfg, p["mlp"], h), None
    return tp.exit(layers.apply_mlp(cfg, p["mlp"], tp.enter(h))), None


def _rwkv_forward(cfg, params, h, ctx):
    """The rwkv6 stack; under ``ctx.tp`` the norms see this rank's part of
    the residual (SP: a sequence shard) and each block runs on its
    shards; ``ctx.remat`` recomputes each layer in the backward."""
    tp = ctx.tp

    def norm(p, x):
        return layers.apply_norm(cfg, p if tp is None else tp.norm(p), x)

    def layer(x, blk):
        t_out, _ = ssm.rwkv6_forward(cfg, blk["tmix"], norm(blk["norm1"], x),
                                     use_kernel=ctx.use_kernels, tp=tp)
        x = x + t_out
        c_out, _ = ssm.rwkv_cmix_forward(cfg, blk["cmix"],
                                         norm(blk["norm2"], x), tp=tp)
        return x + c_out

    for blk in _layers(params, cfg):
        h = (checkpoint(layer, h, blk, use_reentrant=False) if ctx.remat
             else layer(h, blk))
    return h


def zero_aux(cfg: ArchConfig, device) -> Dict:
    a = {"lb_loss": torch.zeros((), dtype=torch.float32, device=device),
         "z_loss": torch.zeros((), dtype=torch.float32, device=device)}
    if cfg.is_moe:
        a["expert_load"] = torch.zeros((cfg.num_experts,),
                                       dtype=torch.float32, device=device)
    return a


def _sum_aux(a, b):
    return {k: a[k] + b[k] for k in a}


# ---------------------------------------------------------------------------
# Public API: forward / cache / prefill / decode
# ---------------------------------------------------------------------------

def forward_hidden(cfg: ArchConfig, params: Dict, batch: Dict,
                   ctx: ModelCtx = ModelCtx(), collect_kv: bool = False,
                   true_len=None):
    """Full-sequence forward up to the final norm: (hidden, aux, kvs).

    ``kvs`` is ``(k, v)`` stacked ``(L, B, S, Hk, D)`` when ``collect_kv``;
    ``aux`` sums the MoE layers' losses and expert loads.  ``true_len``
    (serving prefill): positions >= true_len are right-padding -- they are
    masked out of MoE routing so pad garbage never consumes expert
    capacity (every other sublayer is causal or per-token, so pads cannot
    touch real positions there)."""
    check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    tp = ctx.tp
    if tp is not None and family(cfg) not in ("uniform", "rwkv6"):
        raise NotImplementedError(
            f"{family(cfg)} under a sharding plan is not ported yet "
            "(ROADMAP.md)")
    h = (layers.embed_tokens(params["embed"], tokens) if tp is None
         else tp.embed(params["embed"], tokens))
    fn = params["final_norm"]
    if family(cfg) == "rwkv6":          # attention-free: no KV, no aux
        h = _rwkv_forward(cfg, params, h, ctx)
        hidden = layers.apply_norm(cfg, fn if tp is None else tp.norm(fn), h)
        return hidden, zero_aux(cfg, h.device), None
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    live = None
    if true_len is not None:
        live = (torch.arange(S, device=tokens.device)
                < true_len)[None].expand(B, S)
    aux = zero_aux(cfg, h.device)
    ks, vs = [], []

    def layer(x, blk):
        a_out, kv = attn_apply(cfg, blk["attn"], x, positions, ctx,
                               return_kv=collect_kv)
        x = x + a_out
        f_out, f_aux = ffn_apply(cfg, blk["ffn"], x, ctx, live=live)
        return x + f_out, f_aux, kv

    for blk in _layers(params, cfg):
        if ctx.remat:
            h, f_aux, kv = checkpoint(layer, h, blk, use_reentrant=False)
        else:
            h, f_aux, kv = layer(h, blk)
        if f_aux is not None:            # a dense MLP adds nothing
            aux = _sum_aux(aux, f_aux)
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    hidden = layers.apply_norm(cfg, fn if tp is None else tp.norm(fn), h)
    return hidden, aux, kvs


def forward(cfg: ArchConfig, params: Dict, batch: Dict,
            ctx: ModelCtx = ModelCtx(), collect_kv: bool = False,
            true_len=None):
    """Full-sequence forward.  Returns (logits, aux, kvs); under
    ``ctx.tp`` the logits are this rank's vocab columns."""
    h, aux, kvs = forward_hidden(cfg, params, batch, ctx, collect_kv,
                                 true_len=true_len)
    if ctx.tp is not None:
        h = ctx.tp.enter(h)
    return layers.lm_logits(cfg, params, h), aux, kvs


def chunked_ce(cfg: ArchConfig, params: Dict, hidden, targets, mask,
               ctx: ModelCtx, chunk: int = 512):
    """LM head + CE in sequence chunks, each recomputed in the backward
    (the JAX ``jax.checkpoint`` under ``lax.scan``): the (B, S, V) logits
    exist one chunk at a time.  A chunk that does not divide S falls back
    to gcd(chunk, S), as in the JAX package.  Under ``ctx.tp`` the head is
    vocab-parallel over the whole sequence and the mean is global."""
    tp = ctx.tp
    if tp is not None:
        hidden = tp.enter(hidden)
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = math.gcd(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)

    nll_fn = layers._nll if tp is None else tp.nll

    def one(hc, tc, mc):
        nll = nll_fn(layers.lm_logits(cfg, params, hc), tc)
        return torch.sum(nll * mc), torch.sum(mc)

    s = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        sc, nc = checkpoint(one, hidden[:, sl], targets[:, sl],
                            mask[:, sl].float(), use_reentrant=False)
        s, n = s + sc, n + nc
    if tp is not None:
        return tp.mean(s, n)
    return s / torch.clamp(n, min=1.0)


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict,
            ctx: ModelCtx = ModelCtx(), lb_weight: float = 0.01,
            z_weight: float = 1e-3):
    """Training loss: (total, {"ce", "lb_loss", "z_loss"})."""
    hidden, aux, _ = forward_hidden(cfg, params, batch, ctx)
    loss = chunked_ce(cfg, params, hidden, batch["targets"],
                      batch.get("mask"), ctx)
    total = loss + lb_weight * aux["lb_loss"] + z_weight * aux["z_loss"]
    return total, {"ce": loss, **aux}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Dict:
    """Decode cache: zeros ``(L, batch, max_len, Hk, D)`` K and V in the
    model dtype, plus per-row lengths; for rwkv6 the per-layer recurrent
    ``states`` instead (token-shift rows in the model dtype, the WKV state
    in float32)."""
    check_ported(cfg)
    dev = resolve_device(device)
    L = cfg.num_layers
    if family(cfg) == "rwkv6":
        one = ssm.init_rwkv6_state(cfg, batch, device=dev)
        st = {"tmix_last": one["last"].expand(L, -1, -1).clone(),
              "wkv": one["wkv"].expand(L, -1, -1, -1, -1).clone(),
              "cmix_last": one["last"].expand(L, -1, -1).clone()}
        return {"states": st,
                "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dtype = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def init_slots(cfg: ArchConfig, n_slots: int, max_len: int,
               device=None) -> Dict:
    """Slot-indexed decode state (one cache row per slot)."""
    return init_cache(cfg, n_slots, max_len, device=device)


def init_paged_slots(cfg: ArchConfig, n_slots: int, max_len: int, *,
                     num_blocks: int, block_size: int, device=None) -> Dict:
    """Paged decode state: per-layer KV in one shared pool
    ``(L, num_blocks, block_size, Hk, D)`` instead of per-slot rows; slots
    hold only block tables.  ``block_table`` is what attention *reads*
    through, ``write_table`` where appends land (entries the slot does not
    own point at the null block 0).  Both start all-null: the serving
    engine's block-pool machinery fills them at admission.  Uniform family
    only: rwkv6 keeps no KV to page."""
    check_ported(cfg)
    if family(cfg) != "uniform":
        raise ValueError("init_paged_slots is the uniform-family native "
                         f"path, not {family(cfg)!r}")
    if max_len % block_size:
        raise ValueError(f"max_len={max_len} not a multiple of "
                         f"block_size={block_size}")
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    dtype = getattr(torch, cfg.dtype)
    nb = max_len // block_size
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "block_table": torch.zeros((n_slots, nb), dtype=torch.int32,
                                       device=dev),
            "write_table": torch.zeros((n_slots, nb), dtype=torch.int32,
                                       device=dev),
            "len": torch.zeros((n_slots,), dtype=torch.int32, device=dev)}


def scatter_prompt_blocks(cache: Dict, name: str, rows, slot: int) -> None:
    """Write one prompt's per-layer rows ``(L, S_p, ...)`` into pool
    ``cache[name]`` ``(L, N, bs, ...)`` block by block through the slot's
    write table, in place.  Rows are zero-padded to whole blocks; virtual
    blocks the slot does not own (shared sealed prefix blocks, entries past
    its mapped span) have write entry 0, so their rows land in the null
    block."""
    pool = cache[name]
    L, S_p = rows.shape[:2]
    bs = pool.shape[2]
    pad = (-S_p) % bs
    if pad:
        rows = torch.cat([rows, rows.new_zeros((L, pad) + rows.shape[2:])],
                         dim=1)
    nbp = (S_p + pad) // bs
    wt = cache["write_table"][slot, :nbp].long()
    pool[:, wt] = rows.reshape((L, nbp, bs) + rows.shape[2:]).to(pool.dtype)


def _uniform_prefill_slot(cfg, params, cache, tokens, true_len: int,
                          slot: int, ctx):
    logits, _, (k, v) = forward(cfg, params, {"tokens": tokens}, ctx,
                                collect_kv=True, true_len=true_len)
    S_p = tokens.shape[1]
    cache["k"][:, slot, :S_p] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot, :S_p] = v[:, 0].to(cache["v"].dtype)
    cache["len"][slot] = true_len
    return logits[0, true_len - 1], cache


def _uniform_prefill_slot_paged(cfg, params, cache, tokens, true_len: int,
                                slot: int, ctx):
    """Paged twin of :func:`_uniform_prefill_slot`: the same whole-prompt
    forward, its K/V rows scattered through the slot's write table.  Pad
    rows inside owned blocks are dead by the slot length and are
    overwritten by decode appends before the length reaches them."""
    logits, _, (k, v) = forward(cfg, params, {"tokens": tokens}, ctx,
                                collect_kv=True, true_len=true_len)
    scatter_prompt_blocks(cache, "k", k[:, 0], slot)
    scatter_prompt_blocks(cache, "v", v[:, 0], slot)
    cache["len"][slot] = true_len
    return logits[0, true_len - 1], cache


def _rwkv_prefill_slot(cfg, params, cache, tokens, true_len: int,
                       slot: int, ctx):
    """The prompt through every layer from zero states, pads frozen past
    ``true_len``; each layer's final WKV state and shift rows land in the
    slot's row of ``cache["states"]``."""
    h = layers.embed_tokens(params["embed"], tokens)
    per_layer = []
    for blk in _layers(params, cfg):
        xn = layers.apply_norm(cfg, blk["norm1"], h)
        t_out, tstate = ssm.rwkv6_forward(cfg, blk["tmix"], xn,
                                          true_len=true_len,
                                          use_kernel=ctx.use_kernels)
        h = h + t_out
        xn2 = layers.apply_norm(cfg, blk["norm2"], h)
        c_out, clast = ssm.rwkv_cmix_forward(cfg, blk["cmix"], xn2,
                                             true_len=true_len)
        h = h + c_out
        per_layer.append({"tmix_last": tstate["last"], "wkv": tstate["wkv"],
                          "cmix_last": clast})
    states = {k: torch.stack([st[k] for st in per_layer])
              for k in per_layer[0]}
    h = layers.apply_norm(cfg, params["final_norm"], h)
    logits = layers.lm_logits(cfg, params, h)
    ssm.scatter_slot_state(cache["states"], states, slot, batch_axis=1)
    cache["len"][slot] = true_len
    return logits[0, true_len - 1], cache


def prefill_into_slot(cfg: ArchConfig, params: Dict, cache: Dict, tokens,
                      true_len: int, slot: int, ctx: ModelCtx = ModelCtx(),
                      chunk: int = 0):
    """Write one request's prompt K/V into slot ``slot`` of a state built by
    :func:`init_slots` (rows [0, S_pad)) or :func:`init_paged_slots`
    (through the write table), in place, and return (last-position logits
    (V,), the state); for rwkv6, the request's recurrent states.
    ``tokens`` (1, S_pad) may be right-padded; ``true_len`` marks the real
    prompt end (pad rows are dead by the slot length; rwkv6 freezes its
    recurrence over them)."""
    check_ported(cfg)
    if chunk > 0:
        raise NotImplementedError("streaming (chunked) prefill is not "
                                  "ported yet (ROADMAP.md)")
    if family(cfg) == "rwkv6":
        return _rwkv_prefill_slot(cfg, params, cache, tokens, true_len, slot,
                                  ctx)
    if "block_table" in cache:
        return _uniform_prefill_slot_paged(cfg, params, cache, tokens,
                                           true_len, slot, ctx)
    return _uniform_prefill_slot(cfg, params, cache, tokens, true_len, slot,
                                 ctx)


def _uniform_decode(cfg, params, h, position, ctx, cache):
    for i, blk in enumerate(_layers(params, cfg)):
        h = h + attn_decode(cfg, blk["attn"], h, position, ctx,
                            cache["k"][i], cache["v"][i], cache["len"])
        h = h + ffn_apply(cfg, blk["ffn"], h, ctx)[0]
    # every slot advances, free ones included, as in the JAX package
    return h, {"k": cache["k"], "v": cache["v"], "len": cache["len"] + 1}


def _uniform_decode_paged(cfg, params, h, position, ctx, cache):
    read_t, write_t = cache["block_table"], cache["write_table"]
    for i, blk in enumerate(_layers(params, cfg)):
        h = h + attn_decode_paged(cfg, blk["attn"], h, position, ctx,
                                  cache["k"][i], cache["v"][i], read_t,
                                  write_t, cache["len"])
        h = h + ffn_apply(cfg, blk["ffn"], h, ctx)[0]
    return h, dict(cache, len=cache["len"] + 1)


def _rwkv_decode(cfg, params, h, ctx, cache):
    """One token through every layer: each layer's states are read from
    ``cache["states"]`` and the new ones written back in place; the block
    tables of a paged state (rwkv6 pages nothing) ride along."""
    st = cache["states"]
    for i, blk in enumerate(_layers(params, cfg)):
        xn = layers.apply_norm(cfg, blk["norm1"], h)
        t_out, tstate = ssm.rwkv6_forward(
            cfg, blk["tmix"], xn, state={"last": st["tmix_last"][i],
                                         "wkv": st["wkv"][i]})
        h = h + t_out
        xn2 = layers.apply_norm(cfg, blk["norm2"], h)
        c_out, _ = ssm.rwkv_cmix_forward(cfg, blk["cmix"], xn2,
                                         state=st["cmix_last"][i])
        h = h + c_out
        st["tmix_last"][i] = xn[:, -1]
        st["wkv"][i] = tstate["wkv"]
        st["cmix_last"][i] = xn2[:, -1]
    return h, dict(cache, len=cache["len"] + 1)


def decode_step(cfg: ArchConfig, params: Dict, cache: Dict, tokens,
                ctx: ModelCtx = ModelCtx()):
    """One decode step.  tokens (B,1) -> (logits (B,1,V), new state)."""
    check_ported(cfg)
    h = layers.embed_tokens(params["embed"], tokens)
    if family(cfg) == "rwkv6":
        h, cache = _rwkv_decode(cfg, params, h, ctx, cache)
    else:
        decode = (_uniform_decode_paged if "block_table" in cache
                  else _uniform_decode)
        h, cache = decode(cfg, params, h, cache["len"], ctx, cache)
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return layers.lm_logits(cfg, params, h), cache


def _uniform_decode_spec(cfg, params, h, position, ctx, cache, q_lens):
    for i, blk in enumerate(_layers(params, cfg)):
        h = h + attn_decode_spec(cfg, blk["attn"], h, position, ctx,
                                 cache["k"][i], cache["v"][i], cache["len"],
                                 q_lens)
        # dead rows route through the MoE too, as in the JAX package
        h = h + ffn_apply(cfg, blk["ffn"], h, ctx)[0]
    return h, cache


def _uniform_decode_paged_spec(cfg, params, h, position, ctx, cache,
                               q_lens):
    read_t, write_t = cache["block_table"], cache["write_table"]
    for i, blk in enumerate(_layers(params, cfg)):
        h = h + attn_decode_paged_spec(cfg, blk["attn"], h, position, ctx,
                                       cache["k"][i], cache["v"][i], read_t,
                                       write_t, cache["len"], q_lens)
        h = h + ffn_apply(cfg, blk["ffn"], h, ctx)[0]
    return h, cache


def verify_greedy(tokens, logits, q_lens):
    """Greedy draft verification.  ``tokens`` (B, k) are the step inputs
    (row 0 the last committed token, rows 1.. drafts), ``logits`` (B, k, V)
    from :func:`decode_spec`, ``q_lens`` (B,) live rows.  Returns
    ``accepts`` (B,) int32 in ``[1, q_lens]``: row ``j``'s greedy emission
    counts iff every earlier draft row matched the emission before it, so
    the accepted prefix is what row-by-row greedy decode would emit."""
    k = tokens.shape[1]
    g = torch.argmax(logits, dim=-1)
    ok = (tokens[:, 1:] == g[:, :-1]) & (
        torch.arange(k - 1, device=tokens.device)[None]
        < q_lens[:, None] - 1)
    return (1 + torch.cumprod(ok.int(), dim=1).sum(dim=1)).int()


def spec_positions(cache_len, k: int):
    """(B, k) positions ``cache_len + j`` of a verify's rows."""
    return cache_len[:, None] + torch.arange(k, device=cache_len.device)[None]


def check_spec(cfg: ArchConfig) -> None:
    """The reference's refusal of a family whose per-token state cannot
    rewind a rejected draft row."""
    fam = family(cfg)
    if fam not in SPEC_FAMILIES:
        raise ValueError(
            f"speculative decode needs a rollback-free KV cache; family "
            f"{fam!r} carries recurrent per-token state that cannot rewind "
            f"rejected draft rows (supported: {SPEC_FAMILIES})")


def decode_spec(cfg: ArchConfig, params: Dict, cache: Dict, tokens,
                ctx: ModelCtx = ModelCtx(), q_lens=None):
    """Speculative k-row decode + greedy verification + commit.

    ``tokens`` (B, k): row 0 is the last committed token (whose KV is not
    yet in the cache, as for :func:`decode_step`), rows ``1..k-1`` the
    self-drafted continuation; ``q_lens`` (B,) in ``[1, k]`` live rows per
    slot (default all k); row ``j`` sits at position ``len + j``.  Returns ``(logits (B, k, V), accepts (B,), cache)`` with the cache
    committed: ``len += accepts``.  Rejected rows leave garbage only past
    the committed length.  The uniform family, dense or paged; rwkv6
    raises the reference's ``ValueError``."""
    check_spec(cfg)
    check_ported(cfg)
    B, k = tokens.shape
    if q_lens is None:
        q_lens = torch.full((B,), k, dtype=torch.int32, device=tokens.device)
    q_lens = q_lens.to(torch.int32)
    h = layers.embed_tokens(params["embed"], tokens)
    pos = spec_positions(cache["len"], k)
    decode = (_uniform_decode_paged_spec if "block_table" in cache
              else _uniform_decode_spec)
    h, cache = decode(cfg, params, h, pos, ctx, cache, q_lens)
    h = layers.apply_norm(cfg, params["final_norm"], h)
    logits = layers.lm_logits(cfg, params, h)
    accepts = verify_greedy(tokens, logits, q_lens)
    return logits, accepts, dict(cache, len=cache["len"] + accepts)


# ---------------------------------------------------------------------------
# Pipeline stages (the pipelined train step, ``core/pipeline.py``)
# ---------------------------------------------------------------------------
# The stacked-layer (L, ...) blocks split at ``balance_stages`` bounds into
# per-stage blocks with shape-uniform inter-stage activations.  Stages may
# hold different layer counts, so every stage is padded to the widest
# stage and carries a per-slot ``mask``: a masked slot is the identity
# (``x + 0 * sublayer(x)``), with the pad slots holding copies of the
# stage's last real layer so no degenerate-weight numerics ever run.
# Embed and final-norm/head ride outside the stage stack as first/last
# stage extras (``pp_partition_params`` -> {"stage", "last", ["embed"]}).

def stage_slice_params(cfg: Optional[ArchConfig], blocks, bounds) -> Dict:
    """Split stacked (L, ...) uniform blocks into {"blocks": (S, L_max,
    ...), "mask": (S, L_max)} at ``bounds`` (len S+1, from
    ``balance_stages``)."""
    S = len(bounds) - 1
    sizes = [bounds[s + 1] - bounds[s] for s in range(S)]
    if min(sizes) < 1:
        raise ValueError(f"empty stage in bounds {bounds}")
    L_max = max(sizes)

    def slice_one(a):
        outs = []
        for s in range(S):
            sl = a[bounds[s]:bounds[s + 1]]
            if sizes[s] < L_max:                  # pad with a real layer
                pad = sl[-1:].expand((L_max - sizes[s],) + sl.shape[1:])
                sl = torch.cat([sl, pad], dim=0)
            outs.append(sl)
        return torch.stack(outs)

    mask = torch.tensor([[1.0] * n + [0.0] * (L_max - n) for n in sizes],
                        dtype=torch.float32,
                        device=tree_leaves(blocks)[0].device)
    return {"blocks": tree_map(slice_one, blocks), "mask": mask}


def unstack_stage_params(stage_params: Dict, bounds) -> Any:
    """Inverse of :func:`stage_slice_params`: back to stacked (L, ...)."""
    S = len(bounds) - 1
    sizes = [bounds[s + 1] - bounds[s] for s in range(S)]
    return tree_map(lambda a: torch.cat([a[s, :sizes[s]]
                                         for s in range(S)]),
                    stage_params["blocks"])


def remap_stage_params(stage_params: Dict, old_bounds, new_bounds) -> Dict:
    """Live stage remap: re-carve a padded stage stack under new layer
    bounds (the observe->rebalance loop).  The model function is invariant
    -- layer order is preserved, only the stage assignment (and pad width)
    changes."""
    blocks = unstack_stage_params(stage_params, old_bounds)
    return stage_slice_params(None, blocks, new_bounds)


def check_stage_slicing(cfg: ArchConfig) -> None:
    """Raise as JAX's :func:`pp_partition_params` does for an arch the
    pipelined path cannot slice into stages."""
    if family(cfg) != "uniform":
        raise NotImplementedError(
            f"pipeline stage slicing covers the uniform family; "
            f"{cfg.name} is {family(cfg)}")
    if cfg.is_moe:
        raise NotImplementedError(
            "pipelined training drops MoE aux losses; dense uniform only")
    if cfg.pos_type == "mrope":
        raise NotImplementedError(
            "the pipelined path runs plain rope positions and a bare "
            "token embedding; mrope archs (patch_embeds mixing, "
            "3-component positions) are not stage-sliceable yet")


def pp_partition_params(cfg: ArchConfig, params: Dict, bounds) -> Dict:
    """Full-model params -> the pipeline-parallel partition.

    Returns {"stage": stage-stacked blocks+mask, "last": final-norm + head
    (the tied-embedding table lives here when ``cfg.tie_embeddings``),
    "embed": input table (untied only)}."""
    check_stage_slicing(cfg)
    out = {"stage": stage_slice_params(cfg, params["blocks"], bounds),
           "last": {"final_norm": params["final_norm"]}}
    if cfg.tie_embeddings:
        out["last"]["embed"] = params["embed"]
    else:
        out["last"]["lm_head"] = params["lm_head"]
        out["embed"] = params["embed"]
    return out


def pp_merge_params(cfg: ArchConfig, pp_params: Dict, bounds) -> Dict:
    """Inverse of :func:`pp_partition_params` (checkpoint/export)."""
    params = {"blocks": unstack_stage_params(pp_params["stage"], bounds),
              "final_norm": pp_params["last"]["final_norm"]}
    if cfg.tie_embeddings:
        params["embed"] = pp_params["last"]["embed"]
    else:
        params["lm_head"] = pp_params["last"]["lm_head"]
        params["embed"] = pp_params["embed"]
    return params


def make_stage_fn(cfg: ArchConfig, ctx: ModelCtx = ModelCtx(), tp=None):
    """stage_fn(stage_slice, x) for the pipeline schedules: a masked loop
    over the stage's (padded) layers, ``h + m * branch``.  x: (mb, S, d)
    residual stream; the slice's stacked leaves may also be lists of one
    tensor a layer.

    ``tp = (mesh, axis)`` makes this the Megatron-TP body: block params
    hold this rank's head / d_ff column slices (``pp_stage_specs``); each
    residual branch enters through Megatron's ``f`` (identity forward,
    all-reduce backward) and exits through ``g`` (all-reduce forward,
    identity backward).  Gradients of TP-sliced weights come out exact
    and local; those of the replicated leaves inside a branch (the norms)
    are per-rank partials the trainer sums over ``axis`` once.  Local head
    counts are inferred from the sliced shapes, so one function serves any
    tp degree.  ``ctx.remat`` recomputes each layer in the backward.
    """
    if tp is not None and tp[0].shape.get(tp[1], 1) > 1:
        from repro_torch.core.sharding import _Copy, _Reduce
        mesh, axis = tp

        def f_in(x):
            return _Copy.apply(x, mesh, (axis,))

        def g_out(x):
            return _Reduce.apply(x, mesh, (axis,))
    else:
        def f_in(x):
            return x
        g_out = f_in
    base = dataclasses.replace(ctx, tp=None)

    def stage_fn(p, x):
        blocks = p["blocks"]
        qd = blocks["attn"]["wq"][0].shape[-1]
        kvd = blocks["attn"]["wk"][0].shape[-1]
        cfg_l = dataclasses.replace(cfg, num_heads=qd // cfg.head_dim,
                                    num_kv_heads=kvd // cfg.head_dim)
        B, S_seq, _ = x.shape
        positions = torch.arange(S_seq, device=x.device)[None].expand(
            B, S_seq)

        def layer(h, blk, m):
            a_out, _ = attn_apply(cfg_l, blk["attn"], f_in(h), positions,
                                  base)
            h = h + m * g_out(a_out)
            # the dense FFN spelled out (pp_partition_params rejects MoE)
            hn = layers.apply_norm(cfg_l, blk["ffn"]["norm"], f_in(h))
            f_out = layers.apply_mlp(cfg_l, blk["ffn"]["mlp"], hn)
            return h + m * g_out(f_out)

        h = x
        for i in range(p["mask"].shape[0]):
            blk = _layer(blocks, i)
            m = p["mask"][i].to(x.dtype)        # the pad mask: no gradient
            h = (checkpoint(layer, h, blk, m, use_reentrant=False)
                 if ctx.remat else layer(h, blk, m))
        return h

    return stage_fn


def make_stage_fn_tp(cfg: ArchConfig, ctx: ModelCtx = ModelCtx(), *, mesh,
                     tp_axis: str = "model"):
    """The Megatron-TP configuration of :func:`make_stage_fn`."""
    return make_stage_fn(cfg, ctx, tp=(mesh, tp_axis))


def make_last_fn(cfg: ArchConfig, ctx: ModelCtx = ModelCtx()):
    """last_fn(last_params, y, tgt, mask) -> masked NLL *sum* over one
    micro-batch (the pipeline divides by the global mask weight)."""

    def last_fn(lp, y, tgt, mask):
        h = layers.apply_norm(cfg, lp["final_norm"], y)
        nll = layers._nll(layers.lm_logits(cfg, lp, h), tgt)
        return torch.sum(nll * mask)

    return last_fn
