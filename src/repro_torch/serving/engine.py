"""Fixed-slot continuous-batching serving engine (port of
``repro/serving/engine.py``, the greedy uniform-family and rwkv6 slices).

The decode batch has a fixed shape of ``n_slots`` cache rows, each slot
holds one request, and per-slot lengths (``cache["len"]``) track each row's
KV frontier.  Arriving requests wait in a bounded two-level SLO admission
queue; a free slot is filled by a prefill of the prompt into that slot's
cache row, after which every engine step decodes one token for all slots.
Finished slots are refilled at once (``refill="continuous"``) or only once
the whole batch drains (``refill="static"``).

Time is kept on a :class:`~repro_torch.serving.traffic.Clock`: each model
call advances it by its measured wall time (the GPU synchronised first, so
the clock times the work and not only its launch) or by a pinned per-call
cost, and idle waits jump to the next arrival.

The cache layout (:class:`~repro_torch.cache_layout.CacheLayout`) and the
model's family pick the backend: for the uniform family dense 16-bit
(:class:`NativeBackend`), dense int8 (:class:`Int8KVBackend`), paged 16-bit
(:class:`PagedNativeBackend`) or paged int8 (:class:`PagedInt8Backend`);
for rwkv6, whose recurrent state carries no KV, :class:`NativeBackend`
dense and :class:`PagedSlots` paged (block tables and no pool: the JAX
package's generic paged composition, which pages zero leaves of that
family), and int8 raises ``ValueError`` as in the JAX package.  With a
paged backend the engine owns the host-side block accounting: a
:class:`~repro_torch.serving.block_pool.BlockPool` and
:class:`~repro_torch.serving.block_pool.SlotTables` pair whose tables it
uploads whenever they change, prefix-sharing admission keyed by
:func:`~repro_torch.serving.block_pool.prefix_keys`, the copy-on-write walk
before each decode step, and queue-head pushback when the pool is full.

The engine is instrumented as the JAX one is (:mod:`repro_torch.obs`):
hand it a ``tracer`` and/or a ``metrics`` registry and it pins both to its
clock, emits per-request phase spans (``req.queue_wait`` / ``req.prefill``
/ ``req.decode`` on one track per slot) built from the same
:class:`~repro_torch.serving.metrics.RequestRecord` timestamps the
TTFT/TPOT report reads, per-step ``decode_step`` spans carrying the modeled
bytes and FLOPs, scheduler instants (``sched.admit`` / ``sched.reject`` /
``sched.shed`` / ``sched.pushback``, ``pool.cow``) and live block-pool and
load gauges.  A CF head (:class:`~repro_torch.serving.cf_head.CFHead`)
scores a request's candidate set between its prefill and its first-token
stamp, inside the ``req.prefill`` span (``cf.lookup``).

This port serves greedy decode, one token per step or, with
``EngineConfig.spec_k > 1``, speculatively: each step self-drafts up to
``spec_k - 1`` continuation tokens a slot (:func:`ngram_draft`, no second
model), verifies every row in one k-row decode
(:func:`~repro_torch.models.transformer.decode_spec` /
:func:`~repro_torch.models.kvquant.quant_decode_spec`) and commits each
slot's accepted prefix, so the streams equal one-token decode's under all
four uniform layouts (a recurrent family raises the reference's
``ValueError``).  Everything else raises ``NotImplementedError`` rather
than being ignored: sampled requests (``temperature > 0``), the generic
int8 composition and the paged one over KV leaves (other families,
streaming prefill), ``prefill_chunk > 0``, and prefill/decode engine
roles (``ROADMAP.md`` queues them).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cache_layout import (CacheLayout, blocks_per_slot,
                                      resolved_num_blocks)
from repro_torch.core.hybrid import decode_model_flops
from repro_torch.models import kvquant
from repro_torch.models import transformer as tf
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, or_null
from repro_torch.serving import metrics as metrics_lib
from repro_torch.serving import roofline
from repro_torch.serving.block_pool import BlockPool, SlotTables, prefix_keys
from repro_torch.serving.traffic import Clock, Request


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4
    max_len: int = 128
    queue_capacity: int = 64
    refill: str = "continuous"          # continuous | static
    prompt_quantum: int = 8             # prompts pad to multiples
    pad_id: int = 0
    sample_seed: int = 0                # base of the per-request RNG keys
    layout: CacheLayout = CacheLayout()  # cache layout spec (kind/bits/impl)
    prefill_chunk: int = 0              # uniform streaming prefill chunk
    spec_k: int = 1                     # speculative decode rows per step
    spec_draft: str = "ngram"           # self-speculative draft source


# Ported families whose slot state holds no KV rows (rwkv6: int8 KV does
# not apply, and a paged layout pages nothing).
NO_KV_FAMILIES = frozenset({"rwkv6"})


def _bucket(n: int, quantum: int, cap: int) -> int:
    return min(cap, ((n + quantum - 1) // quantum) * quantum)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md)")


def ngram_draft(history, need: int, lookback: int = 64) -> List[int]:
    """Self-speculative n-gram draft (prompt-lookup style): propose up to
    ``need`` continuation tokens by matching the tail of ``history``
    (prompt + generated so far) against its own recent past -- bigram match
    first, unigram fallback, empty when nothing recurs.  ``lookback``
    bounds the backward scan so drafting stays O(1) per step."""
    if need <= 0 or len(history) < 2:
        return []

    def match_once(h, want):
        for width in (2, 1):
            if len(h) <= width:
                continue
            pat = h[-width:]
            start = max(0, len(h) - 1 - lookback)
            for i in range(len(h) - 1 - width, start - 1, -1):
                if h[i:i + width] == pat:
                    cont = h[i + width:i + width + want]
                    if cont:
                        return [int(t) for t in cont]
        return []

    # a match near the tail (a run "... x x x") yields a continuation cut
    # by the end of history: re-matching against history + draft so far
    # fills the budget, so runs and short cycles draft the full need
    h, out = list(history), []
    while len(out) < need:
        step = match_once(h, need - len(out))
        if not step:
            break
        out.extend(step)
        h.extend(step)
    return out


class AdmissionQueue:
    """Two-level SLO-priority admission queue (interactive > batch).

    FIFO within a tier; ``popleft`` serves the interactive tier first, and
    ``shed_batch`` evicts the *newest* batch-tier entry to make room for an
    interactive arrival when the bounded queue saturates."""

    def __init__(self):
        self._tiers: Dict[bool, Deque] = {True: deque(), False: deque()}

    @staticmethod
    def _interactive(req: Request) -> bool:
        return req.slo.name == "interactive"

    def __len__(self) -> int:
        return len(self._tiers[True]) + len(self._tiers[False])

    def append(self, item) -> None:
        self._tiers[self._interactive(item[0])].append(item)

    def popleft(self):
        for tier in (True, False):
            if self._tiers[tier]:
                return self._tiers[tier].popleft()
        raise IndexError("pop from an empty AdmissionQueue")

    def shed_batch(self):
        """Evict and return the newest batch-tier entry (None if none)."""
        return self._tiers[False].pop() if self._tiers[False] else None

    def pushback(self, item) -> None:
        """Return an item to the *head* of its tier -- used when paged
        admission fails on pool exhaustion: the request keeps its place in
        line and retries after retirements free blocks."""
        self._tiers[self._interactive(item[0])].appendleft(item)


class SlotBackend:
    """A model behind the slot protocol: ``init_slots`` (slot-indexed state),
    ``prefill`` (one request's prompt into one slot, returning that slot's
    last-position logits), ``decode`` (one token for every slot) and, for
    a backend with a speculative path, ``decode_spec`` (a k-row verify
    for every slot: tokens (n_slots, k) on the device -- row 0 the last
    committed token, rows 1.. self-drafted -- and q_lens (n_slots,) live
    rows, verified greedily in one pass; it returns (logits
    (n_slots, k, V), accepts (n_slots,), committed cache)).  The state is
    updated in place on ``device``."""

    # verify rows a step, stamped by a speculative engine before
    # init_slots (the JAX package sizes ring caches by it; the uniform
    # family's linear caches need no margin)
    spec_k = 1

    def __init__(self, cfg, params, ctx: Optional[tf.ModelCtx] = None,
                 decode_impl: Optional[str] = None, device=None):
        tf.check_ported(cfg)
        self.family = tf.family(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"backend runs on {self.device}")
        self.cfg, self.params = cfg, params
        self.ctx = ctx if ctx is not None else tf.ModelCtx(attn_chunk=8)
        if decode_impl is not None:
            self.ctx = dataclasses.replace(self.ctx, decode_impl=decode_impl)
        # the layout this backend realizes (paged backends set the full
        # spec before this; make_backend stamps the resolved one)
        if not hasattr(self, "layout"):
            self.layout = CacheLayout(impl=self.ctx.decode_impl)

    def init_slots(self, n_slots: int, max_len: int) -> Dict:
        raise NotImplementedError

    def prefill(self, cache: Dict, tokens: np.ndarray, true_len: int,
                slot: int):
        """tokens (1, S_pad) -> (last-position logits (V,), cache)."""
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)
        with torch.inference_mode():
            return self._prefill_impl(self.params, cache, toks,
                                      int(true_len), int(slot))

    def decode(self, cache: Dict, tokens):
        """tokens (n_slots, 1) on the device -> (logits (n_slots, 1, V),
        cache)."""
        with torch.inference_mode():
            return self._decode_impl(self.params, cache, tokens)


class NativeBackend(SlotBackend):
    """Model-dtype slot state via ``init_slots`` / ``prefill_into_slot`` /
    ``decode_step``."""

    def __init__(self, cfg, params, ctx: Optional[tf.ModelCtx] = None,
                 decode_impl: Optional[str] = None, prefill_chunk: int = 0,
                 device=None):
        if prefill_chunk:
            raise _not_ported("streaming (chunked) prefill")
        super().__init__(cfg, params, ctx, decode_impl, device)

    def init_slots(self, n_slots: int, max_len: int) -> Dict:
        return tf.init_slots(self.cfg, n_slots, max_len, device=self.device)

    def _decode_impl(self, params, cache, tokens):
        return tf.decode_step(self.cfg, params, cache, tokens, self.ctx)

    @torch.inference_mode()
    def decode_spec(self, cache: Dict, tokens, q_lens):
        return tf.decode_spec(self.cfg, self.params, cache, tokens,
                              self.ctx, q_lens=q_lens)

    def _prefill_impl(self, params, cache, tokens, true_len, slot):
        return tf.prefill_into_slot(self.cfg, params, cache, tokens,
                                    true_len, slot, self.ctx)


class Int8KVBackend(SlotBackend):
    """Fused int8-KV path (:mod:`repro_torch.models.kvquant`): the cache is
    int8 values + per-(position, head) scales and decode attention reads
    the int8 values directly -- half the cache bytes per slot and no
    dequantized copy."""

    def __init__(self, cfg, params, ctx: Optional[tf.ModelCtx] = None,
                 decode_impl: Optional[str] = None, device=None):
        super().__init__(cfg, params, ctx, decode_impl, device)
        self.layout = self.layout.replace(kv_bits=8)

    def init_slots(self, n_slots: int, max_len: int) -> Dict:
        return kvquant.init_model_quant_cache(self.cfg, n_slots, max_len,
                                              device=self.device)

    def _decode_impl(self, params, cache, tokens):
        return kvquant.quant_decode_step(self.cfg, params, cache, tokens,
                                         self.ctx)

    @torch.inference_mode()
    def decode_spec(self, cache: Dict, tokens, q_lens):
        return kvquant.quant_decode_spec(self.cfg, self.params, cache,
                                         tokens, self.ctx, q_lens=q_lens)

    def _prefill_impl(self, params, cache, tokens, true_len, slot):
        logits, quant = kvquant.quant_prefill_kv(
            self.cfg, params, {"tokens": tokens}, self.ctx, true_len)
        S_p = tokens.shape[1]
        for name, upd in zip(("k_q", "k_s", "v_q", "v_s"), quant):
            cache[name][:, slot, :S_p] = upd[:, 0]
        cache["len"][slot] = true_len
        return logits[0, true_len - 1], cache


class _PagedBackendMixin:
    """Device-side plumbing of the paged backends: ``set_tables`` uploads
    the host read/write tables; ``copy_block`` is the device half of
    copy-on-write (one physical block's rows duplicated across every pooled
    leaf, in place).  ``supports_prefix_sharing`` marks backends whose
    prompt block content is a pure function of (prompt, engine constants),
    the precondition for the hash index being sound."""

    supports_prefix_sharing = True
    _pool_leaves: tuple = ()

    def set_tables(self, cache: Dict, read: np.ndarray,
                   write: np.ndarray) -> Dict:
        for name, tbl in (("block_table", read), ("write_table", write)):
            cache[name] = torch.as_tensor(np.asarray(tbl, np.int32),
                                          device=self.device)
        return cache

    def copy_block(self, cache: Dict, src: int, dst: int) -> Dict:
        for name in self._pool_leaves:
            cache[name][:, dst] = cache[name][:, src]
        return cache


class PagedNativeBackend(_PagedBackendMixin, SlotBackend):
    """Paged 16-bit path: stacked per-layer KV in a shared pool
    ``(L, N, bs, Hk, D)``; decode appends through the write table and
    attends through the read table with the paged flash-decode kernel (or
    the dense einsum over the gathered rows) -- see
    :func:`transformer.init_paged_slots` / :func:`attn_decode_paged`."""

    _pool_leaves = ("k", "v")

    def __init__(self, cfg, params, ctx: Optional[tf.ModelCtx] = None,
                 layout: CacheLayout = CacheLayout(kind="paged"),
                 device=None):
        self.layout = layout
        super().__init__(cfg, params, ctx, layout.impl, device)

    def init_slots(self, n_slots: int, max_len: int) -> Dict:
        return tf.init_paged_slots(
            self.cfg, n_slots, max_len,
            num_blocks=resolved_num_blocks(self.layout, n_slots, max_len),
            block_size=self.layout.block_size, device=self.device)

    def _decode_impl(self, params, cache, tokens):
        return tf.decode_step(self.cfg, params, cache, tokens, self.ctx)

    @torch.inference_mode()
    def decode_spec(self, cache: Dict, tokens, q_lens):
        return tf.decode_spec(self.cfg, self.params, cache, tokens,
                              self.ctx, q_lens=q_lens)

    def _prefill_impl(self, params, cache, tokens, true_len, slot):
        return tf.prefill_into_slot(self.cfg, params, cache, tokens,
                                    true_len, slot, self.ctx)


class PagedInt8Backend(_PagedBackendMixin, SlotBackend):
    """Paged int8 path: pooled int8 values + pooled per-(position, head)
    scales, dequantized in the kernel through the block tables
    (:mod:`repro_torch.models.kvquant`'s paged twins)."""

    _pool_leaves = ("k_q", "k_s", "v_q", "v_s")

    def __init__(self, cfg, params, ctx: Optional[tf.ModelCtx] = None,
                 layout: CacheLayout = CacheLayout(kind="paged", kv_bits=8),
                 device=None):
        self.layout = layout
        super().__init__(cfg, params, ctx, layout.impl, device)

    def init_slots(self, n_slots: int, max_len: int) -> Dict:
        return kvquant.init_paged_quant_cache(
            self.cfg, n_slots, max_len,
            num_blocks=resolved_num_blocks(self.layout, n_slots, max_len),
            block_size=self.layout.block_size, device=self.device)

    def _decode_impl(self, params, cache, tokens):
        return kvquant.quant_decode_step(self.cfg, params, cache, tokens,
                                         self.ctx)

    @torch.inference_mode()
    def decode_spec(self, cache: Dict, tokens, q_lens):
        return kvquant.quant_decode_spec(self.cfg, self.params, cache,
                                         tokens, self.ctx, q_lens=q_lens)

    def _prefill_impl(self, params, cache, tokens, true_len, slot):
        logits, quant = kvquant.quant_prefill_kv(
            self.cfg, params, {"tokens": tokens}, self.ctx, true_len)
        for name, upd in zip(self._pool_leaves, quant):
            tf.scatter_prompt_blocks(cache, name, upd[:, 0], slot)
        cache["len"][slot] = true_len
        return logits[0, true_len - 1], cache


class PagedSlots(_PagedBackendMixin, SlotBackend):
    """The generic paged composition for a family whose slot state pages
    nothing (rwkv6: its WKV and shift rows are O(1) per slot): the inner
    backend's state plus block tables and no pool, so the engine's block
    accounting, prefix-sharing admission and copy-on-write walk run as for
    any paged layout, and every model call is the inner backend's (the JAX
    ``PagedSlots``'s gather and repool are the identity there).  The
    composition over KV leaves (gemma, jamba, whisper) is not ported."""

    def __init__(self, inner: SlotBackend, layout: CacheLayout):
        if inner.family not in NO_KV_FAMILIES:
            raise _not_ported(f"the paged composition over the KV leaves of "
                              f"family {inner.family!r}")
        self.inner = inner
        self.layout = layout
        super().__init__(inner.cfg, inner.params, inner.ctx,
                         device=inner.device)

    def init_slots(self, n_slots: int, max_len: int) -> Dict:
        state = self.inner.init_slots(n_slots, max_len)
        tbl = torch.zeros((n_slots, blocks_per_slot(self.layout, max_len)),
                          dtype=torch.int32, device=self.device)
        state["block_table"] = tbl
        state["write_table"] = tbl.clone()
        return state

    def _decode_impl(self, params, cache, tokens):
        return self.inner._decode_impl(params, cache, tokens)

    def _prefill_impl(self, params, cache, tokens, true_len, slot):
        return self.inner._prefill_impl(params, cache, tokens, true_len, slot)


def make_backend(cfg, params, ctx: Optional[tf.ModelCtx] = None,
                 prefill_chunk: int = 0, *,
                 layout: Optional[CacheLayout] = None, device=None):
    """Backend for ``layout`` and the model's family.  Uniform: dense
    16-bit -> :class:`NativeBackend`, dense int8 -> :class:`Int8KVBackend`,
    paged 16-bit -> :class:`PagedNativeBackend`, paged int8 ->
    :class:`PagedInt8Backend`.  rwkv6: dense -> :class:`NativeBackend`,
    paged -> :class:`PagedSlots` over it, int8 -> ``ValueError`` (no KV
    to quantize).  ``layout.impl`` overrides the decode-attention path of
    ``ctx`` only when a layout was passed explicitly (the paged backends
    always take it), as in the JAX package.  Streaming prefill with an int8
    or paged layout needs the JAX package's generic compositions, which are
    not ported yet."""
    explicit = layout is not None
    if layout is None:
        layout = CacheLayout()
    tf.check_ported(cfg)
    fam = tf.family(cfg)
    if layout.quantized and fam in NO_KV_FAMILIES:
        raise ValueError(
            f"family {fam!r} carries no KV cache; int8 KV does not "
            f"apply (its recurrent state is O(1) per slot already)")
    impl = layout.impl if explicit else None
    if fam == "rwkv6" and layout.paged and not prefill_chunk:
        return PagedSlots(NativeBackend(cfg, params, ctx, impl,
                                        device=device), layout)
    if not layout.paged and not layout.quantized:
        return NativeBackend(cfg, params, ctx, impl, prefill_chunk,
                             device=device)
    if prefill_chunk:
        raise _not_ported("streaming (chunked) prefill with an int8 or "
                          "paged layout (the Int8KVSlots / PagedSlots "
                          "compositions)")
    if not layout.paged:
        backend = Int8KVBackend(cfg, params, ctx, impl, device=device)
        backend.layout = layout.replace(kv_bits=8)
        return backend
    cls = PagedInt8Backend if layout.quantized else PagedNativeBackend
    return cls(cfg, params, ctx, layout, device=device)


class ServingEngine:
    """Slot scheduler over a backend exposing init_slots/prefill/decode.

    With a paged backend (one with ``set_tables``) the engine also owns the
    host-side block accounting: a :class:`BlockPool` + :class:`SlotTables`
    pair whose read/write tables it uploads whenever they change,
    prefix-sharing admission keyed by :func:`prefix_keys`, and the
    per-step copy-on-write walk (:meth:`SlotTables.ensure_writable` ->
    ``backend.copy_block``)."""

    def __init__(self, backend, ecfg: EngineConfig = EngineConfig(),
                 clock: Optional[Clock] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None, *,
                 role: str = "both", cf_head=None):
        if role != "both":
            raise _not_ported(f"engine role {role!r}")
        # speculative decode: k rows verified per scheduler step
        self.spec_k = max(1, int(ecfg.spec_k))
        if self.spec_k > 1:
            if ecfg.spec_draft != "ngram":
                raise ValueError(
                    f"unknown spec_draft {ecfg.spec_draft!r}; the engine "
                    "is self-speculative (draft='ngram', no second model)")
            fam = getattr(backend, "family", None)
            if fam is not None and fam not in tf.SPEC_FAMILIES:
                raise ValueError(
                    f"speculative decode (spec_k={self.spec_k}) needs a "
                    f"pure-KV cache family {tf.SPEC_FAMILIES}; {fam!r} "
                    "carries recurrent per-token state that cannot rewind "
                    "a rejected draft — serve it with spec_k=1")
            if not callable(getattr(backend, "decode_spec", None)):
                raise ValueError(
                    f"{type(backend).__name__} has no speculative decode "
                    "path; serve it with spec_k=1")
            # stamped before init_slots; max() keeps a shared backend's
            # state large enough for every engine using it
            backend.spec_k = max(getattr(backend, "spec_k", 1), self.spec_k)
        if ecfg.prefill_chunk:
            raise _not_ported("streaming (chunked) prefill")
        self.backend, self.ecfg = backend, ecfg
        self.clock = clock if clock is not None else Clock()
        # observability: spans/instants + pool gauges, both pinned to the
        # engine's clock so per-request span durations reconcile with the
        # TTFT/TPOT report by construction (the shared no-op tracer never
        # reads its clock, and is left holding no engine)
        self.tracer = or_null(tracer)
        if tracer is not None:
            tracer.clock = lambda: self.clock.now
        self.metrics = metrics
        if metrics is not None:
            metrics.clock = lambda: self.clock.now
        n = ecfg.n_slots
        self.layout = getattr(backend, "layout", None) or ecfg.layout
        self.pool: Optional[BlockPool] = None
        self.tables: Optional[SlotTables] = None
        self.prefix_sharing = False
        if self.layout.paged and hasattr(backend, "set_tables"):
            self.pool = BlockPool(
                resolved_num_blocks(self.layout, n, ecfg.max_len),
                self.layout.block_size)
            self.tables = SlotTables(
                self.pool, n, blocks_per_slot(self.layout, ecfg.max_len))
            self.prefix_sharing = (
                self.layout.prefix_sharing
                and getattr(backend, "supports_prefix_sharing", False))
            if metrics is not None:
                self.pool.attach_metrics(metrics,
                                         clock=lambda: self.clock.now)
        # sliding-window TTFT/TPOT histograms in the registry
        self.win = (metrics_lib.WindowedLatency(metrics, "engine")
                    if metrics is not None else None)
        self.cache = backend.init_slots(n, ecfg.max_len)
        self.queue = AdmissionQueue()
        self.slot_req: List[Optional[Request]] = [None] * n
        self.slot_rec: List[Optional[metrics_lib.RequestRecord]] = [None] * n
        self.slot_remaining = np.zeros(n, np.int64)
        self.slot_tokens = np.zeros((n, 1), np.int64)
        # device twin of slot_tokens: after a pure decode step the next
        # tokens are already on the device (the argmax output)
        self._tokens_dev = None
        self._tokens_dirty = True
        self.outputs: Dict[int, List[int]] = {}
        self.records: List[metrics_lib.RequestRecord] = []
        self.decode_steps = 0
        self.prefills = 0
        # KV frontier per slot (rows filled: prompt + generated so far); the
        # paged write path makes position _slot_len[s] writable before each
        # decode step lands a token there
        self._slot_len = np.zeros(n, np.int64)
        self.max_concurrent = 0
        self._kv_bytes_sum = 0.0
        # speculative accounting: tokens emitted by decode steps over live
        # slot-steps (one-token decode == exactly 1.0), and verify rows run
        self.spec_tokens = 0
        self.spec_slot_steps = 0
        self.spec_rows = 0
        # recsys serving: requests carrying a candidate set are scored by
        # the CF head at prefill, inside the req.prefill span
        self.cf_head = cf_head
        self.cf_results: Dict[int, Dict] = {}
        self.cf_scored = 0

    @property
    def n_active(self) -> int:
        return sum(1 for r in self.slot_req if r is not None)

    def _timed(self, fixed_s: Optional[float], fn):
        t0 = time.perf_counter()
        out = fn()
        device = getattr(self.backend, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)  # time the work, not its launch
        self.clock.advance(fixed_s if fixed_s is not None
                           else time.perf_counter() - t0)
        return out

    def _sync_tables(self) -> None:
        if self.tables is not None and self.tables.dirty:
            self.cache = self.backend.set_tables(
                self.cache, self.tables.read, self.tables.write)
            self.tables.dirty = False

    def _share_seed(self) -> tuple:
        """Cache-namespace seed for prefix hashing: everything besides the
        prompt tokens that shapes a prompt's KV rows (model, backend and
        numerics config).  Deterministic within a process; the keys differ
        from the JAX package's, which hashes its own class names."""
        return (self.backend.cfg.name, self.layout.kv_bits,
                type(self.backend).__name__, repr(self.backend.ctx))

    def _resident_kv_bytes(self) -> float:
        """Modeled resident decode-state bytes right now (paged: pool
        occupancy; dense: every slot pinned at max_len)."""
        cfg = getattr(self.backend, "cfg", None)
        if cfg is None:
            return 0.0
        return roofline.resident_kv_bytes(
            cfg, self.ecfg.n_slots, self.ecfg.max_len, self.layout,
            used_blocks=self.pool.used_blocks if self.pool is not None
            else 0)

    def _trace_request(self, rec: metrics_lib.RequestRecord,
                       slot: int) -> None:
        """Retroactive per-request phase spans on track ``slot{N}``, built
        from the RequestRecord timestamps the metrics report reads:
        ``ttft == queue_wait.dur + prefill.dur`` and
        ``tpot == decode.dur / (tokens_out - 1)`` hold identically."""
        tr = self.tracer
        if not tr.enabled or rec.finished is None:
            return
        track = f"slot{slot}"
        tr.complete("req.queue_wait", rec.arrival, rec.admitted, track=track,
                    rid=rec.rid, slo=rec.slo_name)
        tr.complete("req.prefill", rec.admitted, rec.first_token, track=track,
                    rid=rec.rid, prompt_len=rec.prompt_len)
        tr.complete("req.decode", rec.first_token, rec.finished, track=track,
                    rid=rec.rid, tokens_out=rec.tokens_out)

    def _decode_model_args(self) -> Dict:
        """Modeled bytes/FLOPs/utilization of one decode step over the live
        per-slot lengths: the args of a traced ``decode_step`` span."""
        cfg = self.backend.cfg
        lengths = [int(self._slot_len[s]) for s in range(self.ecfg.n_slots)
                   if self.slot_req[s] is not None]
        if not lengths:
            return {}
        rb = roofline.decode_attn_read_bytes(
            cfg, lengths, self.ecfg.max_len,
            impl=self.layout.impl, kv_bits=self.layout.kv_bits)
        return {
            "n_active": len(lengths),
            "attn_read_bytes": rb["attn_read_bytes_per_step"],
            "mean_utilization": rb["mean_utilization"],
            "model_flops": decode_model_flops(
                cfg, max(lengths), len(lengths)),
        }

    # -- scheduler ops -------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Enqueue; False (and a rejected record) when the bounded admission
        queue is full or the prompt cannot fit the serving window.  At
        saturation an interactive arrival sheds the newest batch-tier
        entry instead of being dropped."""
        if req.temperature > 0.0:
            raise _not_ported(f"sampled decode (request {req.rid} has "
                              f"temperature {req.temperature})")
        if req.frames is not None or req.grid is not None:
            raise _not_ported(f"request {req.rid}'s encoder frames / patch "
                              "grid")
        rec = metrics_lib.RequestRecord(
            rid=req.rid, user_id=req.user_id, prompt_len=len(req.prompt),
            slo_name=req.slo.name, ttft_slo_s=req.slo.ttft_ms / 1e3,
            tpot_slo_s=req.slo.tpot_ms / 1e3, arrival=req.arrival)
        self.records.append(rec)
        if len(req.prompt) >= self.ecfg.max_len:
            rec.rejected = True
            self.tracer.instant("sched.reject", track="sched",
                                rid=req.rid, reason="prompt_too_long")
            return False
        if len(self.queue) >= self.ecfg.queue_capacity:
            shed = (self.queue.shed_batch()
                    if req.slo.name == "interactive" else None)
            if shed is None:
                rec.rejected = True
                self.tracer.instant("sched.reject", track="sched",
                                    rid=req.rid, reason="queue_full")
                return False
            shed[1].rejected = True         # the batch-tier request it evicts
            self.tracer.instant("sched.shed", track="sched",
                                rid=shed[0].rid, for_rid=req.rid)
        self.queue.append((req, rec))
        self._note_load()
        return True

    def _start(self, slot: int, req: Request,
               rec: metrics_lib.RequestRecord) -> bool:
        """Prefill-on-arrival into one slot; the first generated token falls
        out of the prefill logits.  Returns False -- request untouched --
        when the block pool cannot map the request yet (paged admission):
        the caller requeues it behind the blocks that retiring slots
        free."""
        prompt = np.asarray(req.prompt, np.int64)
        if self.tables is not None:
            bs = self.layout.block_size
            span = -(-min(len(prompt) + req.max_new_tokens,
                          self.ecfg.max_len) // bs)
            if self.prefix_sharing:
                keys, tail = prefix_keys(req.prompt, bs,
                                         self._share_seed())
            else:
                keys, tail = [], None
            if not self.tables.admit(slot, keys, tail, span):
                return False
            self._sync_tables()
        rec.admitted = self.clock.now
        self.tracer.instant("sched.admit", track="sched",
                            rid=req.rid, slot=slot,
                            queue_wait=rec.admitted - rec.arrival)
        s_pad = _bucket(len(prompt), self.ecfg.prompt_quantum,
                        self.ecfg.max_len)
        padded = np.full((1, s_pad), self.ecfg.pad_id, np.int64)
        padded[0, :len(prompt)] = prompt
        logits_row, self.cache = self._timed(
            self.clock.fixed_prefill_s,
            lambda: self.backend.prefill(self.cache, padded, len(prompt),
                                         slot))
        self.prefills += 1
        self._slot_len[slot] = len(prompt)
        if self.tables is not None:
            # publish this prompt's self-computed blocks for later sharers
            self.tables.seal_prompt(slot)
        if self.cf_head is not None and req.candidates:
            self._score_candidates(slot, req, logits_row)
        first = int(torch.argmax(logits_row))   # first maximum, as jnp
        rec.first_token = self.clock.now
        rec.tokens_out = 1
        if self.win is not None:
            self.win.observe_ttft(rec.first_token - rec.arrival)
        self.outputs[req.rid] = [first]
        budget = min(req.max_new_tokens, self.ecfg.max_len - len(prompt))
        if first == req.eos_id or budget <= 1:
            rec.finished = self.clock.now       # slot never occupied
            if self.tables is not None:
                self.tables.release(slot)
            self._trace_request(rec, slot)
            self._note_finish(rec)
            return True
        self.slot_req[slot] = req
        self.slot_rec[slot] = rec
        self.slot_remaining[slot] = budget - 1
        self.slot_tokens[slot, 0] = first
        self._tokens_dirty = True           # host wrote a slot: re-upload
        return True

    def _score_candidates(self, slot: int, req: Request, logits_row) -> None:
        """Retrieval->rank: score the candidate set through the CF tables
        and fuse with the prompt's last-position logits.  Runs between
        prefill and the first-token stamp, so the CF time lands inside the
        req.prefill span and TTFT still equals the spans' sum."""
        t_cf = self.clock.now
        res = self._timed(
            getattr(self.clock, "fixed_cf_s", None),
            lambda: self.cf_head.score(req.user_id, req.candidates,
                                       lm_logits_row=logits_row))
        self.cf_results[req.rid] = res
        self.cf_scored += 1
        self.tracer.complete("cf.lookup", t_cf, self.clock.now,
                             track=f"slot{slot}", rid=req.rid,
                             hits=res["hits"], misses=res["misses"],
                             candidates=len(req.candidates))
        if self.metrics is not None:
            self.metrics.counter("cf_cache.hits").inc(res["hits"])
            self.metrics.counter("cf_cache.misses").inc(res["misses"])
            self.metrics.gauge("cf_cache.hit_rate").set(
                self.cf_head.hit_rate)
            self.metrics.gauge("cf_cache.rows").set(
                self.cf_head.cache_rows_live)

    def _refill(self) -> None:
        free = [s for s in range(self.ecfg.n_slots)
                if self.slot_req[s] is None]
        if self.ecfg.refill == "static" and len(free) < self.ecfg.n_slots:
            return                              # classical batch barrier
        for s in free:
            while self.queue and self.slot_req[s] is None:
                req, rec = self.queue.popleft()
                if self._start(s, req, rec):    # may finish instantly (EOS)
                    continue
                # paged admission failed: not enough free blocks.  An empty
                # pool that still cannot cover the request never will --
                # reject; otherwise park it at the queue head until
                # retiring slots return their blocks
                if self.pool is not None and self.pool.used_blocks == 0:
                    rec.rejected = True
                    self.tracer.instant("sched.reject", track="sched",
                                        rid=req.rid, reason="pool_too_small")
                    continue
                self.queue.pushback((req, rec))
                self.tracer.instant("sched.pushback", track="sched",
                                    rid=req.rid,
                                    free_blocks=self.pool.free_blocks)
                self._note_occupancy()
                return
        self._note_occupancy()

    def _note_occupancy(self) -> None:
        active = self.n_active
        self.max_concurrent = max(self.max_concurrent, active)
        if self.metrics is not None:
            self.metrics.gauge("engine.active_slots").set(
                active, t=self.clock.now)

    def _note_load(self) -> None:
        """Load gauges: queued work and the decode tokens still owed by
        active slots, stamped with this engine's clock."""
        if self.metrics is None:
            return
        t = self.clock.now
        self.metrics.gauge("engine.queue_depth").set(
            len(self.queue), t=t)
        inflight = int(sum(int(self.slot_remaining[s])
                           for s in range(self.ecfg.n_slots)
                           if self.slot_req[s] is not None))
        self.metrics.gauge("engine.in_flight_tokens").set(
            inflight, t=t)

    def _note_finish(self, rec: metrics_lib.RequestRecord) -> None:
        if self.win is not None and rec.tpot is not None:
            self.win.observe_tpot(rec.tpot)

    def _decode_once(self) -> None:
        if self.spec_k > 1:
            return self._spec_decode_once()
        if self.tables is not None:
            # make every active slot's KV frontier exclusively owned before
            # the step writes there: COW off shared tails, claim sole-owner
            # sealed blocks, then upload the changed tables once
            for s in range(self.ecfg.n_slots):
                if self.slot_req[s] is None:
                    continue
                cow = self.tables.ensure_writable(s, int(self._slot_len[s]))
                if cow is not None:
                    self.cache = self.backend.copy_block(self.cache, *cow)
                    self.tracer.instant("pool.cow", track="pool", slot=s,
                                        src=cow[0], dst=cow[1])
            self._sync_tables()
        if self._tokens_dirty or self._tokens_dev is None:
            self._tokens_dev = torch.as_tensor(self.slot_tokens,
                                               device=self.backend.device)
            self._tokens_dirty = False
        tokens = self._tokens_dev
        # span args (modeled bytes/FLOPs) are computed only when the tracer
        # is live: the disabled path stays one attribute check
        step_t0 = self.clock.now
        step_args = self._decode_model_args() if self.tracer.enabled else None
        logits, self.cache = self._timed(
            self.clock.fixed_decode_s,
            lambda: self.backend.decode(self.cache, tokens))
        if step_args is not None:
            self.tracer.complete("decode_step", step_t0, self.clock.now,
                                 track="engine", step=self.decode_steps,
                                 **step_args)
        self.decode_steps += 1
        self._kv_bytes_sum += self._resident_kv_bytes()
        nxt_dev = torch.argmax(logits[:, 0, :], dim=-1)
        nxt = nxt_dev.cpu().numpy()
        # the next step's inputs are already on the device
        self._tokens_dev = nxt_dev[:, None]
        for s in range(self.ecfg.n_slots):
            req, rec = self.slot_req[s], self.slot_rec[s]
            if req is None:
                continue
            tok = int(nxt[s])
            self.outputs[req.rid].append(tok)
            rec.tokens_out += 1
            self.slot_remaining[s] -= 1
            self.slot_tokens[s, 0] = tok
            self._slot_len[s] += 1          # this step's token landed
            if tok == req.eos_id or self.slot_remaining[s] <= 0:
                rec.finished = self.clock.now
                self.slot_req[s] = None
                self.slot_rec[s] = None
                if self.tables is not None:
                    self.tables.release(s)  # refcounts back to the pool
                self._trace_request(rec, s)
                self._note_finish(rec)
        self._note_load()

    def _spec_decode_once(self) -> None:
        """One speculative scheduler step: self-draft up to ``spec_k - 1``
        continuation tokens per greedy slot, verify all rows in one k-row
        decode, commit each slot's accepted prefix.  Greedy verification
        accepts exactly the prefix row-by-row decode would emit, so the
        streams equal one-token decode's.  A sampled slot would draft
        nothing (``submit`` refuses sampled requests for now)."""
        n, k = self.ecfg.n_slots, self.spec_k
        rows = np.full((n, k), self.ecfg.pad_id, np.int64)
        rows[:, 0] = self.slot_tokens[:, 0]
        q_lens = np.ones(n, np.int64)
        for s in range(n):
            req = self.slot_req[s]
            if req is None:
                continue
            # draft cap: the step writes q_len KV rows at len..len+q_len-1
            # (must fit max_len) and can emit at most the slot's remaining
            # budget
            cap = min(k - 1, int(self.slot_remaining[s]) - 1,
                      self.ecfg.max_len - 1 - int(self._slot_len[s]))
            if req.temperature > 0.0:
                cap = 0
            if cap > 0:
                draft = ngram_draft(
                    list(req.prompt) + self.outputs[req.rid], cap)
                rows[s, 1:1 + len(draft)] = draft
                q_lens[s] = 1 + len(draft)
        # the smallest power-of-two row count covering the longest draft
        # (1, 2, ... up to spec_k): short-draft steps pay near one-row cost
        k_step = 1
        while k_step < int(q_lens.max()):
            k_step *= 2
        k_step = min(k_step, k)
        if self.tables is not None:
            # own the whole write span up front: one pass per touched block
            for s in range(n):
                if self.slot_req[s] is None:
                    continue
                for src, dst in self.tables.ensure_writable_span(
                        s, int(self._slot_len[s]), int(q_lens[s])):
                    self.cache = self.backend.copy_block(self.cache,
                                                         src, dst)
                    self.tracer.instant("pool.cow", track="pool", slot=s,
                                        src=src, dst=dst)
            self._sync_tables()
        # one upload for the rows and q_lens (the last column), before the
        # timed call: the clock prices the model step, not the handoff
        packed = torch.as_tensor(
            np.concatenate([rows[:, :k_step], q_lens[:, None]], axis=1),
            device=self.backend.device)
        step_t0 = self.clock.now
        step_args = self._decode_model_args() if self.tracer.enabled else None
        live_rows = int(q_lens[[s for s in range(n)
                                if self.slot_req[s] is not None]].sum())
        if step_args:
            # FLOPs scale with the live rows; attn_read_bytes stays the
            # one-token figure (the cache streams once a step)
            step_args["model_flops"] *= live_rows / step_args["n_active"]
            step_args["spec_q_rows"] = live_rows
        logits, accepts_dev, self.cache = self._timed(
            self.clock.fixed_decode_s,
            lambda: self.backend.decode_spec(self.cache, packed[:, :-1],
                                             packed[:, -1]))
        self.decode_steps += 1
        self._kv_bytes_sum += self._resident_kv_bytes()
        # one device-to-host copy: every row's greedy token, then accepts
        host = torch.cat([torch.argmax(logits, dim=-1),
                          accepts_dev[:, None].long()], dim=1).cpu().numpy()
        emitted, accepts = host[:, :-1], host[:, -1]
        self._tokens_dirty = True       # the host builds the next drafts
        step_emitted = 0
        self.spec_slot_steps += sum(r is not None for r in self.slot_req)
        self.spec_rows += live_rows
        for s in range(n):
            req, rec = self.slot_req[s], self.slot_rec[s]
            if req is None:
                continue
            a = int(accepts[s])
            toks = [int(t) for t in emitted[s, :a]]
            # stop at the first EOS (the device cache over-commits the rows
            # behind it, but a finishing slot's state is discarded)
            eos_at = next((j for j, t in enumerate(toks)
                           if t == req.eos_id), None)
            if eos_at is not None:
                toks = toks[:eos_at + 1]
            self.outputs[req.rid].extend(toks)
            rec.tokens_out += len(toks)
            step_emitted += len(toks)
            self.slot_remaining[s] -= len(toks)
            self._slot_len[s] += a          # device KV frontier: accepts
            self.slot_tokens[s, 0] = toks[-1]
            if eos_at is not None or self.slot_remaining[s] <= 0:
                rec.finished = self.clock.now
                self.slot_req[s] = None
                self.slot_rec[s] = None
                if self.tables is not None:
                    self.tables.release(s)
                self._trace_request(rec, s)
                self._note_finish(rec)
        self._note_load()
        self.spec_tokens += step_emitted
        if step_args is not None:
            self.tracer.complete("decode_step", step_t0, self.clock.now,
                                 track="engine", step=self.decode_steps - 1,
                                 tokens_emitted=step_emitted, **step_args)
        if self.metrics is not None:
            self.metrics.counter("engine.spec_tokens").inc(step_emitted)

    # -- run loop ------------------------------------------------------------

    def run(self, requests: Sequence[Request]):
        """Serve a workload to completion.

        Returns (outputs {rid: [token, ...]}, records, summary-dict)."""
        reqs = sorted(requests, key=lambda r: r.arrival)
        i = 0
        while True:
            while i < len(reqs) and reqs[i].arrival <= self.clock.now:
                self.submit(reqs[i])
                i += 1
            self._refill()
            if self.n_active:
                self._decode_once()
                continue
            if self.queue:
                raise RuntimeError("scheduler stalled with queued work")
            if i < len(reqs):
                self.clock.advance(reqs[i].arrival - self.clock.now)
                continue
            break
        summary = metrics_lib.summarize(self.records, self.clock.now)
        summary["decode_steps"] = self.decode_steps
        summary["prefills"] = self.prefills
        summary["max_concurrent_slots"] = self.max_concurrent
        summary["kv_bytes_per_step"] = (
            self._kv_bytes_sum / max(self.decode_steps, 1))
        if self.spec_k > 1:
            summary["spec"] = {
                "k": self.spec_k,
                "draft": self.ecfg.spec_draft,
                "spec_tokens": self.spec_tokens,
                # per live slot-step: one-token decode == 1.0
                "accepted_tokens_per_step": (
                    self.spec_tokens / max(self.spec_slot_steps, 1)),
                # verify rows run per live slot-step (1 + mean draft)
                "verify_rows_per_step": (
                    self.spec_rows / max(self.spec_slot_steps, 1)),
            }
        if self.cf_head is not None:
            summary["cf"] = self.cf_head.summary()
            summary["cf"]["requests_scored_here"] = self.cf_scored
        if self.pool is not None:
            summary["paged"] = {
                "num_blocks": self.pool.num_blocks,
                "block_size": self.pool.block_size,
                "peak_used_blocks": self.pool.peak_used,
                "shared_hits": self.pool.shared_hits,
                "cow_events": self.pool.cow_events,
                "seal_count": self.pool.seal_count,
            }
        if self.tracer.enabled or self.metrics is not None:
            obs: Dict = {}
            if self.tracer.enabled:
                obs["span_counts"] = self.tracer.span_names()
                obs["trace_events"] = len(self.tracer.events)
            if self.metrics is not None:
                obs["metrics"] = self.metrics.snapshot()
            summary["obs"] = obs
        return self.outputs, self.records, summary


def serve(cfg, params, requests: Sequence[Request],
          ecfg: EngineConfig = EngineConfig(),
          ctx: Optional[tf.ModelCtx] = None,
          clock: Optional[Clock] = None, device=None):
    """One-call wrapper: build backend + engine on ``device`` (``cuda``
    unless asked otherwise), run, report."""
    layout = ecfg.layout
    # only an explicitly chosen layout overrides the ctx's decode impl
    explicit = layout != CacheLayout()
    backend = make_backend(cfg, params, ctx,
                           layout=layout if explicit else None,
                           prefill_chunk=ecfg.prefill_chunk, device=device)
    engine = ServingEngine(backend, ecfg, clock)
    return engine.run(requests)
