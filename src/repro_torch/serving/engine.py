"""Fixed-slot continuous-batching serving engine (port of
``repro/serving/engine.py``, the dense greedy slice).

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

This slice serves greedy decode over a dense 16-bit cache with one token
per step.  Everything else raises ``NotImplementedError`` rather than being
ignored: sampled requests (``temperature > 0``), paged and int8 layouts,
``spec_k > 1``, ``prefill_chunk > 0``, a CF head, tracer/metrics
registries, and prefill/decode engine roles (``ROADMAP.md`` queues them).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cache_layout import CacheLayout, require_dense16
from repro_torch.models import transformer as tf
from repro_torch.serving import metrics as metrics_lib
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


def _bucket(n: int, quantum: int, cap: int) -> int:
    return min(cap, ((n + quantum - 1) // quantum) * quantum)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md)")


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


class SlotBackend:
    """A model behind the slot protocol: ``init_slots`` (slot-indexed state),
    ``prefill`` (one request's prompt into one slot, returning that slot's
    last-position logits) and ``decode`` (one token for every slot).  The
    state is updated in place on ``device``."""

    def __init__(self, cfg, params, ctx: Optional[tf.ModelCtx] = None,
                 decode_impl: Optional[str] = None, device=None):
        tf.check_ported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"backend runs on {self.device}")
        self.cfg, self.params = cfg, params
        self.ctx = ctx if ctx is not None else tf.ModelCtx(attn_chunk=8)
        if decode_impl is not None:
            self.ctx = dataclasses.replace(self.ctx, decode_impl=decode_impl)

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

    def _prefill_impl(self, params, cache, tokens, true_len, slot):
        return tf.prefill_into_slot(self.cfg, params, cache, tokens,
                                    true_len, slot, self.ctx)


def make_backend(cfg, params, ctx: Optional[tf.ModelCtx] = None,
                 prefill_chunk: int = 0, *,
                 layout: Optional[CacheLayout] = None, device=None):
    """Backend for ``layout`` (dense 16-bit in this slice).  ``layout.impl``
    overrides the decode-attention path of ``ctx`` only when a layout was
    passed explicitly, as in the JAX package."""
    explicit = layout is not None
    if layout is None:
        layout = CacheLayout()
    require_dense16(layout)
    return NativeBackend(cfg, params, ctx, layout.impl if explicit else None,
                         prefill_chunk, device=device)


def _decode_state_bytes(cfg, cache_len: int) -> float:
    """Modeled resident KV bytes of one dense 16-bit slot (the JAX serving
    roofline's ``decode_state_bytes`` for attention layers: k and v at 2
    bytes an element, whatever the model dtype)."""
    return float(cfg.num_layers * cache_len * 2 * cfg.num_kv_heads
                 * 2 * cfg.head_dim)


class ServingEngine:
    """Slot scheduler over a backend exposing init_slots/prefill/decode."""

    def __init__(self, backend, ecfg: EngineConfig = EngineConfig(),
                 clock: Optional[Clock] = None, tracer=None, metrics=None,
                 *, role: str = "both", cf_head=None):
        if role != "both":
            raise _not_ported(f"engine role {role!r}")
        if tracer is not None or metrics is not None:
            raise _not_ported("tracer/metrics wiring")
        if cf_head is not None:
            raise _not_ported("the CF head")
        if ecfg.spec_k > 1:
            raise _not_ported("speculative decode (spec_k > 1)")
        if ecfg.prefill_chunk:
            raise _not_ported("streaming (chunked) prefill")
        require_dense16(ecfg.layout)
        self.backend, self.ecfg = backend, ecfg
        self.clock = clock if clock is not None else Clock()
        n = ecfg.n_slots
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
        self.max_concurrent = 0
        self._kv_bytes_sum = 0.0

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

    def _resident_kv_bytes(self) -> float:
        """Modeled resident decode-state bytes (every slot at max_len)."""
        cfg = getattr(self.backend, "cfg", None)
        if cfg is None:
            return 0.0
        return self.ecfg.n_slots * _decode_state_bytes(cfg, self.ecfg.max_len)

    # -- scheduler ops -------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Enqueue; False (and a rejected record) when the bounded admission
        queue is full or the prompt cannot fit the serving window.  At
        saturation an interactive arrival sheds the newest batch-tier
        entry instead of being dropped."""
        if req.temperature > 0.0:
            raise _not_ported(f"sampled decode (request {req.rid} has "
                              f"temperature {req.temperature})")
        if req.frames is not None or req.grid is not None \
                or req.candidates is not None:
            raise _not_ported(f"request {req.rid}'s encoder frames / patch "
                              "grid / candidate set")
        rec = metrics_lib.RequestRecord(
            rid=req.rid, user_id=req.user_id, prompt_len=len(req.prompt),
            slo_name=req.slo.name, ttft_slo_s=req.slo.ttft_ms / 1e3,
            tpot_slo_s=req.slo.tpot_ms / 1e3, arrival=req.arrival)
        self.records.append(rec)
        if len(req.prompt) >= self.ecfg.max_len:
            rec.rejected = True
            return False
        if len(self.queue) >= self.ecfg.queue_capacity:
            shed = (self.queue.shed_batch()
                    if req.slo.name == "interactive" else None)
            if shed is None:
                rec.rejected = True
                return False
            shed[1].rejected = True         # the batch-tier request it evicts
        self.queue.append((req, rec))
        return True

    def _start(self, slot: int, req: Request,
               rec: metrics_lib.RequestRecord) -> None:
        """Prefill-on-arrival into one slot; the first generated token falls
        out of the prefill logits."""
        prompt = np.asarray(req.prompt, np.int64)
        rec.admitted = self.clock.now
        s_pad = _bucket(len(prompt), self.ecfg.prompt_quantum,
                        self.ecfg.max_len)
        padded = np.full((1, s_pad), self.ecfg.pad_id, np.int64)
        padded[0, :len(prompt)] = prompt
        logits_row, self.cache = self._timed(
            self.clock.fixed_prefill_s,
            lambda: self.backend.prefill(self.cache, padded, len(prompt),
                                         slot))
        self.prefills += 1
        first = int(torch.argmax(logits_row))   # first maximum, as jnp
        rec.first_token = self.clock.now
        rec.tokens_out = 1
        self.outputs[req.rid] = [first]
        budget = min(req.max_new_tokens, self.ecfg.max_len - len(prompt))
        if first == req.eos_id or budget <= 1:
            rec.finished = self.clock.now       # slot never occupied
            return
        self.slot_req[slot] = req
        self.slot_rec[slot] = rec
        self.slot_remaining[slot] = budget - 1
        self.slot_tokens[slot, 0] = first
        self._tokens_dirty = True           # host wrote a slot: re-upload

    def _refill(self) -> None:
        free = [s for s in range(self.ecfg.n_slots)
                if self.slot_req[s] is None]
        if self.ecfg.refill == "static" and len(free) < self.ecfg.n_slots:
            return                              # classical batch barrier
        for s in free:
            while self.queue and self.slot_req[s] is None:
                req, rec = self.queue.popleft()
                self._start(s, req, rec)        # may finish instantly (EOS)
        self.max_concurrent = max(self.max_concurrent, self.n_active)

    def _decode_once(self) -> None:
        if self._tokens_dirty or self._tokens_dev is None:
            self._tokens_dev = torch.as_tensor(self.slot_tokens,
                                               device=self.backend.device)
            self._tokens_dirty = False
        tokens = self._tokens_dev
        logits, self.cache = self._timed(
            self.clock.fixed_decode_s,
            lambda: self.backend.decode(self.cache, tokens))
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
            if tok == req.eos_id or self.slot_remaining[s] <= 0:
                rec.finished = self.clock.now
                self.slot_req[s] = None
                self.slot_rec[s] = None

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
