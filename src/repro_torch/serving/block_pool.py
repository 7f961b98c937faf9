"""Shared KV block pool with refcounted prefix sharing and copy-on-write
(a copy of ``repro/serving/block_pool.py``, numpy only).

The paged cache layout splits a slot's KV rows into fixed-size blocks that
live in one shared pool tensor ``(num_blocks, block_size, ...)`` per pooled
leaf; each serving slot owns only a *block table* -- a row of physical block
ids covering its virtual positions.  Three host-side pieces:

:class:`BlockPool`
    alloc/free with per-block refcounts, plus a hash index over *sealed*
    blocks (immutable, content-addressed by a chained prompt-block hash) so
    a new request whose prompt prefix was already prefilled can adopt the
    existing physical blocks instead of recomputing and re-storing them.

:class:`SlotTables`
    the per-slot **read** and **write** tables.  The read table is what the
    attention kernels consume; the write table redirects any store into a
    block the slot does not exclusively own to the reserved *null block 0*
    (a garbage sink -- sealed prefix blocks are therefore physically
    immutable while shared).  Copy-on-write happens lazily at the first
    divergent token: :meth:`SlotTables.ensure_writable` notices the frontier
    block is shared, allocates a private copy destination, and reports the
    ``(src, dst)`` pair for the device-side block copy.

:func:`prefix_keys`
    the chained content hash: block ``i``'s key commits to every token of
    blocks ``0..i`` (and a seed), so equal keys imply equal live KV content
    given the deterministic prefill path.  A *tail key* covering the whole
    prompt lets two requests with identical complete prompts share even the
    final partial block -- the case that exercises COW on the very first
    generated token.

Everything here is plain Python/numpy on the host; the device only ever
sees the (n_slots, blocks_per_slot) int32 tables and pooled leaf tensors.
The JAX package's speculative span writes (``ensure_writable_span``) and
slot export/import for disaggregated serving are not ported yet
(``ROADMAP.md``).
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["NULL_BLOCK", "BlockPool", "SlotTables", "prefix_keys"]

NULL_BLOCK = 0


def _chain(prev: int, payload) -> int:
    h = hashlib.blake2b(repr((prev, payload)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def prefix_keys(prompt: Sequence[int], block_size: int,
                seed: object = None) -> Tuple[List[int], Optional[int]]:
    """Content keys for a prompt: one per *complete* block (chained, so key
    ``i`` commits to all tokens ``<= (i+1)*block_size``), plus a tail key
    covering the whole prompt when it ends mid-block (None on an exact
    block boundary).  ``seed`` distinguishes cache namespaces — model
    identity, and for encoder-decoder families a digest of the encoder
    frames, since whisper's self-KV rows depend on the prompt alone but
    live alongside per-request cross-state the scheduler must not mix."""
    prompt = [int(t) for t in prompt]
    acc = _chain(0, seed)
    keys = []
    n_full = len(prompt) // block_size
    for i in range(n_full):
        acc = _chain(acc, tuple(prompt[i * block_size:(i + 1) * block_size]))
        keys.append(acc)
    rem = prompt[n_full * block_size:]
    tail = _chain(acc, ("tail", tuple(rem))) if rem else None
    return keys, tail


class BlockPool:
    """Refcounted allocator over ``num_blocks`` physical blocks.

    Block 0 is the reserved null sink: never allocated, never freed; dead
    or redirected table entries point at it.  ``cow_debt`` counts shared
    *tail* adoptions whose private copy has not happened yet — each one
    will need a block at its first divergent token, so :meth:`can_alloc`
    holds that many blocks back to make the deferred copy infallible."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is the null sink)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.refcount = np.zeros(self.num_blocks, np.int32)
        self.refcount[NULL_BLOCK] = 1        # permanently resident
        self._free = deque(range(1, self.num_blocks))
        self._by_hash = {}                   # key -> sealed block id
        self._hash_of = {}                   # sealed block id -> key
        self.cow_debt = 0
        # stats (surfaced in the serve artifact)
        self.peak_used = 0
        self.shared_hits = 0
        self.cow_events = 0
        self.seal_count = 0
        # optional obs registry mirror (attach_metrics)
        self._metrics = None
        self._mprefix = "pool"
        self._mclock = None

    def attach_metrics(self, registry, prefix: str = "pool",
                       clock=None) -> None:
        """Mirror pool occupancy and sharing stats into an obs
        :class:`~repro_torch.obs.metrics.MetricsRegistry`: a
        ``{prefix}.used_blocks`` gauge (its ``peak`` tracks ``peak_used``)
        plus ``shared_hits`` / ``cow_events`` / ``seal_count`` counters.
        The gauge series is stamped by the registry's clock -- the engine
        pins that to its simulated clock, so the occupancy timeline aligns
        with the request spans.  ``clock`` overrides the registry clock for
        the gauge stamps."""
        self._metrics = registry
        self._mprefix = prefix
        self._mclock = clock
        self._sync_metrics()

    def _sync_metrics(self) -> None:
        m, p = self._metrics, self._mprefix
        if m is None:
            return
        m.gauge(f"{p}.used_blocks").set(
            self.used_blocks,
            t=self._mclock() if self._mclock is not None else None)
        m.counter(f"{p}.shared_hits").value = float(self.shared_hits)
        m.counter(f"{p}.cow_events").value = float(self.cow_events)
        m.counter(f"{p}.seal_count").value = float(self.seal_count)

    def note_shared_hit(self) -> None:
        """One prefix-share adoption (called by :class:`SlotTables`)."""
        self.shared_hits += 1
        self._sync_metrics()

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) - self.cow_debt >= n

    def alloc(self, *, for_cow: bool = False) -> int:
        """Pop one free block at refcount 1.  ``for_cow=True`` spends a
        reserved debt slot (always succeeds while the invariant holds)."""
        if not self._free:
            raise RuntimeError("block pool exhausted (reservation bug)")
        b = self._free.popleft()
        self.refcount[b] = 1
        self.peak_used = max(self.peak_used, self.used_blocks)
        if for_cow:
            self.cow_events += 1
        self._sync_metrics()
        return b

    def incref(self, b: int) -> None:
        if b != NULL_BLOCK:
            self.refcount[b] += 1

    def decref(self, b: int) -> None:
        if b == NULL_BLOCK:
            return
        self.refcount[b] -= 1
        if self.refcount[b] < 0:
            raise RuntimeError(f"refcount underflow on block {b}")
        if self.refcount[b] == 0:
            key = self._hash_of.pop(b, None)
            if key is not None and self._by_hash.get(key) == b:
                del self._by_hash[key]
            self._free.append(b)
            self._sync_metrics()

    def seal(self, b: int, key: int) -> None:
        """Publish block ``b`` under content ``key`` (first writer wins;
        a racing duplicate simply stays private and retires normally)."""
        if key not in self._by_hash and b not in self._hash_of:
            self._by_hash[key] = b
            self._hash_of[b] = key
            self.seal_count += 1
            self._sync_metrics()

    def lookup(self, key: int) -> Optional[int]:
        return self._by_hash.get(key)

    def is_sealed(self, b: int) -> bool:
        return b in self._hash_of


class SlotTables:
    """Per-slot read/write block tables over one :class:`BlockPool`.

    ``read[s, i]`` is the physical block backing slot ``s``'s virtual block
    ``i`` — what the paged attention kernels index.  ``write[s, i]`` is
    where *stores* for that virtual block go: equal to ``read`` when the
    slot exclusively owns the block, else :data:`NULL_BLOCK` so scatters
    into shared (sealed) blocks land in the garbage sink.  ``dirty`` flips
    whenever either table changes, so the engine re-uploads to device only
    on mutation."""

    def __init__(self, pool: BlockPool, n_slots: int, blocks_per_slot: int):
        self.pool = pool
        self.n_slots = int(n_slots)
        self.blocks_per_slot = int(blocks_per_slot)
        self.read = np.full((n_slots, blocks_per_slot), NULL_BLOCK, np.int32)
        self.write = np.full((n_slots, blocks_per_slot), NULL_BLOCK, np.int32)
        # virtual-block index of a shared tail adopted at admit() and not
        # yet resolved (COW'd / claimed); -1 when none.  Each pending tail
        # accounts for one unit of pool.cow_debt.
        self._pending_tail = np.full(n_slots, -1, np.int64)
        # keys of blocks this slot computed itself, sealed after prefill
        self._own_keys = [None] * n_slots
        self.dirty = True

    # -- admission ---------------------------------------------------------

    def admit(self, slot: int, full_keys: Sequence[int],
              tail_key: Optional[int], span_blocks: int) -> bool:
        """Map ``span_blocks`` virtual blocks for ``slot``: adopt the
        longest sealed prefix chain (shared, read-only), then allocate
        private blocks for the rest.  Returns False — with *nothing*
        mutated — when the pool cannot cover the private blocks plus the
        standing COW reservation; the engine requeues the request."""
        assert span_blocks <= self.blocks_per_slot
        shared = 0
        for k in full_keys:
            if self.pool.lookup(k) is None:
                break
            shared += 1
        tail_block = None
        if (tail_key is not None and shared == len(full_keys)
                and shared < span_blocks):
            tail_block = self.pool.lookup(tail_key)
        # a shared tail trades an alloc now for one unit of cow_debt, so the
        # net requirement is unchanged: span - shared full blocks
        new_needed = span_blocks - shared - (1 if tail_block is not None else 0)
        reserve = 1 if tail_block is not None else 0
        if len(self.pool._free) - self.pool.cow_debt < new_needed + reserve:
            return False
        row_r, row_w = self.read[slot], self.write[slot]
        for i in range(shared):
            b = self.pool.lookup(full_keys[i])
            self.pool.incref(b)
            row_r[i], row_w[i] = b, NULL_BLOCK
            self.pool.note_shared_hit()
        nxt = shared
        if tail_block is not None:
            self.pool.incref(tail_block)
            row_r[nxt], row_w[nxt] = tail_block, NULL_BLOCK
            self._pending_tail[slot] = nxt
            self.pool.cow_debt += 1
            self.pool.note_shared_hit()
            nxt += 1
        for i in range(nxt, span_blocks):
            b = self.pool.alloc()
            row_r[i], row_w[i] = b, b
        self._own_keys[slot] = (list(full_keys[shared:]),
                                tail_key if tail_block is None else None,
                                shared, span_blocks)
        self.dirty = True
        return True

    def seal_prompt(self, slot: int) -> None:
        """After prefill lands, publish this slot's self-computed complete
        prompt blocks (and whole-prompt tail) in the pool's hash index so
        later identical prefixes share them."""
        if self._own_keys[slot] is None:
            return
        keys, tail_key, start, span = self._own_keys[slot]
        row = self.read[slot]
        for j, k in enumerate(keys):
            self.pool.seal(int(row[start + j]), k)
        if tail_key is not None and start + len(keys) < span:
            self.pool.seal(int(row[start + len(keys)]), tail_key)
        self._own_keys[slot] = None

    # -- write path --------------------------------------------------------

    def ensure_writable(self, slot: int,
                        pos: int) -> Optional[Tuple[int, int]]:
        """Make virtual position ``pos`` of ``slot`` writable before the
        next token lands there.  Three cases:

        * already exclusively owned — no-op, returns None;
        * shared with others (refcount > 1) — **copy-on-write**: allocate a
          private block from the COW reserve and return ``(src, dst)`` so
          the engine copies the block's rows on device before redirecting;
        * sole owner of a previously-shared block (other sharers retired or
          COW'd away) — claim it in place, no copy needed.
        """
        return self._ensure_block(slot, pos // self.pool.block_size)

    def ensure_writable_span(self, slot: int, start: int,
                             count: int) -> List[Tuple[int, int]]:
        """Make the ``count`` virtual positions ``[start, start + count)``
        writable in one pass -- the multi-token (speculative) twin of
        :meth:`ensure_writable`.  Each touched block is resolved once, so a
        k-token span costs at most one copy per distinct block it crosses.
        Returns the (src, dst) COW pairs the engine must copy on device,
        oldest block first."""
        if count <= 0:
            return []
        bs = self.pool.block_size
        pairs = []
        for i in range(start // bs, (start + count - 1) // bs + 1):
            pair = self._ensure_block(slot, i)
            if pair is not None:
                pairs.append(pair)
        return pairs

    def _ensure_block(self, slot: int,
                      i: int) -> Optional[Tuple[int, int]]:
        b = int(self.read[slot, i])
        if b != NULL_BLOCK and int(self.write[slot, i]) == b:
            return None
        out = None
        if b == NULL_BLOCK:
            dst = self.pool.alloc(for_cow=self._pending_tail[slot] == i)
            self.read[slot, i] = self.write[slot, i] = dst
        elif int(self.pool.refcount[b]) > 1:
            dst = self.pool.alloc(for_cow=True)
            self.read[slot, i] = self.write[slot, i] = dst
            self.pool.decref(b)
            out = (b, dst)
        else:
            # sole owner of a sealed block: un-publish and claim in place
            key = self.pool._hash_of.pop(b, None)
            if key is not None and self.pool._by_hash.get(key) == b:
                del self.pool._by_hash[key]
            self.write[slot, i] = b
        if self._pending_tail[slot] == i:
            self._pending_tail[slot] = -1
            self.pool.cow_debt -= 1
        self.dirty = True
        return out

    # -- retirement --------------------------------------------------------

    def release(self, slot: int) -> None:
        for i in range(self.blocks_per_slot):
            b = int(self.read[slot, i])
            if b != NULL_BLOCK:
                self.pool.decref(b)
        self.read[slot].fill(NULL_BLOCK)
        self.write[slot].fill(NULL_BLOCK)
        if self._pending_tail[slot] >= 0:
            self._pending_tail[slot] = -1
            self.pool.cow_debt -= 1
        self._own_keys[slot] = None
        self.dirty = True
