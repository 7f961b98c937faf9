"""Serving-side embedding lookups: a frequency-cached hot-row replica in
front of the table's gather or the sharded exchange (port of
``repro/embeddings/serving.py``).

Zipfian id traffic concentrates lookups on a small head of rows: a request
batch of C candidate ids mostly revisits the same few hundred hot items.
Under the row/col/2D sharding plans every one of those lookups pays a
cross-shard exchange (an all-reduce of (U, D) partials and/or an
all-to-all of column slices) even though the answer is the same bytes as
last request.  This module serves that head from a host-side replica and
sends only the cold tail to the device:

* :class:`FreqTracker` -- exact decayed-count popularity over row ids
  (counts halve every ``1/(1-decay)`` observations, so yesterday's hot head
  ages out).
* :class:`HotRowCache` -- a host-side copy of the top-K rows by decayed
  count, with an id -> slot map.  Rows are **exact copies** of the
  authoritative table rows, re-gathered at election and after table
  updates, so a cache hit is bit-identical to the gather.
* :class:`CachedLookup` -- the serving lookup over one table: partition the
  requested ids into hits (read from the replica, no device work) and
  misses, stitched back in request order.  Misses are gathered from the
  authoritative table on the device through ``ops.embedding_gather`` (the
  ``gather_rows`` CUDA kernel for a table on the card, its plain version
  on the CPU): the whole table under the replicated plan, this rank's
  shard through the sharded lookup (``embeddings/lookup.py``, padded to a
  bucket) under the others.  Rows-touched refresh
  (:func:`repro_torch.embeddings.update.rows_touched`) keeps the replica
  exact after trainer updates.

The sharded lookups are SPMD: every rank of the mesh calls the lookup with
the same ids (as JAX's single controller hands the same ids to all its
devices) and keeps the same replica.  ``col`` plans split the padded ids
over ``data`` and the result is all-gathered over ``data``, so every rank
returns all of ``table[ids]``.  The sharded lookup is bit-identical to a
replicated gather (the all-reduce adds exact-zero partials from non-owner
shards, the all-to-all is data movement), so cached and uncached lookups
agree bit for bit under every plan.

The tracker, the replica and the id -> slot map are host-side numpy, as in
the JAX package; the authoritative table (or this rank's shard of it) is a
float32 tensor on the lookup's device, with a full host copy that
elections and refreshes read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hierarchical as hier
from repro_torch.embeddings.lookup import make_sharded_lookup
from repro_torch.embeddings.table import (EmbedPlan, EmbedSpec, make_plan,
                                          named_sharding)
from repro_torch.embeddings.update import rows_touched
from repro_torch.kernels import ops

DECAY = 0.98          # per-observation count decay of the hot-row tracker
DP_AXIS = "data"      # the axis the sharded miss path splits its ids over


class FreqTracker:
    """Exact decayed-count row popularity (host side, numpy).

    ``observe`` decays every count by ``decay`` then adds 1 per requested
    id; ``top_k`` returns the hottest row ids (sorted, count > 0 only) --
    the election set for :class:`HotRowCache`.
    """

    def __init__(self, n_rows: int, decay: float = DECAY):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.n_rows = n_rows
        self.decay = decay
        self.counts = np.zeros(n_rows, np.float64)

    def observe(self, ids: np.ndarray) -> None:
        flat = np.asarray(ids, np.int64).reshape(-1)
        self.counts *= self.decay
        np.add.at(self.counts, flat, 1.0)

    def top_k(self, k: int) -> np.ndarray:
        k = min(int(k), self.n_rows)
        if k <= 0:
            return np.empty(0, np.int64)
        idx = np.argpartition(-self.counts, k - 1)[:k]
        idx = idx[self.counts[idx] > 0.0]
        return np.sort(idx.astype(np.int64))


class HotRowCache:
    """Host-side copy of the top-K hottest rows of one table.

    ``rows[slot_of[id]]`` is a byte copy of ``table[id]``.  ``refresh``
    re-elects the head from the tracker; ``refresh_touched`` re-gathers only
    the cached rows a table update touched (the trainer's rows-touched
    set), restoring bit-exactness without a full re-election.
    """

    def __init__(self, n_rows: int, capacity: int, decay: float = DECAY):
        self.capacity = int(capacity)
        self.tracker = FreqTracker(n_rows, decay)
        self.ids = np.empty(0, np.int64)
        self.slot_of: Dict[int, int] = {}
        self.rows = np.empty((0, 0), np.float32)
        self.hits = 0
        self.misses = 0

    @property
    def n_cached(self) -> int:
        return len(self.ids)

    def refresh(self, host_table: np.ndarray) -> None:
        """Re-elect the top-K head; gather rows only for newly elected ids.
        Rows already cached keep their bytes (election moves the membership
        set, not the data), which is what makes the rows-touched refresh
        after updates load-bearing."""
        new_ids = self.tracker.top_k(self.capacity)
        rows = np.empty((len(new_ids), host_table.shape[1]), np.float32)
        held = np.fromiter((self.slot_of.get(int(i), -1) for i in new_ids),
                           np.int64, count=len(new_ids))
        keep = held >= 0
        if keep.any():
            rows[keep] = self.rows[held[keep]]
        if (~keep).any():
            rows[~keep] = host_table[new_ids[~keep]]
        self.ids = new_ids
        self.slot_of = {int(i): s for s, i in enumerate(new_ids)}
        self.rows = rows

    def refresh_touched(self, touched: np.ndarray,
                        host_table: np.ndarray) -> None:
        """Re-gather cached rows intersecting ``touched`` (unique row ids
        from the update batch); untouched cache slots keep their bytes."""
        if not len(self.ids):
            return
        stale = np.isin(self.ids, np.asarray(touched, np.int64))
        if stale.any():
            self.rows[stale] = host_table[self.ids[stale]]

    def plan_lookup(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(hit mask, cache slot per id; -1 on miss) + hit/miss counters."""
        flat = np.asarray(ids, np.int64).reshape(-1)
        slots = np.fromiter((self.slot_of.get(int(i), -1) for i in flat),
                            np.int64, count=len(flat))
        hit = slots >= 0
        self.hits += int(hit.sum())
        self.misses += int((~hit).sum())
        return hit, slots


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Knobs of the hot-row replica on one serving lookup."""

    rows: int = 0                  # cache capacity (0 = cache off)
    decay: float = DECAY           # per-observation count decay
    elect_every: int = 1           # lookups between head re-elections
    miss_quantum: int = 8          # miss-path pad bucket (x dp size)


def host_copy(table) -> np.ndarray:
    """A writable C-order float32 host copy of a numpy array or tensor."""
    if isinstance(table, torch.Tensor):
        table = table.detach().to("cpu", torch.float32).numpy()
    return np.array(table, dtype=np.float32, order="C")


class CachedLookup:
    """One table's serving lookup: hot-row replica first, the device gather
    (or the sharded exchange) only for the cold tail.

    ``table`` is the authoritative (rows, dim) table (numpy or a tensor),
    placed by ``plan``.
    With a ``mesh`` (a :class:`~repro_torch.core.hierarchical.DPMesh` over
    the initialised world) and a sharded plan, this rank keeps its shard
    of the table, cut by the plan's spec, as a float32 tensor on
    ``device`` (``cuda`` unless asked otherwise); otherwise the whole
    table.  ``lookup(ids) -> (n, D) float32`` equals ``table[ids]``
    exactly, plus per-call hit/miss stats; under a sharded plan every rank
    calls it with the same ids.  The sharded miss path splits its ids over
    ``data`` (:data:`DP_AXIS`; a column axis other than that raises, as in
    the JAX package) and pads them to a bucket (a power-of-two multiple of
    the ``data`` size times ``miss_quantum``), so it sees a handful of
    shapes.
    """

    def __init__(self, spec: EmbedSpec, plan: EmbedPlan, table, device=None,
                 cache: CacheConfig = CacheConfig(), mesh=None):
        self.spec, self.plan, self.ccfg = spec, plan, cache
        self.device = resolve_device(device)
        # always copy: update_rows writes the host copy in place
        self._host = host_copy(table)
        if self._host.shape != (spec.rows, spec.dim):
            raise ValueError(f"{spec.name}: table shape {self._host.shape} "
                             f"!= spec ({spec.rows}, {spec.dim})")
        self.mesh = mesh
        self._ndp = 1
        self._sharded = None
        if mesh is not None and plan.kind != "replicated":
            self._sharded = make_sharded_lookup(mesh, spec, plan, DP_AXIS,
                                                use_kernel=True)
            self._ndp = mesh.shape.get(DP_AXIS, 1)
            self._placement = named_sharding(mesh, plan)
        self._sync_device()
        self.cache = (HotRowCache(spec.rows, cache.rows, cache.decay)
                      if cache.rows > 0 else None)
        self.calls = 0
        self.exchanged_ids = 0          # ids that took the device path

    # -- cache bookkeeping ---------------------------------------------------

    @property
    def hits(self) -> int:
        return self.cache.hits if self.cache else 0

    @property
    def misses(self) -> int:
        return self.cache.misses if self.cache else 0

    @property
    def n_cached(self) -> int:
        return self.cache.n_cached if self.cache else 0

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    # -- the lookup ----------------------------------------------------------

    def _miss_bucket(self, n: int) -> int:
        """Few miss-path shapes: the next power-of-two multiple of
        (quantum x DP size); col plans split the id vector over the DP
        axis, so the padded count must divide by it."""
        q = max(1, self.ccfg.miss_quantum) * self._ndp
        b = q
        while b < n:
            b *= 2
        return b

    def _exchange(self, ids: np.ndarray) -> np.ndarray:
        """table[ids] gathered on the device (one ``gather_rows`` launch on
        the card: on the whole table, or on this rank's shard inside the
        sharded lookup), back on the host."""
        n = len(ids)
        if self._sharded is None:
            ids_dev = torch.as_tensor(ids, dtype=torch.int32,
                                      device=self.device)
            out = ops.embedding_gather(self._table_dev, ids_dev)
            self.exchanged_ids += n
            return out.cpu().numpy()
        pad = self._miss_bucket(n)
        padded = np.zeros(pad, np.int32)
        padded[:n] = ids
        ids_dev = torch.as_tensor(padded, device=self.device)
        with torch.no_grad():
            out = self._sharded(self._table_dev, ids_dev)
            if self._ndp > 1:       # every rank returns every row
                out = hier.gather_dim(out, self.mesh, (DP_AXIS,), 0)
        self.exchanged_ids += pad
        return out.cpu().numpy()[:n]

    def __call__(self, ids) -> Tuple[np.ndarray, Dict[str, int]]:
        """(rows (n, D) float32 == table[ids] bit-for-bit, stats)."""
        flat = np.asarray(ids, np.int64).reshape(-1)
        self.calls += 1
        if self.cache is None:
            rows = self._exchange(flat)
            return rows, {"hits": 0, "misses": len(flat)}
        self.cache.tracker.observe(flat)
        hit, slots = self.cache.plan_lookup(flat)
        rows = np.empty((len(flat), self.spec.dim), np.float32)
        if hit.any():
            rows[hit] = self.cache.rows[slots[hit]]
        n_miss = int((~hit).sum())
        if n_miss:
            rows[~hit] = self._exchange(flat[~hit])
        if self.ccfg.elect_every and \
                self.calls % self.ccfg.elect_every == 0:
            self.cache.refresh(self._host)
        return rows, {"hits": int(hit.sum()), "misses": n_miss}

    # -- table updates / staleness -------------------------------------------

    def _sync_device(self) -> None:
        """The device table from the host copy: this rank's shard, re-cut
        by the plan's spec, under a sharded plan."""
        full = torch.from_numpy(self._host)
        if self._sharded is not None:
            full = self._placement.shard(full)
        self._table_dev = full.to(self.device, copy=True).contiguous()

    def update_rows(self, ids, rows, refresh: bool = True) -> np.ndarray:
        """Land a trainer update: ``table[ids] = rows`` (duplicate ids: last
        write wins, matching a sequential scatter).  With ``refresh`` the
        cached copies of the touched rows are re-gathered immediately (the
        rows-touched hook); ``refresh=False`` leaves the replica stale until
        :meth:`refresh_touched`.  Returns the unique touched-row ids."""
        flat = np.asarray(ids, np.int64).reshape(-1)
        self._host[flat] = np.asarray(rows, np.float32)
        self._sync_device()
        touched = rows_touched(torch.as_tensor(flat),
                               self.spec.rows).numpy()
        touched = touched[touched < self.spec.rows]
        if refresh:
            self.refresh_touched(touched)
        return touched

    def refresh_touched(self, touched) -> None:
        """Rows-touched cache refresh: restore bit-exactness for the cached
        rows a table update invalidated."""
        if self.cache is not None:
            self.cache.refresh_touched(np.asarray(touched, np.int64),
                                       self._host)

    def summary(self) -> Dict:
        return {
            "table": self.spec.name, "plan": self.plan.kind,
            "cache_rows": self.ccfg.rows, "cached_now": self.n_cached,
            "hits": self.hits, "misses": self.misses,
            "hit_rate": self.hit_rate,
            "lookups": self.calls, "exchanged_ids": self.exchanged_ids,
        }


def make_cached_lookup(name: str, table, kind: str = "replicated",
                       device=None, cache: CacheConfig = CacheConfig(),
                       mesh=None, row_axis: str = "model",
                       col_axis: str = "data") -> CachedLookup:
    """Convenience: spec from the table's shape, plan from ``kind``."""
    t = host_copy(table)
    spec = EmbedSpec(name, rows=t.shape[0], dim=t.shape[1])
    plan = make_plan(kind, row_axis=row_axis, col_axis=col_axis)
    return CachedLookup(spec, plan, t, device=device, cache=cache,
                        mesh=mesh)
