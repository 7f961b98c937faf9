"""Serving-side embedding lookups: a frequency-cached hot-row replica in
front of the table's gather (port of ``repro/embeddings/serving.py``, the
replicated plan).

Zipfian id traffic concentrates lookups on a small head of rows: a request
batch of C candidate ids mostly revisits the same few hundred hot items.
This module serves that head from a host-side replica and sends only the
cold tail to the device:

* :class:`FreqTracker` -- exact decayed-count popularity over row ids
  (counts halve every ``1/(1-decay)`` observations, so yesterday's hot head
  ages out).
* :class:`HotRowCache` -- a host-side copy of the top-K rows by decayed
  count, with an id -> slot map.  Rows are **exact copies** of the
  authoritative table rows, re-gathered at election and after table
  updates, so a cache hit is bit-identical to the gather.
* :class:`CachedLookup` -- the serving lookup over one table: partition the
  requested ids into hits (read from the replica, no device work) and
  misses (gathered from the authoritative table on the device through
  ``ops.embedding_gather``: the ``gather_rows`` CUDA kernel for a table on
  the card, its plain version on the CPU), stitched back in request order.
  Rows-touched refresh (:func:`repro_torch.embeddings.update.rows_touched`)
  keeps the replica exact after trainer updates.

The tracker, the replica and the id -> slot map are host-side numpy, as in
the JAX package; the authoritative table is a float32 tensor on the
lookup's device, with a host copy that elections and refreshes read.  The
row / column / 2-D sharded plans (the JAX package's shard_map exchange) are
not ported yet (``ROADMAP.md``): any plan but ``"replicated"`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.embeddings.table import EmbedSpec
from repro_torch.embeddings.update import rows_touched
from repro_torch.kernels import ops

PLANS = ("replicated",)
DECAY = 0.98          # per-observation count decay of the hot-row tracker


def check_plan(kind: str) -> None:
    """Raise for a placement plan the port does not serve."""
    if kind not in PLANS:
        raise NotImplementedError(
            f"the {kind!r} embedding plan is not ported yet (the port "
            "serves the replicated plan; see ROADMAP.md)")


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

    def __init__(self, n_rows: int, capacity: int):
        self.capacity = int(capacity)
        self.tracker = FreqTracker(n_rows)
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
    """The hot-row replica on one serving lookup: its capacity.  The head
    is re-elected after every lookup, with counts decayed by ``DECAY``."""

    rows: int = 0                  # cache capacity (0 = cache off)


def host_copy(table) -> np.ndarray:
    """A writable C-order float32 host copy of a numpy array or tensor."""
    if isinstance(table, torch.Tensor):
        table = table.detach().to("cpu", torch.float32).numpy()
    return np.array(table, dtype=np.float32, order="C")


class CachedLookup:
    """One table's serving lookup: hot-row replica first, the device gather
    only for the cold tail.

    ``table`` is the authoritative (rows, dim) table (numpy or a tensor);
    it is kept as a float32 tensor on ``device`` (``cuda`` unless asked
    otherwise) with a host copy.  ``lookup(ids) -> (n, D) float32`` equals
    ``table[ids]`` exactly, plus per-call hit/miss stats.
    """

    def __init__(self, spec: EmbedSpec, plan: str, table, device=None,
                 cache: CacheConfig = CacheConfig()):
        check_plan(plan)
        self.spec, self.plan, self.ccfg = spec, plan, cache
        self.device = resolve_device(device)
        # always copy: update_rows writes the host copy in place
        self._host = host_copy(table)
        if self._host.shape != (spec.rows, spec.dim):
            raise ValueError(f"{spec.name}: table shape {self._host.shape} "
                             f"!= spec ({spec.rows}, {spec.dim})")
        self._sync_device()
        self.cache = (HotRowCache(spec.rows, cache.rows)
                      if cache.rows > 0 else None)
        self.calls = 0
        self.exchanged_ids = 0          # ids gathered on the device

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

    def _exchange(self, ids: np.ndarray) -> np.ndarray:
        """table[ids] gathered on the device (one ``gather_rows`` launch on
        the card), back on the host."""
        ids_dev = torch.as_tensor(ids, dtype=torch.int32, device=self.device)
        out = ops.embedding_gather(self._table_dev, ids_dev)
        self.exchanged_ids += len(ids)
        return out.cpu().numpy()

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
        self.cache.refresh(self._host)
        return rows, {"hits": int(hit.sum()), "misses": n_miss}

    # -- table updates / staleness -------------------------------------------

    def _sync_device(self) -> None:
        self._table_dev = torch.tensor(self._host, device=self.device)

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
            "table": self.spec.name, "plan": self.plan,
            "cache_rows": self.ccfg.rows, "cached_now": self.n_cached,
            "hits": self.hits, "misses": self.misses,
            "hit_rate": self.hit_rate,
            "lookups": self.calls, "exchanged_ids": self.exchanged_ids,
        }


def make_cached_lookup(name: str, table, kind: str = "replicated",
                       device=None, cache: CacheConfig = CacheConfig(),
                       ) -> CachedLookup:
    """Convenience: spec from the table's shape, plan from ``kind``."""
    t = host_copy(table)
    spec = EmbedSpec(name, rows=t.shape[0], dim=t.shape[1])
    return CachedLookup(spec, kind, t, device=device, cache=cache)
