"""CF head serving: retrieval->rank candidate scoring inside the engine
(port of ``repro/serving/cf_head.py``).

A recommender request is not just a prompt: it is (user id, candidate item
set, interaction history).  This head scores the candidates through the
``cf_user`` / ``cf_item`` factor tables, replicated or row/col/2D-sharded
over a mesh as the recsys trainer shards them, and fuses the CF scores
with the LM's next-item logits through :func:`repro_torch.recsys.model
.fuse`, the gate training uses too.

Each table sits behind a :class:`~repro_torch.embeddings.serving
.CachedLookup`: a frequency-tracked host copy of the hot head serves cache
hits, and only the cold tail goes to the device: a gather of the whole
table under the replicated plan, the sharded lookup's exchange under the
others (the ``gather_rows`` CUDA kernel on the card either way).  Scoring
needs only the request's last-position LM logits row, which every
backend's prefill produces:

    head = CFHead.build(n_users=10_000, n_items=vocab, plan="row",
                        mesh=mesh, cache_rows=128)
    engine = ServingEngine(backend, ecfg, cf_head=head)

Under a sharded plan every rank of the mesh scores the same requests
(SPMD).  Cached and uncached heads, and every plan, give bit-identical
scores: the cache is purely a saving of device gathers and exchanges.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.embeddings import EmbedSpec, init_table, make_plan
from repro_torch.embeddings.serving import (DECAY, CacheConfig,
                                            CachedLookup, host_copy)
from repro_torch.recsys import model as rec_model


@dataclasses.dataclass(frozen=True)
class CFConfig:
    """Placement + cache knobs of the serving CF head."""

    plan: str = "replicated"        # replicated | row | col | row_col
    cache_rows: int = 0             # hot-row replica capacity (0 = off)
    decay: float = DECAY
    elect_every: int = 1
    miss_quantum: int = 8
    row_axis: str = "model"
    col_axis: str = "data"


class CFHead:
    """CF scoring head for the serving engine.

    Owns the ``cf_user`` / ``cf_item`` tables (each behind a
    :class:`CachedLookup` on ``device``, sharded over ``mesh`` by the
    plan) and the fusion gate.  ``score`` is one retrieval->rank step:
    look up the user's factor row and the candidate item rows, dot them
    into CF scores, fuse with the LM's last-position logits at the
    candidate ids, rank.
    """

    def __init__(self, user_table, item_table, fusion_gate=0.0,
                 cfg: CFConfig = CFConfig(), device=None, mesh=None):
        self.device = resolve_device(device)
        u, it = host_copy(user_table), host_copy(item_table)
        if u.shape[1] != it.shape[1]:
            raise ValueError(f"cf_dim mismatch: user {u.shape} vs "
                             f"item {it.shape}")
        self.cfg = cfg
        self.fusion_gate = torch.as_tensor(fusion_gate, dtype=torch.float32)
        plan = make_plan(cfg.plan, row_axis=cfg.row_axis,
                         col_axis=cfg.col_axis)
        cache = CacheConfig(rows=cfg.cache_rows, decay=cfg.decay,
                            elect_every=cfg.elect_every,
                            miss_quantum=cfg.miss_quantum)
        self.lookups: Dict[str, CachedLookup] = {
            "cf_user": CachedLookup(
                EmbedSpec("cf_user", rows=u.shape[0], dim=u.shape[1]),
                plan, u, device=self.device, cache=cache, mesh=mesh),
            "cf_item": CachedLookup(
                EmbedSpec("cf_item", rows=it.shape[0], dim=it.shape[1]),
                plan, it, device=self.device, cache=cache, mesh=mesh),
        }
        self.requests_scored = 0

    @classmethod
    def build(cls, n_users: int, n_items: int, cf_dim: int = 16, *,
              seed: int = 0, plan: str = "replicated", cache_rows: int = 0,
              device=None, mesh=None, fusion_gate: float = 0.0
              ) -> "CFHead":
        """Fresh factor tables (the :func:`repro_torch.embeddings
        .init_table` convention, drawn from a generator seeded with
        ``seed`` on ``device``) under one plan.  The draws are not JAX's:
        parity tests carry the JAX head's tables over instead."""
        cfg = CFConfig(plan=plan, cache_rows=cache_rows)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        u = init_table(gen, EmbedSpec("cf_user", rows=n_users, dim=cf_dim),
                       device=dev)
        it = init_table(gen, EmbedSpec("cf_item", rows=n_items, dim=cf_dim),
                        device=dev)
        return cls(u, it, fusion_gate=fusion_gate, cfg=cfg, device=dev,
                   mesh=mesh)

    # -- scoring --------------------------------------------------------------

    def score(self, user_id: int, candidates: Sequence[int],
              lm_logits_row=None) -> Dict:
        """One retrieval->rank step.

        ``lm_logits_row`` is the request's last-position (V,) LM logits
        from prefill (a tensor, on the device); ``None`` ranks on CF scores
        alone.  The logits are gathered at the candidate ids where they
        lie, so C floats cross to the host, not the row.  Returns numpy
        arrays: ``cf`` (C,), ``fused`` (C,), ``ranking`` (the candidate
        ids, best first), plus cache hit/miss counts for this call.
        """
        cand = np.asarray(candidates, np.int64).reshape(-1)
        u_rows, u_stats = self.lookups["cf_user"](np.asarray([user_id]))
        i_rows, i_stats = self.lookups["cf_item"](cand)
        cf = i_rows @ u_rows[0]                          # (C,) f32
        if lm_logits_row is not None:
            row = torch.as_tensor(lm_logits_row)
            idx = torch.as_tensor(cand, device=row.device)
            lm = row[idx].float().cpu()
        else:
            lm = torch.zeros(cf.shape, dtype=torch.float32)
        fused = rec_model.fuse(lm, torch.from_numpy(cf),
                               self.fusion_gate).numpy()
        order = np.argsort(-fused, kind="stable")
        self.requests_scored += 1
        return {
            "cf": cf, "fused": fused,
            "ranking": cand[order],
            "hits": u_stats["hits"] + i_stats["hits"],
            "misses": u_stats["misses"] + i_stats["misses"],
        }

    # -- table updates --------------------------------------------------------

    def update_rows(self, table: str, ids, rows,
                    refresh: bool = True) -> np.ndarray:
        """Land a trainer update on one table (rows-touched refresh of the
        hot-row replica unless ``refresh=False``)."""
        return self.lookups[table].update_rows(ids, rows, refresh=refresh)

    def refresh_touched(self, table: str, touched) -> None:
        self.lookups[table].refresh_touched(touched)

    # -- accounting -----------------------------------------------------------

    @property
    def hits(self) -> int:
        return sum(lk.hits for lk in self.lookups.values())

    @property
    def misses(self) -> int:
        return sum(lk.misses for lk in self.lookups.values())

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    @property
    def cache_rows_live(self) -> int:
        return sum(lk.n_cached for lk in self.lookups.values())

    def summary(self) -> Dict:
        return {
            "plan": self.cfg.plan,
            "cache_rows": self.cfg.cache_rows,
            "cache_rows_live": self.cache_rows_live,
            "requests_scored": self.requests_scored,
            "hits": self.hits, "misses": self.misses,
            "hit_rate": self.hit_rate,
            "tables": {n: lk.summary() for n, lk in self.lookups.items()},
        }
