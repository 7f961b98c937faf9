"""Sharded sparse-embedding tables: specs, init and placement (port of
``repro/embeddings/table.py``).

Four plans over the meshes of ``core/hierarchical.py`` (axis names
``data`` = the DP batch axis, ``model`` = the table-parallel axis):

============  ==========================  =============================
plan          shard per rank              lookup exchange
============  ==========================  =============================
replicated    full (V, D)                 none (dense grad all-reduce)
row           (V / |model|, D)            all-reduce of (U, D) over
                                          ``model``
col           (V, D / |data|)             all-gather ids + all-to-all of
                                          (B, D/|data|) over ``data``
row_col       (V/|model|, D/|data|)       all-reduce over ``model`` then
                                          all-to-all over ``data``
============  ==========================  =============================

``col``/``row_col`` follow the DLRM 2D-parallel layout: the embedding dim
is sharded over the *data* ranks, so each rank computes its column slice
for the whole global batch and an all-to-all swaps (batch slice) for
(column slice).  The exchange is activation-sized, independent of V,
while the replicated baseline's gradient all-reduce scales with the table.

Lookups are in :mod:`repro_torch.embeddings.lookup`; this module is pure
placement arithmetic (its float results are the JAX package's exactly),
so the launchers can cost plans without touching device state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.sharding import NamedSharding

PLANS = ("replicated", "row", "col", "row_col")


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


@dataclasses.dataclass(frozen=True)
class EmbedSpec:
    """One logical table: ``rows`` ids x ``dim`` features."""

    name: str
    rows: int
    dim: int
    init_scale: float = 0.02
    dtype: str = "float32"

    @property
    def bytes(self) -> int:
        return self.rows * self.dim * _itemsize(self.dtype)


@dataclasses.dataclass(frozen=True)
class EmbedPlan:
    """Placement of a table over a mesh.

    ``row_axis`` shards the vocab dim (classic model parallelism);
    ``col_axis`` shards the feature dim over the DP ranks (DLRM 2D).
    Either may be ``None``; both ``None`` is the replicated baseline.
    """

    kind: str = "replicated"            # replicated | row | col | row_col
    row_axis: Optional[str] = None      # vocab-dim mesh axis
    col_axis: Optional[str] = None      # feature-dim mesh axis
    dedup: bool = True                  # unique->gather->inverse lookups

    def __post_init__(self):
        if self.kind not in PLANS:
            raise ValueError(f"unknown plan kind {self.kind!r}")
        want = {"replicated": (False, False), "row": (True, False),
                "col": (False, True), "row_col": (True, True)}[self.kind]
        have = (self.row_axis is not None, self.col_axis is not None)
        if want != have:
            raise ValueError(
                f"plan {self.kind!r} needs row_axis={want[0]}, "
                f"col_axis={want[1]}; got {self.row_axis!r}/{self.col_axis!r}")


def make_plan(kind: str, *, row_axis: str = "model",
              col_axis: str = "data", dedup: bool = True) -> EmbedPlan:
    """Plan with the conventional axis assignment for each kind."""
    return EmbedPlan(
        kind=kind,
        row_axis=row_axis if kind in ("row", "row_col") else None,
        col_axis=col_axis if kind in ("col", "row_col") else None,
        dedup=dedup)


def _axis(mesh_shape: Dict[str, int], name: Optional[str]) -> int:
    return mesh_shape[name] if name else 1


def shard_shape(spec: EmbedSpec, plan: EmbedPlan,
                mesh_shape: Dict[str, int]) -> Tuple[int, int]:
    """Per-rank (rows, cols) under the plan; dims must divide evenly."""
    nr = _axis(mesh_shape, plan.row_axis)
    nc = _axis(mesh_shape, plan.col_axis)
    if spec.rows % nr or spec.dim % nc:
        raise ValueError(
            f"{spec.name}: ({spec.rows}, {spec.dim}) does not divide over "
            f"({nr}, {nc}) shards")
    return spec.rows // nr, spec.dim // nc


def shard_bytes(spec: EmbedSpec, plan: EmbedPlan,
                mesh_shape: Dict[str, int]) -> int:
    r, c = shard_shape(spec, plan, mesh_shape)
    return r * c * _itemsize(spec.dtype)


def pspec(plan: EmbedPlan) -> Tuple:
    """Partition spec of the (rows, dim) table under the plan (the port's
    spec tuple, read as JAX reads ``P(row_axis, col_axis)``)."""
    return (plan.row_axis, plan.col_axis)


def named_sharding(mesh, plan: EmbedPlan) -> NamedSharding:
    """The plan's ``core.sharding.NamedSharding`` on ``mesh``."""
    return NamedSharding(mesh, pspec(plan))


def init_table(generator: torch.Generator, spec: EmbedSpec,
               device=None) -> torch.Tensor:
    """Full-table init, normal * ``init_scale`` (the CF-factor convention),
    drawn in float32 on the generator's device.  The draws are not JAX's:
    parity tests convert the JAX init instead."""
    x = torch.randn((spec.rows, spec.dim), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (x * spec.init_scale).to(device=device,
                                    dtype=getattr(torch, spec.dtype))


# ---------------------------------------------------------------------------
# Cost model: what the launchers' --embed-plan summary prints.  Wire-byte
# formulas on the ring model: all-reduce 2*n*(P-1)/P, all-gather /
# all-to-all n*(P-1)/P.
# ---------------------------------------------------------------------------

def exchange_bytes(spec: EmbedSpec, plan: EmbedPlan,
                   mesh_shape: Dict[str, int], batch_per_dev: int,
                   dp_axis: str = "data") -> Dict[str, float]:
    """Modeled per-rank wire bytes per step (lookup fwd+bwd + grad sync).

    ``batch_per_dev`` is ids looked up per DP rank; dedup caps the reduced
    payload at that many unique rows (worst case, no repeats).
    """
    itemsize = _itemsize(spec.dtype)
    nr = _axis(mesh_shape, plan.row_axis)
    nc = _axis(mesh_shape, plan.col_axis)
    ndp = mesh_shape.get(dp_axis, 1)
    ring = lambda n: (n - 1) / n if n > 1 else 0.0  # noqa: E731
    b_glob = batch_per_dev * ndp

    look = 0.0
    if plan.row_axis:                    # all-reduce of (U, D/nc) partials;
        # with col sharding the ids were all-gathered first, so the dedup
        # set is drawn from the GLOBAL batch (worst case b_glob unique rows)
        u = b_glob if plan.col_axis else batch_per_dev
        look += 2 * u * (spec.dim // nc) * itemsize * ring(nr)
    if plan.col_axis:                    # ids all-gather + all-to-all swap
        look += b_glob * 4 * ring(nc)
        look += b_glob * (spec.dim // nc) * itemsize * ring(nc)

    # gradient path: the lookup collectives' conjugates + the DP sync of
    # whatever table shard is replicated across DP ranks (col-sharded
    # tables are disjoint per DP rank: no table sync at all)
    grad = look
    if plan.col_axis is None:
        grad += 2 * (spec.rows // nr) * spec.dim * itemsize * ring(ndp)
    return {"lookup": look, "grad": grad, "total": look + grad}


def sparse_exchange_bytes(spec: EmbedSpec, mesh_shape: Dict[str, int],
                          batch_per_dev: int, dp_axis: str = "data"
                          ) -> float:
    """Per-rank wire bytes of the sparse rows-touched DP sync (all-gather
    of (U, D) values + (U,) ids) replacing the dense table all-reduce."""
    itemsize = _itemsize(spec.dtype)
    ndp = mesh_shape.get(dp_axis, 1)
    ring = (ndp - 1) / ndp if ndp > 1 else 0.0
    return batch_per_dev * (spec.dim * itemsize + 4) * ring


def plan_summary(spec: EmbedSpec, plan: EmbedPlan,
                 mesh_shape: Dict[str, int], batch_per_dev: int) -> Dict:
    """One-stop numbers for logs."""
    r, c = shard_shape(spec, plan, mesh_shape)
    ex = exchange_bytes(spec, plan, mesh_shape, batch_per_dev)
    return {
        "table": spec.name, "plan": plan.kind,
        "mesh": dict(mesh_shape),
        "shard_rows": r, "shard_cols": c,
        "table_bytes_per_dev": shard_bytes(spec, plan, mesh_shape),
        "modeled_exchange_bytes": ex,
        "modeled_sparse_sync_bytes": sparse_exchange_bytes(
            spec, mesh_shape, batch_per_dev),
    }
