"""Embedding lookups: the dedup path and the sharded exchanges (port of
``repro/embeddings/lookup.py``).

Dedup (unique -> gather -> inverse) exploits the Zipfian id distribution
of recsys batches: a batch of n ids hits U <= n unique rows, so the gather
moves U rows and, under the row-sharded plans, the all-reduce exchanges
U-row payloads instead of n-row ones.  ``jnp.unique(size=n)`` keeps the
shapes static by padding the unique ids with repeats of the smallest one;
:func:`dedup_ids` reproduces that padding.

The sharded lookups run on every rank of a ``torch.distributed`` world laid
out by a :class:`~repro_torch.core.hierarchical.DPMesh`, each with its
shard of the table (``sharding.device_put`` by the plan's spec) and its
ids, through autograd-aware collectives (``core/sharding.py``):

* ``row``      -- each rank owns a vocab slice; masked local gather, then
                  an all-reduce of the (U, D) partials over the row axis
                  (Megatron's ``g``: identity backward);
* ``col``      -- DLRM-style: features sharded over the DP ranks; ids are
                  all-gathered over the col axis (no gradient), each rank
                  computes its column slice for the whole global batch,
                  and an all-to-all swaps batch slices for column slices
                  (backward: the inverse all-to-all);
* ``row_col``  -- both: masked gather, all-reduce over rows, all-to-all
                  over cols.

A table shard's gradient thus lands on its owner without a dense
full-table exchange; under ``col`` it already holds every DP rank's batch.
``use_kernel=True`` gathers the rows with the ``gather_rows`` CUDA kernel
(its plain version for a table on the CPU).  The kernel has no backward:
it raises where autograd would record the call, so a lookup that trains
a table passes ``use_kernel=False``.

Under the hybrid step's :class:`~repro_torch.core.sharding.TPHooks` the
model looks its tables up through :func:`tp_embed_lookup` and
:func:`tp_embed_rows`, by the plans :func:`embed_table_plans` reads off
the tables' param specs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import hierarchical as hier
from repro_torch.core import sharding as sharding_lib
from repro_torch.embeddings.table import EmbedPlan, EmbedSpec
from repro_torch.kernels import ops


def dedup_ids(ids: torch.Tensor, cap: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique ids (cap,), inverse (n,)): sorted unique ids padded with
    repeats of the smallest id; ``u[inv]`` reconstructs ``ids``.  ``cap``
    (default n) must be at least the number of unique ids."""
    flat = ids.reshape(-1)
    u, inv = torch.unique(flat, sorted=True, return_inverse=True)
    size = cap or flat.shape[0]
    if u.shape[0] > size:
        raise ValueError(f"{u.shape[0]} unique ids exceed cap {size}")
    u = torch.cat([u, u[:1].expand(size - u.shape[0])])
    return u, inv.reshape(-1)


def _gather(table: torch.Tensor, idx: torch.Tensor,
            use_kernel: bool) -> torch.Tensor:
    """``table[idx]``: through ``ops.embedding_gather`` (the CUDA kernel
    for a table on the card) when asked, which raises where autograd
    would record the call."""
    return ops.embedding_gather(table, idx) if use_kernel else table[idx]


def dedup_lookup(table: torch.Tensor, ids: torch.Tensor,
                 use_kernel: bool = False) -> torch.Tensor:
    """``table[ids]`` via unique -> gather -> inverse; equal to the direct
    gather, moving U <= n rows."""
    u, inv = dedup_ids(ids)
    rows = ops.embedding_gather(table, u) if use_kernel else table[u]
    return rows[inv].reshape(ids.shape + (table.shape[-1],))


# ---------------------------------------------------------------------------
# sharded lookups
# ---------------------------------------------------------------------------

def _local_gather(tshard: torch.Tensor, u: torch.Tensor, plan: EmbedPlan,
                  mesh, use_kernel: bool = False) -> torch.Tensor:
    """The shard's slice of rows ``u`` (global ids), rows another shard
    owns masked to zero; the all-reduce over the row axis completes them.
    Local ids are clipped into the shard before the gather, so the gather
    never reads outside it."""
    if plan.row_axis is None:
        return _gather(tshard, u, use_kernel)
    vr = tshard.shape[0]
    local = u.long() - mesh.coords[plan.row_axis] * vr
    own = (local >= 0) & (local < vr)
    rows = _gather(tshard, torch.clamp(local, 0, vr - 1), use_kernel)
    rows = torch.where(own[:, None], rows, rows.new_zeros(()))
    if mesh.shape[plan.row_axis] == 1:
        return rows
    return sharding_lib._Reduce.apply(rows, mesh, (plan.row_axis,))


def sharded_lookup_body(tshard: torch.Tensor, ids_loc: torch.Tensor,
                        plan: EmbedPlan, mesh,
                        use_kernel: bool = False) -> torch.Tensor:
    """The per-rank lookup: this rank's table shard + its ids (B_loc,) ->
    (B_loc, D) complete embeddings.  Every rank of the plan's axes calls
    it together (collectives).  Composable into larger steps (the hybrid
    step's RecLLM loss, the serving lookup)."""
    cols = plan.col_axis is not None and mesh.shape[plan.col_axis] > 1
    q = (hier.all_gather(ids_loc.reshape(-1), mesh, plan.col_axis,
                         tiled=True) if cols else ids_loc)
    if plan.dedup:
        u, inv = dedup_ids(q)
    else:
        u = q.reshape(-1)
        inv = torch.arange(u.shape[0], device=u.device)
    out = _local_gather(tshard, u, plan, mesh, use_kernel)[inv]
    if cols:
        # (B_glob, D/nc): swap batch slices for column slices
        out = sharding_lib._AllToAll.apply(out, mesh, plan.col_axis, 0, 1)
    return out                                         # (B_loc, D)


def make_sharded_lookup(mesh, spec: EmbedSpec, plan: EmbedPlan,
                        dp_axis: str = "data", use_kernel: bool = False):
    """Returns ``lookup(tshard, ids) -> (B / |dp_axis|, D)``.

    ``tshard`` is this rank's shard of the (rows, dim) table (the full
    table cut by ``table.named_sharding(mesh, plan)``); ``ids`` is the
    global (B,) id vector, the same on every rank.  The result is this
    rank's block of ``table[ids]`` batch-sharded over ``dp_axis`` (its
    slice of B, every column), as JAX's lookup lays out its global result;
    the gradient flows back into ``tshard``.
    """
    if plan.col_axis is not None and plan.col_axis != dp_axis:
        raise ValueError(
            f"col sharding must use the DP axis (got col_axis="
            f"{plan.col_axis!r}, dp_axis={dp_axis!r}): the all-to-all "
            f"swaps batch slices for column slices across DP ranks")
    del spec                            # shapes come from the shards
    n = mesh.shape.get(dp_axis, 1)
    i = mesh.coords.get(dp_axis, 0)

    def lookup(tshard: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        if ids.shape[0] % n:
            raise ValueError(f"{ids.shape[0]} ids do not split over "
                             f"{dp_axis} {n}")
        b = ids.shape[0] // n
        return sharded_lookup_body(tshard, ids[i * b:(i + 1) * b], plan,
                                   mesh, use_kernel)

    return lookup


def replicated_lookup(table: torch.Tensor, ids: torch.Tensor,
                      dedup: bool = True) -> torch.Tensor:
    """The baseline every plan is checked against: plain (optionally
    deduped) gather on a replicated table."""
    return dedup_lookup(table, ids) if dedup else table[ids]


# ---------------------------------------------------------------------------
# the tables under the hybrid step's TP hooks
# ---------------------------------------------------------------------------

def plan_of_spec(spec: Tuple, dedup: bool = True) -> EmbedPlan:
    """The plan a (rows, dim) table's partition spec places it by: the
    axes a divisibility guard left on each dim."""
    row, col = (tuple(spec) + (None, None))[:2]
    kind = {(False, False): "replicated", (True, False): "row",
            (False, True): "col", (True, True): "row_col"}[
        (row is not None, col is not None)]
    return EmbedPlan(kind, row, col, dedup)


def embed_table_plans(plan, specs: Dict[str, Tuple]) -> Dict[str, EmbedPlan]:
    """The plan each table of the sharding plan's ``embed_plans`` is
    looked up by, from its param spec ``specs[name]`` (the guard may have
    replicated a dim that does not divide).  ``dp_heavy`` gathers the row
    shards at use (``sharding.gather_weights``), so there only the column
    axis stays.  A row shard must be a vocab shard (the ``model`` axis)
    and a column shard lie over a batch axis: the lookup swaps batch for
    columns there."""
    out = {}
    for name, spec in specs.items():
        p = plan_of_spec(spec, plan.embed_plans[name].dedup)
        if p.row_axis is not None and p.row_axis != plan.tp_axis:
            raise ValueError(f"{name}: row axis {p.row_axis!r} (the hybrid "
                             f"step shards tables by rows over "
                             f"{plan.tp_axis!r})")
        if p.col_axis is not None and p.col_axis not in plan.dp_axes:
            raise ValueError(f"{name}: column axis {p.col_axis!r} is not a "
                             f"dp axis {plan.dp_axes}")
        if plan.dp_heavy and p.row_axis is not None:
            p = plan_of_spec((None, p.col_axis), p.dedup)
        out[name] = p
    return out


def tp_embed_lookup(tp, name: str, table: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, (n, D), of the table ``name`` (its shard under an
    embed plan, else the replicated table) for this rank's ids, entering
    this rank's share of the work through ``tp.copy``."""
    plan = tp.tables.get(name)
    if plan is None or plan.kind == "replicated":
        return dedup_lookup(tp.copy(table), ids)
    return tp.copy(sharded_lookup_body(table, ids, plan, tp.mesh))


def tp_embed_rows(tp, name: str, table: torch.Tensor) -> torch.Tensor:
    """This rank's vocab rows, every column, of the ``(V, D)`` table
    ``name``: a row shard is those rows; a column shard is gathered over
    its axis (its gradient reduce-scattered back)."""
    plan = tp.tables.get(name)
    rows = tp.vocab_rows(table) if plan is None \
        or plan.row_axis is None else table
    if plan is not None and plan.col_axis is not None:
        rows = sharding_lib._Gather.apply(rows, tp.mesh, (plan.col_axis,), 1)
    return rows
