"""Elastic scaling: rebuild the mesh after membership changes and reshard
live state onto it (paper §V.B: 'dynamic expansion ... maintaining training
continuity when nodes decrease'; port of ``repro/runtime/elastic.py``).

Checkpoints are topology-free (full logical arrays), so restore-onto-new-
mesh cuts each full array by the new plan's shardings
(``checkpoint/manager.py``); live-state resharding works the same way
without a round-trip to disk.  A port tensor does not carry its sharding
as a ``jax.Array`` does, so :func:`reshard` is also given the old one.

Every rank of the ``torch.distributed`` world calls :func:`make_mesh_for`
and :func:`reshard` (both are collective); a rank outside the new mesh
gets ``None`` from each and must take part in no collective of the new
mesh afterwards.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.core.hierarchical import DPMesh, make_mesh
from repro_torch.tree import tree_leaves, tree_map


def make_mesh_for(n_devices: int, *, model: int = 1,
                  axis_names: Tuple[str, str] = ("data", "model"),
                  ranks: Optional[Sequence[int]] = None
                  ) -> Optional[DPMesh]:
    """Largest (data, model) mesh that fits the surviving ranks: the first
    ``(n // model) * model`` of ``ranks`` (ascending global ranks; default
    the world's, as JAX takes ``jax.devices()[:n]``).  Returns ``None`` on
    a rank outside it."""
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))[:n_devices]
    data = len(ranks) // model
    ranks = ranks[:data * model]
    return make_mesh(dict(zip(axis_names, (data, model))), ranks)


def reshard(tree: Any, shardings: Any, src_shardings: Any) -> Any:
    """Reshard a tree of this rank's blocks, laid out by the
    ``NamedSharding`` tree ``src_shardings`` on the old mesh, onto the
    ``NamedSharding`` tree ``shardings`` on the new one (``None`` on a rank
    outside the new mesh, which then gets ``None``).  Works across
    dp-degree changes because every array is logically global: each leaf
    is gathered whole over the old mesh, one leaf at a time (the peak grows
    by one full leaf), and a survivor keeps its block of it."""
    if shardings is None:
        for x, s0 in zip(tree_leaves(tree), tree_leaves(src_shardings)):
            s0.gather(x)        # the same gathers, in the same order
        return None
    return tree_map(lambda x, s, s0: s.shard(s0.gather(x)), tree, shardings,
                    src_shardings)


def shrink_batch(batch: Any, new_dp: int, old_dp: int) -> Any:
    """Trim the global batch so it divides the surviving dp degree."""
    def fix(x):
        b = x.shape[0]
        nb = (b // new_dp) * new_dp
        return x[:nb]
    return tree_map(fix, batch)
