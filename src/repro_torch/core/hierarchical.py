"""Flat and hierarchical all-reduce (paper Eq. 8 and C5, §III.B); port of
``repro/core/hierarchical.py`` over ``torch.distributed``.

The JAX functions run inside ``shard_map`` and name mesh axes; here a
:class:`DPMesh` holds one process group per axis name.  Its ranks are laid
out pod-major, as ``compat.make_mesh((pods, data), ("pod", "data"))`` lays
out devices: rank ``r`` sits at ``pod = r // data``, ``data = r % data``.
The ``data`` group holds the ranks of one pod (the fast intra-pod link),
the ``pod`` group the ranks with one data index (the slow cross-pod link).

Hierarchical all-reduce reduce-scatters over ``data``, all-reduces the
1/|data| shard over ``pod`` and all-gathers it back over ``data``: the
cross-pod link carries 1/|data| of the bytes of a flat all-reduce.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

AXES = ("pod", "data")          # mesh axis order, major first


@dataclasses.dataclass(frozen=True)
class DPMesh:
    """A (pod, data) layout of the ``torch.distributed`` world."""

    shape: Dict[str, int]          # axis name -> size
    coords: Dict[str, int]         # axis name -> this rank's index
    groups: Dict[str, object]      # axis name -> process group

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes``: one axis's group, or the
        whole world (``None``) for both."""
        axes = tuple(axes)
        if len(axes) == 1:
            return self.groups[axes[0]]
        if sorted(axes) != sorted(AXES):
            raise ValueError(f"axes {axes} (want one of {AXES}, or both)")
        return None

    def shard_index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes`` flattened, the first axis major
        (the order of ``PartitionSpec(axes)``)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def make_dp_mesh(pods: int = 1) -> DPMesh:
    """The world (``torch.distributed`` initialised) as ``pods`` pods of
    ``world // pods`` ranks, pod-major.  Every rank must call it: each
    group is created collectively."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % pods:
        raise ValueError(f"world {world} does not split into {pods} pods")
    data = world // pods
    groups = {}
    for name, members in (
            ("data", [[p * data + d for d in range(data)]
                      for p in range(pods)]),
            ("pod", [[p * data + d for p in range(pods)]
                     for d in range(data)])):
        for ranks in members:
            g = None if len(ranks) == world else dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    return DPMesh(shape={"pod": pods, "data": data},
                  coords={"pod": rank // data, "data": rank % data},
                  groups=groups)


def init_world_of_one(device) -> DPMesh:
    """Initialise a one-rank ``torch.distributed`` world for ``device``
    (NCCL on a CUDA device, gloo on the CPU) through a store on localhost,
    and return its mesh."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    store = dist.TCPStore("127.0.0.1", 0, 1, True)    # a free local port
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return make_dp_mesh()


def all_gather(x: torch.Tensor, mesh: DPMesh, axis: str,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, in the axis's order: stacked as
    (P,) + x.shape, or, ``tiled``, concatenated on dim 0 as
    ``jax.lax.all_gather(..., tiled=True)`` gives it."""
    P = mesh.shape[axis]
    out = x.new_empty((P * x.numel(),))      # gloo wants a flat output
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1),
                                group=mesh.group((axis,)))
    if tiled:
        return out.reshape((P * x.shape[0],) + tuple(x.shape[1:]))
    return out.reshape((P,) + tuple(x.shape))


def flat_allreduce_mean(g: torch.Tensor, mesh: DPMesh, axes) -> torch.Tensor:
    """Baseline: one all-reduce over all dp axes (Eq. 8), then / P."""
    out = g.clone()
    dist.all_reduce(out, group=mesh.group(axes))
    return out / mesh.size(axes)


def hierarchical_allreduce_mean(g: torch.Tensor, mesh: DPMesh,
                                intra_axis: str = "data",
                                inter_axis: Optional[str] = "pod"):
    """reduce-scatter(intra) -> all-reduce(inter) -> all-gather(intra)."""
    n_intra = mesh.shape[intra_axis]
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % n_intra
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat.new_empty(flat.shape[0] // n_intra)
    intra = mesh.group((intra_axis,))
    dist.reduce_scatter_tensor(shard, flat, group=intra)
    total = n_intra
    if inter_axis is not None:
        dist.all_reduce(shard, group=mesh.group((inter_axis,)))
        total *= mesh.shape[inter_axis]
    out = torch.empty_like(flat)
    dist.all_gather_into_tensor(out, shard, group=intra)
    if pad:
        out = out[:-pad]
    return out.reshape(g.shape) / total


def make_sync_fn(mode: str, mesh: DPMesh, intra_axis: str = "data",
                 inter_axis: Optional[str] = None):
    """Leaf-wise gradient synchronizer: mode 'flat' (Eq. 8) |
    'hierarchical' (C5)."""
    axes = (intra_axis,) + ((inter_axis,) if inter_axis else ())
    if mode == "flat":
        def sync(g):
            return flat_allreduce_mean(g, mesh, axes)
    elif mode == "hierarchical":
        def sync(g):
            return hierarchical_allreduce_mean(g, mesh, intra_axis,
                                               inter_axis)
    else:
        raise ValueError(mode)
    return lambda grads: tree_map(sync, grads)
