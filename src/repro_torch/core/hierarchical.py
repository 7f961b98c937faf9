"""Flat and hierarchical all-reduce (paper Eq. 8 and C5, §III.B); port of
``repro/core/hierarchical.py`` over ``torch.distributed``, and the mesh
that names the world's ranks by axis.

The JAX functions run inside ``shard_map`` and name mesh axes; here a
:class:`DPMesh` holds one process group per axis and per tuple of axes.
Its axes are ``pod, data, model, stage`` (those present), and its ranks
are laid out row-major, as ``compat.make_mesh(shape, axes)`` lays out
devices: without a stage axis rank ``r`` sits at ``model = r % model``,
``data = (r // model) % data``, ``pod = r // (data * model)``; the
pipelined step's ``stage`` axis comes last, as JAX's ``make_host_mesh``
appends it, so neighbouring stages are neighbouring ranks.  The ``data`` group holds the ranks of one
pod (the fast intra-pod link), the ``pod`` group the ranks with one data
index (the slow cross-pod link).  A group over several axes lists its
ranks in ascending order, which is the axes' flattened index taken in
mesh order (the first axis major): the order in which a tiled
all-gather over ``PartitionSpec((axes...))`` concatenates shards.

Hierarchical all-reduce reduce-scatters over ``data``, all-reduces the
1/|data| shard over ``pod`` and all-gathers it back over ``data``: the
cross-pod link carries 1/|data| of the bytes of a flat all-reduce.

:func:`neighbour` and :func:`exchange` are the pipeline's point-to-point
messages between stages (``core/pipeline.py``); :func:`all_to_all` swaps
batch slices for column slices in the sharded embedding lookup
(``embeddings/lookup.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

AXES = ("pod", "data", "model", "stage")   # mesh axis order, major first


@dataclasses.dataclass(frozen=True)
class DPMesh:
    """A layout of the ``torch.distributed`` world over named axes (a
    subset of :data:`AXES`, in that order): ``(pod, data)`` for the DP
    step, ``(pod?, data, model)`` for the hybrid TP x DP step, ``(data,
    model, stage)`` for the pipelined step."""

    shape: Dict[str, int]          # axis name -> size, in mesh order
    coords: Dict[str, int]         # axis name -> this rank's index
    groups: Dict[Tuple[str, ...], object]   # axes (mesh order) -> group

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        axes = tuple(axes)
        bad = [a for a in axes if a not in self.shape]
        if bad or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} (mesh axes {self.axis_names})")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` (any order; ``None``, the
        default group, when they span the whole world)."""
        return self.groups[self._key(axes)]

    def ordered_group(self, axes: Sequence[str]):
        """:meth:`group` for a collective whose result depends on the
        order of the ranks (all-gather, reduce-scatter): ``axes`` must be
        in mesh order, so the group's rank order is their flattened
        index."""
        key = self._key(axes)
        if key != tuple(axes):
            raise ValueError(f"axes {tuple(axes)} are not in mesh order "
                             f"{self.axis_names}")
        return self.groups[key]

    def shard_index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes`` flattened, the first axis major
        (the order of ``PartitionSpec(axes)``)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def make_mesh(shape: Dict[str, int],
              ranks: Optional[Sequence[int]] = None) -> Optional[DPMesh]:
    """``ranks`` (ascending global ranks; default the whole world,
    ``torch.distributed`` initialised) laid out row-major over ``shape``
    (axis -> size, axes from :data:`AXES` in that order), with a group for
    every non-empty tuple of axes.  A rank takes its coordinates from its
    index in ``ranks``; one outside them gets ``None``.  Every rank of the
    world must call it: each group is created collectively, in the same
    order (``runtime/elastic.make_mesh_for`` lays out the survivors)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    what = (f"the world of {world} ranks" if ranks is None
            else f"the {len(ranks)} ranks {list(ranks)}")
    ranks = list(range(world)) if ranks is None else list(ranks)
    names = tuple(shape)
    if tuple(a for a in AXES if a in shape) != names:
        raise ValueError(f"mesh axes {names} (want a subset of {AXES}, "
                         "in that order)")
    if math.prod(shape.values()) != len(ranks):
        raise ValueError(f"mesh {dict(shape)} does not cover {what}")
    if ranks != sorted(set(ranks)) or not set(ranks) <= set(range(world)):
        # ascending, so a group's rank order is the axes' flattened index
        raise ValueError(f"ranks {ranks} are not ascending ranks of the "
                         f"world of {world}")
    sizes = [shape[a] for a in names]

    def coords_of(i):
        out = {}
        for a, n in zip(reversed(names), reversed(sizes)):
            out[a] = i % n
            i //= n
        return out

    every = [coords_of(i) for i in range(len(ranks))]
    groups = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            rest = [a for a in names if a not in axes]
            members: Dict[Tuple[int, ...], list] = {}
            for r, c in zip(ranks, every):
                members.setdefault(tuple(c[a] for a in rest), []).append(r)
            for group_ranks in members.values():
                g = (None if len(group_ranks) == world
                     else dist.new_group(group_ranks))
                if rank in group_ranks:
                    groups[axes] = g
    if rank not in ranks:
        return None
    return DPMesh(shape=dict(shape), coords=every[ranks.index(rank)],
                  groups=groups)


def make_dp_mesh(pods: int = 1) -> DPMesh:
    """The world (``torch.distributed`` initialised) as ``pods`` pods of
    ``world // pods`` ranks, pod-major.  Every rank must call it: each
    group is created collectively."""
    world = dist.get_world_size()
    if world % pods:
        raise ValueError(f"world {world} does not split into {pods} pods")
    return make_mesh({"pod": pods, "data": world // pods})


def init_world_of_one(device) -> DPMesh:
    """Initialise a one-rank ``torch.distributed`` world for ``device``
    (NCCL on a CUDA device, gloo on the CPU) through a store on localhost,
    and return its mesh."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    store = dist.TCPStore("127.0.0.1", 0, 1, True)    # a free local port
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return make_dp_mesh()


def neighbour(mesh: DPMesh, axis: str, offset: int) -> int:
    """The global rank ``offset`` places along ``axis`` from this rank
    (every other coordinate the same), on a mesh over the first ranks of
    the world."""
    coords = dict(mesh.coords)
    coords[axis] += offset
    if not 0 <= coords[axis] < mesh.shape[axis]:
        raise ValueError(f"no rank at {axis} {coords[axis]}")
    r = 0
    for a in mesh.axis_names:
        r = r * mesh.shape[a] + coords[a]
    return r


def exchange(ops, tag: int = 0) -> None:
    """Point-to-point messages, posted together and waited for:
    ``ops`` holds ``("send", tensor, rank)`` and ``("recv", tensor,
    rank)`` (a receive fills its contiguous tensor in place), ranks
    global.  Posting both directions of a pipeline tick in one batch is
    what keeps two neighbours that send to each other from deadlocking."""
    p2p = [dist.P2POp(dist.isend if kind == "send" else dist.irecv, t,
                      peer, tag=tag) for kind, t, peer in ops]
    for work in dist.batch_isend_irecv(p2p):
        work.wait()


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


def gather_dim(x: torch.Tensor, mesh: DPMesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` (mesh order) concatenated on
    ``dim`` in their flattened order: the tiled all-gather that undoes a
    ``PartitionSpec`` entry ``axes`` on that dim."""
    n = mesh.size(axes)
    if n == 1:
        return x
    out = x.new_empty((n * x.numel(),))
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1),
                                group=mesh.ordered_group(axes))
    shape = tuple(x.shape)
    return out.reshape((n,) + shape).movedim(0, dim).reshape(
        shape[:dim] + (n * shape[dim],) + shape[dim + 1:])


def reduce_scatter_dim(x: torch.Tensor, mesh: DPMesh, axes: Sequence[str],
                       dim: int) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes`` (mesh order), of which
    this rank keeps its slice of ``dim`` (by its flattened index)."""
    n = mesh.size(axes)
    if n == 1:
        return x
    shape = tuple(x.shape)
    if shape[dim] % n:
        raise ValueError(f"dim {dim} of {shape} does not split over {n}")
    c = shape[dim] // n
    flat = x.reshape(shape[:dim] + (n, c) + shape[dim + 1:]).movedim(
        dim, 0).contiguous().reshape(-1)
    out = x.new_empty((flat.numel() // n,))
    dist.reduce_scatter_tensor(out, flat, group=mesh.ordered_group(axes))
    return out.reshape(shape[:dim] + (c,) + shape[dim + 1:])


def all_to_all(x: torch.Tensor, mesh: DPMesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x``'s ``split_dim`` cut into |axis| blocks, block ``j`` sent to the
    rank at index ``j`` along ``axis``, and the blocks received laid side
    by side on ``concat_dim`` in the axis's order.  Swapping the two dims
    is its inverse."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    shape = tuple(x.shape)
    if shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {shape} does not split over "
                         f"{n}")
    c = shape[split_dim] // n
    send = x.reshape(shape[:split_dim] + (n, c) + shape[split_dim + 1:]
                     ).movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv.view(-1), send.view(-1),
                           group=mesh.ordered_group((axis,)))
    cut = shape[:split_dim] + (c,) + shape[split_dim + 1:]
    return recv.movedim(0, concat_dim).reshape(
        cut[:concat_dim] + (n * cut[concat_dim],) + cut[concat_dim + 1:])


def all_reduce_sum(x: torch.Tensor, mesh: DPMesh,
                   axes: Sequence[str]) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes`` (a new tensor)."""
    out = x.clone(memory_format=torch.contiguous_format)
    if mesh.size(axes) > 1:
        dist.all_reduce(out, group=mesh.group(axes))
    return out


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
