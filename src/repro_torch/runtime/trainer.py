"""The paper's explicit data-parallel train step and the training loop
(port of ``make_dp_train_step``, ``make_update_rule`` and ``train_loop``
of ``repro/runtime/trainer.py``).

The JAX step runs inside ``shard_map`` over the dp mesh axes; here every
rank of a ``torch.distributed`` world runs it on its slice of the global
batch (dim 0, in the JAX mesh's device order) and syncs the gradients by
hand: flat all-reduce (Eq. 8), hierarchical all-reduce (C5), or
compressed all-gather with error feedback (C6, Eq. 10-11).  Embedding
tables named in an :class:`EmbedSyncConfig` skip that sync and exchange
only the rows the batch touched (``embeddings/update.py``); with
``zero_opt`` their AdamW state is sharded over the dp ranks by rows (ZeRO
over the vocab dim).  Parameters are replicated, and so is the optimizer
state outside those tables; the residual is this rank's flat
``(N_pad,)`` f32 error-feedback state (row ``r`` of JAX's ``(P, N_pad)``).

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md):
the checkpoint manager (``checkpoint_every > 0``), the hybrid GSPMD and
pipelined steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import TrainConfig
from repro_torch.core import compression, hierarchical
from repro_torch.core.hierarchical import DPMesh
from repro_torch.embeddings import update as embed_update
from repro_torch.optimizer import adamw, schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class DPSyncConfig:
    mode: str = "flat"              # flat | hierarchical | onebit | topk
    intra_axis: str = "data"
    inter_axis: Optional[str] = None
    block: int = 512
    topk_block: int = 2048
    k: int = 32
    use_kernel: bool = True


@dataclasses.dataclass(frozen=True)
class EmbedSyncConfig:
    """Rows-touched sparse sync for embedding-table gradients.

    ``id_fns`` maps top-level param keys (the embedding tables) to
    ``batch -> ids`` extractors; those tables' gradients skip the dense
    all-reduce (and the compressed flatten path) and are exchanged as
    (unique ids, gradient rows) all-gathers instead: wire bytes scale with
    the batch, not the vocab.  ``compress="topk"`` sparsifies each
    exchanged row with the top-k kernel (``use_kernel``) or its plain
    version.  ``use_kernel`` also sends the gather of the touched rows and
    the scatter back through the ``gather_rows`` and ``scatter_add_rows``
    kernels (both exact), which the JAX step leaves to XLA.
    """

    id_fns: Dict[str, Callable[[Dict], torch.Tensor]]
    # unique-id cap (default: len(ids)).  Must be >= the unique ids a
    # rank's batch can touch: an undersized cap silently truncates the
    # exchanged row set and the dropped rows get ZERO gradient.
    cap: Optional[int] = None
    compress: Optional[str] = None  # None | "topk"
    k: int = 8
    use_kernel: bool = True
    # ZeRO over the vocab dim: the named tables' AdamW moments and master
    # rows live only on the owning dp rank (:func:`shard_embed_opt` cuts a
    # replicated state down); each rank updates its row slice of the
    # synced gradient and the fresh rows are all-gathered back into the
    # replicated table.  Requires rows % dp_world == 0.
    zero_opt: bool = False

    @property
    def exclude(self) -> Tuple[str, ...]:
        """Param keys outside the dense/compressed sync path: pass to
        ``residual_size(params, scfg, exclude=...)`` when compressing."""
        return tuple(self.id_fns)


def _dp_axes(scfg: DPSyncConfig) -> Tuple[str, ...]:
    return (scfg.intra_axis,) + ((scfg.inter_axis,) if scfg.inter_axis
                                 else ())


def residual_size(params, scfg: DPSyncConfig,
                  exclude: Tuple[str, ...] = ()) -> int:
    """Flat padded size of the compression error-feedback state.  Params
    under top-level keys in ``exclude`` (sparse-synced embedding tables)
    carry no residual: their sync is outside the compressed path."""
    if exclude:
        params = {k: v for k, v in params.items() if k not in exclude}
    n = sum(x.numel() for x in tree_leaves(params))
    mult = 8 * scfg.block if scfg.mode == "onebit" else scfg.topk_block
    return n + ((-n) % mult)


def _clock(split: Optional[Dict[str, float]], device) -> float:
    """The host clock after the device's queued work, when measuring."""
    if split is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def shard_embed_opt(opt, embed_sync: EmbedSyncConfig, mesh: DPMesh,
                    scfg: DPSyncConfig = DPSyncConfig()):
    """This rank's view of a replicated optimizer state under ``zero_opt``:
    the tables' m, v and master cut to the rank's rows (copies, so the
    full tables can be freed), the rest as it was.  What the JAX step's
    ``in_specs`` do to a replicated state."""
    axes = _dp_axes(scfg)
    world, r = mesh.size(axes), mesh.shard_index(axes)

    def cut(x):
        rows = x.shape[0] // world
        return x[r * rows:(r + 1) * rows].clone()

    return {**opt, **{part: {**opt[part], **{
        key: tree_map(cut, opt[part][key]) for key in embed_sync.id_fns}}
        for part in ("m", "v", "master")}}


def make_dp_train_step(loss_fn: Callable, mesh: DPMesh, tcfg: TrainConfig,
                       scfg: DPSyncConfig = DPSyncConfig(),
                       embed_sync: Optional[EmbedSyncConfig] = None,
                       params_shape=None, adamw_kernel: bool = False):
    """step(params, opt, residual, batch, split=None) -> (params, opt,
    residual, loss).

    ``loss_fn(params, batch)`` returns a scalar; ``batch`` is the global
    batch, of which this rank takes its slice on dim 0.  ``loss`` is the
    mean over the dp ranks.  ``split``, when a dict, accumulates the
    step's seconds in ``fwd_bwd``, ``sync`` and ``opt`` (the device is
    synchronised at each boundary, so pass it only to measure).

    With ``embed_sync`` params must be a dict, and the named tables'
    gradients are synced rows-touched instead of densely; when also
    compressing, size the residual with ``residual_size(params, scfg,
    exclude=embed_sync.exclude)``.  ``embed_sync.zero_opt`` shards those
    tables' AdamW state by rows over the dp axes: pass the state through
    :func:`shard_embed_opt`, and ``params_shape`` (any tree shaped like
    params, params themselves included) so the row counts are checked
    when the step is built, as JAX checks them.  Each rank updates its
    rows, clipped by a global norm that counts the disjoint table rows
    once (the other grads are replicated), and all-gathers the fresh rows
    back; the clip sums in another order than the replicated optimizer,
    so the two agree to rounding, not bit for bit.

    ``adamw_kernel`` is forwarded to ``adamw.adamw_apply(use_kernel=...)``:
    the fused AdamW kernel for the leaves its size rule admits.  The JAX
    step has no such switch (it calls ``adamw_apply`` with its default);
    this and ``embed_sync.use_kernel``'s row kernels are the only places
    this signature goes beyond it, and with both off it computes what the
    JAX step computes."""
    axes = _dp_axes(scfg)
    world = mesh.size(axes)
    shard = mesh.shard_index(axes)
    zero_opt = embed_sync is not None and embed_sync.zero_opt
    tables = tuple(embed_sync.id_fns) if embed_sync else ()
    if zero_opt:
        if params_shape is None:
            raise ValueError("embed_sync.zero_opt needs params_shape")
        for key in tables:
            rows = tree_leaves(params_shape[key])[0].shape[0]
            if rows % world:
                raise ValueError(
                    f"zero_opt table {key!r}: {rows} rows do not divide "
                    f"over {world} dp ranks")
    compressed = scfg.mode in ("onebit", "topk")
    if compressed:
        csync = compression.make_compressed_sync(
            scfg.mode, mesh=mesh, axis=scfg.intra_axis,
            block=scfg.block if scfg.mode == "onebit" else scfg.topk_block,
            k=scfg.k, use_kernel=scfg.use_kernel)
    else:
        gsync = hierarchical.make_sync_fn(scfg.mode, mesh, scfg.intra_axis,
                                          scfg.inter_axis)
    row_compress = None
    if embed_sync is not None and embed_sync.compress:
        row_compress = embed_update.make_row_compressor(
            embed_sync.compress, embed_sync.k, embed_sync.use_kernel)

    def local_batch(batch):
        return {k: v[shard * (v.shape[0] // world):
                     (shard + 1) * (v.shape[0] // world)]
                for k, v in batch.items()}

    def sync_embed_grads(grads, batch):
        """Pop the tables' grads; sync them rows-touched over all dp
        axes."""
        emb = {key: embed_update.sparse_row_sync(
            grads[key], id_fn(batch), mesh, axes, cap=embed_sync.cap,
            compress=row_compress, use_kernel=embed_sync.use_kernel)
            for key, id_fn in embed_sync.id_fns.items()}
        return emb, {k: v for k, v in grads.items() if k not in emb}

    def zero_update(params, grads, opt, lr):
        """AdamW on this rank's rows of each table, then the fresh rows
        all-gathered back (reversed axes order: the first axis ends up
        major, matching the rank's flat index)."""
        for key in tables:
            rows = grads[key].shape[0] // world
            grads = {**grads, key: grads[key][shard * rows:
                                              (shard + 1) * rows]}
        tc = tcfg
        if tcfg.grad_clip > 0:
            def sq(tree):
                return sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in tree_leaves(tree))
            table_sq = sq({k: grads[k] for k in tables}).reshape(1)
            dist.all_reduce(table_sq, group=mesh.group(axes))
            total = sq({k: g for k, g in grads.items()
                        if k not in tables}) + table_sq[0]
            scale = torch.clamp(tcfg.grad_clip / torch.clamp(
                torch.sqrt(total), min=1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
            tc = dataclasses.replace(tcfg, grad_clip=0.0)
        new_params, new_opt = adamw.adamw_apply(params, grads, opt, lr, tc,
                                                use_kernel=adamw_kernel)
        for key in tables:
            full = new_params[key]
            for ax in reversed(axes):
                full = hierarchical.all_gather(full, mesh, ax, tiled=True)
            new_params = {**new_params, key: full}
        return new_params, new_opt

    def step(params, opt, residual, batch, split=None):
        device = tree_leaves(params)[0].device
        marks = [_clock(split, device)]
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        batch = local_batch(batch)
        loss = loss_fn(leaves, batch)
        grads = tree_unflatten(leaves, list(torch.autograd.grad(
            loss, tree_leaves(leaves))))
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=mesh.group(axes))
        loss = loss / world
        marks.append(_clock(split, device))
        with torch.no_grad():
            if embed_sync is not None:
                emb_grads, grads = sync_embed_grads(grads, batch)
            if compressed:
                grads, new_res = csync(grads, residual)
                if scfg.inter_axis:                 # hierarchy: pods too
                    grads = tree_map(
                        lambda g: hierarchical.flat_allreduce_mean(
                            g, mesh, (scfg.inter_axis,)), grads)
            else:
                grads = gsync(grads)
                new_res = residual
            if embed_sync is not None:
                grads = {**grads, **emb_grads}
            marks.append(_clock(split, device))
            lr = schedule.warmup_cosine(opt["step"], tcfg.learning_rate,
                                        tcfg.warmup_steps, tcfg.steps)
            if zero_opt:
                new_params, new_opt = zero_update(params, grads, opt, lr)
            else:
                new_params, new_opt = adamw.adamw_apply(
                    params, grads, opt, lr, tcfg, use_kernel=adamw_kernel)
        if split is not None:
            marks.append(_clock(split, device))
            for key, a, b in zip(("fwd_bwd", "sync", "opt"), marks,
                                 marks[1:]):
                split[key] = split.get(key, 0.0) + b - a
        return new_params, new_opt, new_res, loss

    return step


def make_update_rule(tcfg: TrainConfig):
    """The trainer's optimizer plumbing (AdamW + warmup-cosine LR) as
    (init, apply): ``init(params) -> opt``; ``apply(params, opt, grads,
    lr_scale=1.0) -> (params, opt)``."""

    def init(params):
        return adamw.init_opt_state(params)

    def apply(params, opt, grads, lr_scale=1.0):
        lr = schedule.warmup_cosine(opt["step"], tcfg.learning_rate,
                                    tcfg.warmup_steps, tcfg.steps)
        return adamw.adamw_apply(params, grads, opt, lr * lr_scale, tcfg)

    return init, apply


@dataclasses.dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: list
    throughput: float               # samples/sec (host wall clock)


def train_loop(state: Dict[str, Any], batches: Iterator, step_fn: Callable,
               tcfg: TrainConfig, *, samples_per_batch: int = 0,
               log_every: int = 10, verbose: bool = False) -> TrainResult:
    """Generic loop over state = {'params', 'opt', 'residual'} with
    ``step_fn(params, opt, residual, batch) -> (params, opt, residual,
    loss)``.  The JAX loop's rebalance hook, tracer and failure injection
    belong to slices not ported yet."""
    if tcfg.checkpoint_every:
        raise NotImplementedError(
            "checkpoint_every > 0: the checkpoint manager is not ported "
            "yet (set checkpoint_every=0; see ROADMAP.md)")
    losses = []
    t0 = time.perf_counter()
    for batch in batches:
        state["params"], state["opt"], state["residual"], loss = step_fn(
            state["params"], state["opt"], state["residual"], batch)
        losses.append(float(loss))
        if verbose and len(losses) % log_every == 0:
            print(f"step {len(losses)}: loss {losses[-1]:.4f}")
    dt = time.perf_counter() - t0
    n = len(losses)
    tput = samples_per_batch * n / dt if dt > 0 else 0.0
    return TrainResult(steps_run=n, final_step=n, losses=losses,
                       throughput=tput)
