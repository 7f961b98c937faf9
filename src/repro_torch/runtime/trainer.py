"""Training runtime: the hybrid TP x DP train step, the paper's explicit
data-parallel step, checkpoint/restart fault tolerance and the training
loop (port of ``make_hybrid_train_step``, ``make_dp_train_step``,
``make_update_rule``, ``train_loop`` and ``resume_or_init`` of
``repro/runtime/trainer.py``).

``make_hybrid_train_step`` is the production path: the JAX step is one
``jit`` whose shardings come from the ``ShardingPlan`` and whose
collectives GSPMD emits; here every rank of a ``torch.distributed`` world
holds its shards of the parameters (TP over ``model``) and of the
optimizer state (ZeRO-1 over the dp axes), runs the model on its rows of
each micro-batch under the plan's hooks (``core/sharding.TPHooks``:
Megatron TP, SP, the global loss mean; ``dp_heavy`` gathers the weights
instead), reduce-scatters the gradients onto the optimizer shards
(ZeRO-2), clips by the whole model's norm, updates its shards and
all-gathers the new parameters over the dp axes.

In ``make_dp_train_step`` the JAX step runs inside ``shard_map`` over the dp mesh axes; here every
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

``make_pp_train_step`` is the pipelined DP x TP x stage step: every rank
holds its stage of the layer stack (cut at the planner's bounds) with its
TP shards, runs the 1F1B or GPipe executor of ``core/pipeline.py`` over
the ``stage`` axis with Megatron-TP stage bodies over ``model``, and
syncs the gradients over ``data`` with the DP step's modes.
``PPRebalancer`` closes the observe->rebalance loop in
:func:`train_loop`: it times each stage's layers, re-carves the bounds
and remaps params and AdamW moments.

Under the hybrid step, tables named in the plan's ``embed_plans`` (the
CF tables) lie row-, column- or 2D-sharded and are looked up through the
sharded lookup.  A row shard's gradient is exact and local, as a Megatron
weight's, and is summed over the dp axes like one; a column shard is
disjoint per ``data`` rank and its gradient already holds every rank's
batch (the all-to-all's backward brought it), so the ZeRO-2 sum leaves
``data`` out for it.

The hybrid step trains the MoE archs too: experts over ``model``
(expert parallelism: each rank runs its ``E / tp`` experts and the
partial outputs are summed over ``model``), the router replicated, the
Switch aux losses over the global batch, and under the FSDP-expert rule
the experts' ``d_ff`` over the dp axes, gathered at use
(``models/moe.py``, ``core/sharding.TPHooks``).

It trains rwkv6 too: the time mix's heads and the channel mix's ``d_ff``
over ``model`` (``models/ssm.py`` under ``TPHooks``), the WKV in its
plain chunked form on each rank's heads.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md):
under the hybrid step, the mamba family (jamba).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager as ckpt
from repro_torch.config import ArchConfig, TrainConfig
from repro_torch.core import compression, hierarchical, load_balance
from repro_torch.core import pipeline as pipe_lib
from repro_torch.core import sharding as sharding_lib
from repro_torch.core.hierarchical import DPMesh
from repro_torch.core.hybrid import Plan
from repro_torch.embeddings import update as embed_update
from repro_torch.embeddings.lookup import embed_table_plans
from repro_torch.models import layers, transformer as tf
from repro_torch.models.transformer import ModelCtx
from repro_torch.obs import timeline as obs_timeline
from repro_torch.obs.trace import Tracer, or_null
from repro_torch.optimizer import adamw, schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# Hybrid TP x DP train step -- production path
# ---------------------------------------------------------------------------

def _grad_leaves(tree, bufs, add: bool, stacked: bool = False):
    """Autograd leaves over ``tree``'s storage, each of which hands its
    gradient to its slice of ``bufs`` as soon as the backward has it
    (``add``: summed in; else copied) and drops it.  The stacked (L, ...)
    leaves under ``blocks`` become a list of one leaf a layer, which the
    model's layer loop indexes as it indexes the stacked tensor: no
    layer's gradient is then padded to the whole stack."""
    if isinstance(tree, dict):
        return {k: _grad_leaves(tree[k], bufs[k], add,
                                stacked or k == "blocks") for k in tree}

    def leaf(x, buf):
        t = x.detach().requires_grad_()

        def take(t):
            (buf.add_ if add else buf.copy_)(t.grad)
            t.grad = None
        t.register_post_accumulate_grad_hook(take)
        return t
    if stacked:
        return [leaf(x, b) for x, b in zip(tree.unbind(0), bufs.unbind(0))]
    return leaf(tree, bufs)


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return list(tree) if isinstance(tree, list) else [tree]


def _zero_dim(pspec, ospec) -> Optional[int]:
    """The dim to which ZeRO-1 added the dp axes (``None``: no such)."""
    pspec = tuple(pspec) + (None,) * (len(ospec) - len(pspec))
    dims = [i for i, (a, b) in enumerate(zip(pspec, ospec)) if a != b]
    return dims[0] if dims else None


def _zero_dims(cfg: ArchConfig, sh, params_shape):
    return tree_map(_zero_dim, sh.param_specs(cfg, params_shape),
                    sh.opt_specs(cfg, params_shape))


def _zero_views(params, zdims, mesh: DPMesh, dp):
    """This rank's ZeRO block of each param shard (a view)."""
    n, i = mesh.size(dp), mesh.shard_index(dp)
    return tree_map(lambda p, d: p if d is None else p.narrow(
        d, i * (p.shape[d] // n), p.shape[d] // n), params, zdims)


def init_hybrid_opt(cfg: ArchConfig, plan: Plan, params, params_shape):
    """``adamw.init_opt_state`` of this rank's ZeRO blocks of its param
    shards ``params``: what ``sharding.device_put`` of the full state by
    the opt shardings gives, without building the full state."""
    sh = plan.sharding
    return adamw.init_opt_state(_zero_views(
        params, _zero_dims(cfg, sh, params_shape), sh.mesh, sh.dp_axes))


def make_hybrid_train_step(cfg: ArchConfig, plan: Plan, tcfg: TrainConfig,
                           loss_fn: Optional[Callable] = None, *,
                           params_shape, ctx: Optional[ModelCtx] = None):
    """Returns (step, shardings_for).

    ``step(params, opt, batch) -> (params, opt, metrics)`` runs on this
    rank's shards: ``params`` laid out by the plan's param specs, ``opt``
    (``adamw.init_opt_state`` of the full params) by its opt specs, as
    ``sharding.device_put(tree, shardings_for(...))`` cuts them; ``batch``
    is the global batch, of which the step takes this rank's rows of each
    micro-batch.  ``metrics`` holds the global ``loss`` (the mean over the
    micro-batches), ``lr`` and ``grad_norm`` (the whole model's, before
    the clip); for an MoE arch also ``aux``, the loss's aux (``ce``,
    ``lb_loss``, ``z_loss``, ``expert_load``) of the global batch, the
    mean over the micro-batches, as JAX's ``_grads`` returns it.
    ``shardings_for(params_shape, batch_shape)`` gives the
    ``NamedSharding`` trees of params, opt and batch (JAX's
    ``shardings_for``).  The step updates the ``params`` and ``opt``
    shards it is given in place and returns them (JAX's step donates its
    arguments' buffers), so neither is held twice.  Each layer's gradient goes into
    the step's gradient buffers as the backward produces it
    (:func:`_grad_leaves`), so no second set of gradients is held either.

    ``params_shape`` (the full params, or any tree of their shapes) fixes
    the specs when the step is built: the JAX step reads them from its
    jit's arguments.  ``loss_fn(params, batch, ctx) -> (total, aux)``
    defaults to ``transformer.loss_fn``; the step passes it ``ctx`` (the
    caller's, default ``ModelCtx()``) with the plan's knobs set as JAX
    sets them: ``remat``, ``flash_vjp = dp_heavy or tp == 1``, and ``tp``,
    the hooks of the plan for the micro-batch's shape.

    Micro-batch ``j`` of ``accum = pcfg.microbatches`` holds the global
    rows ``[j B/accum, (j+1) B/accum)``, as JAX's reshape takes them, cut
    over the batch axes; gradients accumulate in float32 and the loss and
    gradients are averaged over the micro-batches.  Each rank's loss is
    its sum over the global mask count (``TPHooks.mean``), so the
    gradients summed over the dp axes (ZeRO-2's reduce-scatter) are the
    global loss's."""
    sh = plan.sharding
    mesh = sh.mesh
    if tf.family(cfg) not in ("uniform", "rwkv6"):
        raise NotImplementedError(
            f"{cfg.name}: the hybrid step trains the uniform family (dense "
            "and MoE) and rwkv6; the mamba TP rules are not ported yet "
            "(ROADMAP.md)")
    M = sh.tp_axis
    tp_n = mesh.shape[M] if M else 1
    base = dataclasses.replace(ctx or ModelCtx(), remat=plan.remat,
                               flash_vjp=sh.dp_heavy or tp_n == 1)
    if loss_fn is None:
        def loss_fn(p, b, c):
            return tf.loss_fn(cfg, p, b, c)
    accum = max(plan.pcfg.microbatches, 1)
    dp = sh.dp_axes
    pspecs = sh.param_specs(cfg, params_shape)
    ospecs = sh.opt_specs(cfg, params_shape)
    zdims = _zero_dims(cfg, sh, params_shape)
    tables = embed_table_plans(sh, {k: pspecs[k] for k in
                                    (sh.embed_plans or {}) if k in pspecs})
    n_b = mesh.size(sh.batch_axes)
    b_idx = mesh.shard_index(sh.batch_axes)
    tc_noclip = dataclasses.replace(tcfg, grad_clip=0.0)

    def shardings_for(params_shape, batch_shape):
        named = sh.named
        osh = tree_map(named, sh.opt_specs(cfg, params_shape))
        return (tree_map(named, sh.param_specs(cfg, params_shape)),
                {"m": osh, "v": osh, "master": osh, "step": named(())},
                tree_map(named, sh.batch_specs(batch_shape)))

    def rows(batch, j, mb, hooks):
        """This rank's rows of micro-batch ``j`` (all of it when the
        micro-batch is replicated over the batch axes)."""
        lo, n = j * mb, mb
        if hooks.rep == 1:
            lo, n = lo + b_idx * (mb // n_b), mb // n_b
        return {k: v[lo:lo + n] if v.dim() else v for k, v in batch.items()}

    def step(params, opt, batch):
        lr = schedule.warmup_cosine(opt["step"], tcfg.learning_rate,
                                    tcfg.warmup_steps, tcfg.steps)
        B, S = batch["tokens"].shape
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} "
                             "micro-batches")
        mb = B // accum
        hooks = sharding_lib.TPHooks(sh, cfg, seq_len=S, rows=mb,
                                     tables=tables)
        c = dataclasses.replace(base, tp=hooks)
        # the gradients: float32 sums over the micro-batches (JAX's scan
        # carry), or the one micro-batch's in the params' dtypes
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32 if accum > 1 else p.dtype,
            device=p.device), params)
        leaves = _grad_leaves(params, grads, add=accum > 1)
        loss, aux_sum = 0.0, None
        for j in range(accum):
            used = (sharding_lib.gather_weights(leaves, pspecs, mesh, M)
                    if sh.dp_heavy and M else leaves)
            total, aux = loss_fn(used, rows(batch, j, mb, hooks), c)
            torch.autograd.backward(total, inputs=_tensors(leaves))
            loss = loss + hooks.total(total)
            if cfg.is_moe:      # the global values from each rank's share
                aux = {k: hooks.total(v) for k, v in aux.items()}
                aux_sum = aux if aux_sum is None else {
                    k: aux_sum[k] + v for k, v in aux.items()}
        metrics = {}
        if aux_sum is not None:
            metrics["aux"] = {k: v / accum for k, v in aux_sum.items()}
        with torch.no_grad():
            if accum > 1:
                tree_map(lambda g: g.div_(accum), grads)
            loss = loss / accum
            # ZeRO-2: each rank keeps only the gradient shard it updates
            grads = adamw.zero_grads(grads, zdims, mesh, dp, pspecs)
            norm = adamw.sharded_global_norm(grads, ospecs, mesh)
            scale = None
            if tcfg.grad_clip > 0:
                scale = torch.clamp(tcfg.grad_clip / torch.clamp(
                    norm, min=1e-9), max=1.0)
            views = _zero_views(params, zdims, mesh, dp)
            _, new_opt = adamw.adamw_apply(views, grads, opt, lr, tc_noclip,
                                           donate=True, grad_scale=scale)
            new_params = adamw.zero_params(views, zdims, mesh, dp, params)
        return new_params, new_opt, {"loss": loss, "lr": lr,
                                     "grad_norm": norm, **metrics}

    return step, shardings_for


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


# ---------------------------------------------------------------------------
# Pipelined DP x TP x stage train step (planner stage bounds -> 1F1B/GPipe
# schedule -> manual Megatron TP -> composed DP gradient sync)
# ---------------------------------------------------------------------------


def pp_trainable(pp_params, tied: bool):
    """The optimizer's view of the pipeline param tree (drops the pad
    mask, which is layout metadata, not a weight)."""
    t = {"stage": {"blocks": pp_params["stage"]["blocks"]},
         "last": pp_params["last"]}
    if not tied:
        t["embed"] = pp_params["embed"]
    return t


def pp_residual_size(cfg: ArchConfig, pp_params_shape, mesh: DPMesh,
                     scfg: DPSyncConfig,
                     embed_sync: Optional[EmbedSyncConfig] = None) -> int:
    """Flat padded size of one rank's compression residual under the
    pipelined step: stage blocks count their LOCAL shard (1/S stages,
    1/tp of each TP-sliced dim), replicated extras count in full, and
    sparse-synced embedding tables are excluded (as in
    :func:`residual_size`).  ``pp_params_shape``: the full pipeline tree,
    or anything with its leaves' ``.shape``."""
    S = mesh.shape["stage"]
    tp = mesh.shape.get("model", 1)
    specs = sharding_lib.pp_stage_specs(
        cfg, pp_params_shape["stage"], mesh)["blocks"]
    n = 0
    for leaf, sp in zip(tree_leaves(pp_params_shape["stage"]["blocks"]),
                        tree_leaves(specs)):
        n += math.prod(leaf.shape) // S // (
            tp if sharding_lib.spec_has_axis(sp, "model") else 1)
    exclude = tuple(embed_sync.id_fns) if embed_sync else ()
    for key in ("last", "embed"):
        if key in pp_params_shape and key not in exclude:
            n += sum(math.prod(x.shape)
                     for x in tree_leaves(pp_params_shape[key]))
    mult = 8 * scfg.block if scfg.mode == "onebit" else scfg.topk_block
    return n + ((-n) % mult)


def pp_shardings(cfg: ArchConfig, mesh: DPMesh, pp_params_shape,
                 scfg: DPSyncConfig = DPSyncConfig()):
    """``NamedSharding`` trees of the pipelined state: ``params`` (the
    stage stack by :func:`~repro_torch.core.sharding.pp_stage_specs`, the
    extras replicated), ``opt`` (m, v, master as the trainable params),
    ``residual`` (the full ``(dp, tp, S, n)`` array of every rank's flat
    residual, JAX's layout) and ``stage_bounds`` (replicated).  Cut a full
    state with ``sharding.device_put``; :func:`train_loop` gathers it back
    for a checkpoint."""
    named = lambda spec: sharding_lib.NamedSharding(mesh, spec)  # noqa: E731
    rep = named(())
    stage = tree_map(named, sharding_lib.pp_stage_specs(
        cfg, pp_params_shape["stage"], mesh))
    params = {"stage": stage,
              "last": tree_map(lambda _: rep, pp_params_shape["last"])}
    if "embed" in pp_params_shape:
        params["embed"] = rep
    tr = pp_trainable(params, "embed" not in pp_params_shape)
    return {"params": params,
            "opt": {"m": tr, "v": tr, "master": tr, "step": rep},
            "residual": named(sharding_lib.P(scfg.intra_axis, "model",
                                             "stage", None)),
            "stage_bounds": rep}


def make_pp_train_step(cfg: ArchConfig, mesh: DPMesh, tcfg: TrainConfig,
                       bounds, pp_params_shape, n_micro: int = 4,
                       pp_schedule: str = "1f1b",
                       scfg: DPSyncConfig = DPSyncConfig(),
                       embed_sync: Optional[EmbedSyncConfig] = None,
                       ctx: Optional[ModelCtx] = None):
    """The DP x TP x stage pipelined train step on this rank.

    step(pp_params, opt, residual, batch) -> (pp_params, opt, residual,
    loss).  ``pp_params`` is this rank's cut (:func:`pp_shardings`) of
    :func:`transformer.pp_partition_params` at ``bounds``: its stage of
    the stack, leading dim 1, with its TP shards, and the replicated
    extras; ``opt`` is ``adamw.init_opt_state`` of its
    :func:`pp_trainable` view, updated in place with the params;
    ``residual`` is its ``(1, 1, 1, pp_residual_size)`` block; ``batch``
    the global batch, of which the step takes this rank's rows over
    ``scfg.intra_axis``.  ``loss`` is the mean over that axis.
    ``pp_params_shape`` is the full pipeline tree (or its shapes).

    Inside: the token embedding runs replicated (its gradient arrives
    through the pipeline's input cotangent), micro-batches pad a
    remainder batch with masked rows, the executor
    (:func:`repro_torch.core.pipeline.make_pipeline_vag_body`) drives the
    stage axis with Megatron-TP stage bodies over ``model``, TP-partial
    gradients (the replicated norm leaves) are summed over ``model`` once,
    and the DP sync stack -- flat / hierarchical / onebit / topk plus the
    rows-touched :class:`EmbedSyncConfig` path -- runs across ``data`` as
    in :func:`make_dp_train_step`; the clip takes the global norm with
    shard-aware accounting.
    """
    S = mesh.shape["stage"]
    tp = mesh.shape.get("model", 1)
    if len(bounds) - 1 != S:
        raise ValueError(f"bounds {bounds} vs stage axis {S}")
    if tp > 1 and cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} must divide tp {tp}")
    if tp > 1 and cfg.num_kv_heads % tp and \
            (cfg.num_heads // tp) % cfg.num_kv_heads:
        # kv falls back to replication when it doesn't divide; the GQA
        # grouping then needs local q heads divisible by the FULL kv count
        raise ValueError(
            f"tp {tp} leaves {cfg.num_heads // tp} local q heads over "
            f"{cfg.num_kv_heads} replicated kv heads -- GQA grouping is "
            f"unexpressible; pick tp with num_kv_heads % tp == 0 or "
            f"(num_heads/tp) % num_kv_heads == 0")
    tied = cfg.tie_embeddings
    if embed_sync is not None and tied:
        raise NotImplementedError(
            "sparse embed sync under pp needs an untied embedding (the "
            "tied table also carries the dense lm-head gradient)")
    ctx = ctx if ctx is not None else ModelCtx(attn_chunk=8)
    stage_fn = tf.make_stage_fn_tp(cfg, ctx, mesh=mesh)
    last_fn = tf.make_last_fn(cfg, ctx)
    vag_body = pipe_lib.make_pipeline_vag_body(
        stage_fn, last_fn, S, n_micro, pp_schedule, mesh=mesh)
    stage_specs = sharding_lib.pp_stage_specs(cfg, pp_params_shape["stage"],
                                              mesh)
    has_model = tree_map(lambda sp: sharding_lib.spec_has_axis(sp, "model"),
                         stage_specs["blocks"])
    axes = (scfg.intra_axis,)
    world, shard = mesh.size(axes), mesh.shard_index(axes)
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
    tcfg_noclip = dataclasses.replace(tcfg, grad_clip=0.0)

    def clip_scale(g):
        """Global-norm clip scale with shard-aware accounting: stage
        blocks sum disjoint shards over (model, stage) -- replicated
        leaves (already summed over model) weighted 1/tp first -- while
        the everywhere-replicated extras count once locally."""
        sq = torch.zeros((), dtype=torch.float32,
                         device=tree_leaves(g)[0].device)
        for leaf, hm in zip(tree_leaves(g["stage"]["blocks"]),
                            tree_leaves(has_model)):
            sq = sq + torch.sum(torch.square(leaf)) / (1.0 if hm else tp)
        sq = hierarchical.all_reduce_sum(sq, mesh, ("model", "stage"))
        for key in ("last", "embed"):
            if key in g:
                sq = sq + sum(torch.sum(torch.square(x))
                              for x in tree_leaves(g[key]))
        norm = torch.sqrt(sq)
        if tcfg.grad_clip <= 0:
            return torch.ones_like(norm), norm
        return torch.clamp(tcfg.grad_clip / torch.clamp(norm, min=1e-9),
                           max=1.0), norm

    def local_batch(batch):
        return {k: v[shard * (v.shape[0] // world):
                     (shard + 1) * (v.shape[0] // world)]
                for k, v in batch.items()}

    def step(params, opt, residual, batch):
        batch = local_batch(batch)
        tokens, targets = batch["tokens"], batch["targets"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        emb = (params["last"]["embed"] if tied
               else params["embed"]).detach().requires_grad_()
        h = layers.embed_tokens(emb, tokens)
        loss, g_stage, g_last, g_x = vag_body(
            params["stage"], params["last"],
            pipe_lib.microbatch(h.detach(), n_micro, pad=True),
            pipe_lib.microbatch(targets, n_micro, pad=True),
            pipe_lib.microbatch(mask.to(torch.float32), n_micro, pad=True))
        # embed grad via the pipeline's input cotangent (pad rows sliced)
        g_h = g_x.reshape((-1,) + tuple(g_x.shape[2:]))[:tokens.shape[0]]
        (g_emb,) = torch.autograd.grad(h, emb, g_h.to(h.dtype))
        with torch.no_grad():
            loss = hierarchical.all_reduce_sum(loss, mesh, axes) / world
            # TP: replicated-leaf grads are per-rank partials -> sum once
            g_blocks = tree_map(
                lambda gl, hm: gl if hm else hierarchical.all_reduce_sum(
                    gl, mesh, ("model",)), g_stage["blocks"], has_model)
            grads = {"stage": {"blocks": g_blocks}, "last": dict(g_last)}
            if tied:
                grads["last"]["embed"] = grads["last"]["embed"] \
                    + g_emb.to(torch.float32)
            else:
                grads["embed"] = g_emb.to(torch.float32)
            # DP sync across `data`: sparse rows-touched tables first, then
            # the dense/compressed path over the rest
            emb_grads = {}
            if embed_sync is not None:
                for key, id_fn in embed_sync.id_fns.items():
                    emb_grads[key] = embed_update.sparse_row_sync(
                        grads[key], id_fn(batch), mesh, axes,
                        cap=embed_sync.cap, compress=row_compress,
                        use_kernel=embed_sync.use_kernel)
                grads = {k: v for k, v in grads.items()
                         if k not in emb_grads}
            if compressed:
                grads, new_res = csync(grads, residual[0, 0, 0])
                if scfg.inter_axis:
                    grads = tree_map(
                        lambda g: hierarchical.flat_allreduce_mean(
                            g, mesh, (scfg.inter_axis,)), grads)
                new_res = new_res[None, None, None]
            else:
                if mesh.size(_dp_axes(scfg)) > 1:   # a mean over one: g
                    grads = gsync(grads)
                new_res = residual
            grads = {**grads, **emb_grads}
            scale, _ = clip_scale(grads)
            lr = schedule.warmup_cosine(opt["step"], tcfg.learning_rate,
                                        tcfg.warmup_steps, tcfg.steps)
            _, new_opt = adamw.adamw_apply(
                pp_trainable(params, tied), grads, opt, lr, tcfg_noclip,
                donate=True, grad_scale=scale)
        return params, new_opt, new_res, loss

    return step


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def probe_stage_times(cfg: ArchConfig, pp_params, bounds, ctx=None,
                      batch: int = 2, seq: int = 16, iters: int = 3,
                      jit_cache: Optional[Dict] = None,
                      tracer: Optional[Tracer] = None):
    """Measured per-stage forward times over each stage's REAL (unpadded)
    layers -- the observe half of the observe->rebalance loop.

    ``pp_params["stage"]`` holds every stage's (padded) blocks, (S, L_max,
    ...).  The executor runs every stage at the widest stage's layer
    count (masked identity slots), so its own tick times cannot see
    imbalance; the probe times each stage's true layer slice, on the
    params' device, the device synchronised around each timed call.
    Returns per-stage median seconds over ``iters`` timed calls.

    ``jit_cache`` (a dict the caller keeps alive): holds the stage
    function across probes, as JAX's holds its jitted program.

    ``tracer``: every timed call lands as one ``stage_tick`` span on track
    ``stage{s}`` (args ``stage``/``phase``/``iter``) with the exact
    measured duration the returned medians reduce over, so
    :func:`repro_torch.obs.timeline.stage_tick_times` recovers the same
    per-stage times from the timeline.
    """
    tracer = or_null(tracer)
    ctx = ctx if ctx is not None else ModelCtx(attn_chunk=8)
    bounds = list(bounds)
    blocks = tf.unstack_stage_params(pp_params["stage"], bounds)
    if jit_cache is not None and "fn" in jit_cache:
        fn = jit_cache["fn"]
    else:
        fn = tf.make_stage_fn(cfg, ctx)
        if jit_cache is not None:
            jit_cache["fn"] = fn
    leaf = tree_leaves(blocks)[0]
    x = torch.zeros((batch, seq, cfg.d_model), dtype=leaf.dtype,
                    device=leaf.device)
    times = []
    with torch.no_grad():
        for s in range(len(bounds) - 1):
            n = bounds[s + 1] - bounds[s]
            sl = tree_map(lambda a: a[bounds[s]:bounds[s + 1]], blocks)
            p = {"blocks": sl, "mask": torch.ones((n,), dtype=torch.float32,
                                                  device=leaf.device)}
            fn(p, x)                                       # warm
            samples = []
            for it in range(iters):
                _sync(leaf.device)
                t0 = time.perf_counter()
                fn(p, x)
                _sync(leaf.device)
                t1 = time.perf_counter()
                samples.append(t1 - t0)
                tracer.complete("stage_tick", t0, t1, track=f"stage{s}",
                                stage=s, phase="fwd", iter=it)
            samples.sort()
            times.append(samples[len(samples) // 2])
    return times


def global_shapes(cfg: ArchConfig, mesh: DPMesh, pp_params):
    """The full pipeline tree's shapes (``meta`` tensors) from this rank's
    cut of it."""
    sh = pp_shardings(cfg, mesh, pp_params)["params"]

    def full(x, s):
        shape = list(x.shape)
        for i, e in enumerate(tuple(s.spec)):
            shape[i] *= mesh.size(sharding_lib._axes(e))
        return torch.empty(shape, dtype=x.dtype, device="meta")
    return tree_map(full, pp_params, sh)


class PPRebalancer:
    """Rebalance-in-the-loop for the pipelined train step.

    Every invocation (``train_loop`` calls it every ``rebalance_every``
    steps): probe per-stage times at the current bounds, re-carve the
    layer->stage partition with :func:`load_balance.rebalance_stages`,
    and -- when the carve points move -- live-remap the stage params *and*
    their AdamW moments with :func:`transformer.remap_stage_params`
    semantics, then rebuild the step for the new bounds.  The model
    function is invariant under the remap (layer order never changes);
    only the stage assignment, pad width and per-stage cost change.  A
    compressed-sync residual is re-zeroed (error feedback restarts warm).

    On a world: each rank gathers its stage stack over the ``stage`` axis
    (its TP shards: the probe then times 1/tp of every stage's work, the
    local head counts read from the shapes), rank 0's stage times are
    broadcast so every rank takes the same bounds, and each rank keeps
    its stage of the remapped stack.
    """

    def __init__(self, cfg: ArchConfig, mesh: DPMesh, tcfg: TrainConfig,
                 bounds, n_micro: int = 4, pp_schedule: str = "1f1b",
                 scfg: DPSyncConfig = DPSyncConfig(), ctx=None,
                 probe_batch: int = 2, probe_seq: int = 16,
                 tracer: Optional[Tracer] = None):
        self.cfg, self.mesh, self.tcfg = cfg, mesh, tcfg
        self.bounds = list(bounds)
        self.n_micro, self.pp_schedule, self.scfg = n_micro, pp_schedule, scfg
        self.ctx = ctx
        self.probe_batch, self.probe_seq = probe_batch, probe_seq
        self.history = [list(bounds)]
        self.last_stage_times = None
        self._probe_cache: Dict = {}    # one stage function across probes
        self.tracer = or_null(tracer)

    def _whole(self, tree):
        """Every stage's blocks: ``tree``'s leaves gathered over stage."""
        return tree_map(lambda a: hierarchical.gather_dim(
            a, self.mesh, ("stage",), 0), tree)

    def _mine(self, tree):
        s = self.mesh.coords["stage"]
        return tree_map(lambda a: a[s:s + 1].clone(), tree)

    def _times(self, stage):
        n_stages = len(self.bounds) - 1
        if self.tracer.enabled:
            # the rebalancer reads the timeline: the probe's stage_tick
            # spans go into a probe-local tracer, the loop's trace
            # absorbs them, and the stage times come back out of them
            probe_tr = Tracer(capacity=4096)
            probe_stage_times(self.cfg, {"stage": stage}, self.bounds,
                              self.ctx, self.probe_batch, self.probe_seq,
                              jit_cache=self._probe_cache, tracer=probe_tr)
            self.tracer.extend(probe_tr.events)
            times = obs_timeline.stage_tick_times(probe_tr.events, n_stages)
        else:
            times = probe_stage_times(self.cfg, {"stage": stage},
                                      self.bounds, self.ctx,
                                      self.probe_batch, self.probe_seq,
                                      jit_cache=self._probe_cache)
        t = torch.tensor([float(x) for x in times], dtype=torch.float64)
        if dist.get_world_size() > 1:           # one decision for all
            dist.broadcast(t, src=0)
        return [float(x) for x in t]

    def __call__(self, state, step_fn):
        stage = self._whole(state["params"]["stage"])
        times = self._times(stage)
        self.last_stage_times = times
        new_bounds = load_balance.rebalance_stages(times, self.bounds)
        self.tracer.instant(
            "rebalance.decision", track="train",
            old_bounds=list(self.bounds), new_bounds=list(new_bounds),
            stage_times=[float(t) for t in times],
            changed=new_bounds != self.bounds)
        if new_bounds == self.bounds:
            return None
        params = dict(state["params"])
        params["stage"] = self._mine(tf.remap_stage_params(
            stage, self.bounds, new_bounds))
        del stage
        opt = dict(state["opt"])
        for key in ("m", "v", "master"):
            if key in opt and "stage" in opt[key]:
                whole = self._whole(opt[key]["stage"]["blocks"])
                opt[key] = {**opt[key], "stage": {"blocks": self._mine(
                    tf.remap_stage_params({"blocks": whole}, self.bounds,
                                          new_bounds)["blocks"])}}
        device = state["opt"]["step"].device
        new_state = {**state, "params": params, "opt": opt,
                     "stage_bounds": torch.tensor(new_bounds,
                                                  dtype=torch.int32,
                                                  device=device)}
        pp_shape = global_shapes(self.cfg, self.mesh, params)
        if "residual" in state and state["residual"].shape[-1]:
            # always restart error feedback: even at an unchanged flat
            # size, moving the carve point re-aligns residual entries to
            # different layers' gradients
            n_res = pp_residual_size(self.cfg, pp_shape, self.mesh,
                                     self.scfg)
            new_state["residual"] = torch.zeros(
                tuple(state["residual"].shape[:-1]) + (n_res,),
                dtype=state["residual"].dtype,
                device=state["residual"].device)
        new_step = make_pp_train_step(
            self.cfg, self.mesh, self.tcfg, new_bounds, pp_shape,
            n_micro=self.n_micro, pp_schedule=self.pp_schedule,
            scfg=self.scfg, ctx=self.ctx)
        self.bounds = new_bounds
        self.history.append(list(new_bounds))
        return new_state, new_step


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
    # per step, the hybrid step's ``metrics["aux"]`` (MoE) as floats/lists
    aux: list = dataclasses.field(default_factory=list)


def train_loop(state: Dict[str, Any], batches: Iterator, step_fn: Callable,
               tcfg: TrainConfig, *, start_step: int = 0,
               tokens_per_batch: int = 0, samples_per_batch: int = 0,
               fail_at: Optional[int] = None,
               rebalance_every: int = 0,
               rebalance_fn: Optional[Callable] = None,
               log_every: int = 10, verbose: bool = False,
               tracer: Optional[Tracer] = None,
               shardings=None) -> TrainResult:
    """Generic loop: state = {'params', 'opt', ['residual']}, with
    ``step_fn(params, opt, residual, batch) -> (params, opt, residual,
    loss)`` when the state has a residual (the DP step), else
    ``step_fn(params, opt, batch) -> (params, opt, metrics)`` (the hybrid
    step).

    Every ``tcfg.checkpoint_every`` steps the state is saved to
    ``tcfg.checkpoint_dir`` (keeping ``tcfg.keep_checkpoints``);
    ``shardings`` (a tree of ``NamedSharding`` like the state's) lets
    :func:`repro_torch.checkpoint.manager.save` gather a sharded state.

    ``fail_at``: inject a simulated node failure (raises RuntimeError) after
    that step commits; the fault-tolerance tests restart from checkpoint.

    ``rebalance_every`` / ``rebalance_fn``: close the observe->rebalance
    loop in training.  Every K committed steps the loop calls
    ``rebalance_fn(state, step_fn)``; a ``None`` return keeps the current
    partition, otherwise the returned ``(state, step_fn)`` -- e.g. from
    :class:`PPRebalancer`, which re-carves the pipeline's layer->stage
    bounds from measured per-stage times -- replaces both for the steps
    that follow.  A state's ``stage_bounds`` ride in its checkpoints.

    ``tracer``: per-step ``train_step`` spans (host wall clock, args
    ``step``/``loss``), ``rebalance.probe`` spans around each rebalance
    hook, and ``checkpoint`` spans, as the JAX loop's."""
    tr = or_null(tracer)
    losses, auxs = [], []
    t0 = time.perf_counter()
    step = start_step
    n = 0
    for batch in batches:
        if rebalance_every and rebalance_fn is not None and n > 0 \
                and n % rebalance_every == 0:
            with tr.span("rebalance.probe", track="train", step=step):
                new = rebalance_fn(state, step_fn)
            if new is not None:
                state, step_fn = new
                if verbose:
                    print(f"step {step}: rebalanced "
                          f"(bounds {getattr(rebalance_fn, 'bounds', '?')})")
        with tr.span("train_step", track="train", step=step) as sp:
            if "residual" in state:
                state["params"], state["opt"], state["residual"], loss = \
                    step_fn(state["params"], state["opt"],
                            state["residual"], batch)
                metrics = {"loss": loss}
            else:
                state["params"], state["opt"], metrics = step_fn(
                    state["params"], state["opt"], batch)
            losses.append(float(metrics["loss"]))
            if "aux" in metrics:
                auxs.append({k: v.tolist() for k, v in
                             metrics["aux"].items()})
            if tr.enabled:
                sp.args["loss"] = losses[-1]
        step += 1
        n += 1
        if verbose and step % log_every == 0:
            print(f"step {step}: loss {losses[-1]:.4f}")
        if tcfg.checkpoint_every and step % tcfg.checkpoint_every == 0:
            with tr.span("checkpoint", track="train", step=step):
                keys = [k for k in ("params", "opt", "residual",
                                    "stage_bounds") if k in state]
                ckpt.save(tcfg.checkpoint_dir, step,
                          {k: state[k] for k in keys},
                          keep=tcfg.keep_checkpoints,
                          shardings=(None if shardings is None else
                                     {k: shardings[k] for k in keys}))
        if fail_at is not None and step >= fail_at:
            raise RuntimeError(f"injected failure at step {step}")
    dt = time.perf_counter() - t0
    tput = samples_per_batch * n / dt if dt > 0 else 0.0
    return TrainResult(steps_run=n, final_step=step, losses=losses,
                       throughput=tput, aux=auxs)


def resume_or_init(init_state: Dict[str, Any], tcfg: TrainConfig,
                   shardings=None) -> Tuple[int, Dict[str, Any]]:
    """Restore the latest valid checkpoint (fault tolerance) or start
    fresh; ``shardings`` cuts the restored full arrays to this rank's
    blocks on the current mesh."""
    step, tree = ckpt.restore_latest(tcfg.checkpoint_dir, init_state,
                                     shardings)
    if step is None:
        return 0, init_state
    return step, tree
