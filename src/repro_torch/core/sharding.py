"""Sharding plan: logical-axis partition rules -> partition specs (paper
C1/C8); port of ``repro/core/sharding.py``, with the hand-written tensor
parallelism that stands for its ``constrain``.

Megatron-style tensor parallelism over the ``model`` mesh axis, batch over
``data`` (and ``pod``), MoE experts over ``model`` (expert parallelism),
optimizer state additionally ZeRO-1 sharded over the dp axes, activations
optionally sequence-sharded over ``model`` (Megatron-SP).

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of axis names, read as JAX reads a ``PartitionSpec`` (a tuple of one
name is that name; :func:`P` builds one).  Every sharded dim is
divisibility-guarded: a dim that does not divide over its axes falls back
to replication.  The rules of every family are copied (pure logic); the
hybrid train step (``runtime/trainer.py``) runs the uniform family, dense
and MoE, and the rwkv6 family.  :func:`pp_stage_specs` lays out the
pipelined step's stage stack.
``cache_specs`` (serving) is not ported yet (``ROADMAP.md``).

Embedding tables route through the sparse-embedding subsystem: top-level
param keys named in ``embed_plans`` (the recsys CF factor tables) take
their placement from an :class:`~repro_torch.embeddings.table.EmbedPlan`
(row / col / 2D sharding on the same mesh) instead of the LM rules, and
the model looks them up through the sharded lookup
(``embeddings/lookup.py``: ``tp_embed_lookup``, ``tp_embed_rows``).

Under GSPMD ``constrain`` pins activation shardings and XLA inserts the
collectives; here :class:`TPHooks` is that placement done by hand, through
autograd-aware collectives whose backward is the conjugate of their
forward (identity <-> all-reduce, all-gather <-> reduce-scatter):

* the attention and MLP products are Megatron's column-parallel ``wq``,
  ``wk``, ``wv``, ``wi_gate``, ``wi_up`` and row-parallel ``wo`` on each
  rank's heads and ``d_ff`` slice; their outputs are all-reduced over
  ``model``, or, under SP, reduce-scattered along the sequence, with an
  all-gather before the next column-parallel product and the norms on the
  sequence shard;
* ``k``/``v`` are replicated over ``model`` when ``num_kv_heads`` does not
  divide (the GQA rule): each rank takes the kv heads its q heads read;
* the embedding and the LM head are vocab-parallel: a masked local lookup
  then an all-reduce, and the cross-entropy's row max, sum of exps and
  target logit reduced over ``model``;
* a replicated leaf whose use on a rank sees only part of the work (the
  norms under SP, replicated ``wk``/``wv``, RecLLM's CF tables beside a
  vocab shard) enters through the identity whose backward all-reduces,
  so its gradient is the whole sum on every rank;
* the loss is the global mean: the mask count is summed over the batch
  axes, so each rank's loss is its own sum over that count;
* a table sharded by an embed plan is looked up by the sharded lookup
  body (a masked local gather all-reduced over its row axis, ids
  all-gathered and an all-to-all over its column axis), whose result
  enters the vocab-parallel work through the identity above;
* MoE experts lie over ``model`` (expert parallelism, JAX's
  ``expert_stack``): the FFN branch enters and leaves as a Megatron MLP
  does, each rank routing every token with the replicated router (its
  gradient summed over ``model``) and running its ``E / tp`` experts;
  under the FSDP-expert rule their ``d_ff`` also lies over the dp axes,
  all-gathered at use.  The Switch aux losses are the global batch's
  (``batch_mean``, ``mean``), their gradients counted once over
  ``model`` (``once``);
* rwkv6's time mix is column-parallel in ``Wr``, ``Wk``, ``Wv``, ``Wg``
  and ``w_lora_b`` (this rank's heads, head-major, with their ``w_base``
  channels and ``u`` rows) and row-parallel in ``Wo``; its channel mix
  column-parallel in ``Wk`` and row-parallel in ``Wv``, the replicated
  ``Wr``'s gate applied to this rank's partial output before the sum.
  Both take the token shift on the whole sequence (after ``enter``).
  ``mix``, ``w_lora_a`` and the channel mix's ``Wr`` enter through the
  identity above; ``ln_x``, a layer norm over all ``d`` channels, runs on
  the channels all-gathered (``channel_norm``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import ArchConfig, ParallelConfig
from repro_torch.core import hierarchical as hier
from repro_torch.core.hierarchical import DPMesh
from repro_torch.models import layers
from repro_torch.tree import tree_map


# a device's expert bytes (bf16, after EP) above which the expert weights'
# d_ff dim is also sharded over the dp axes (ShardingPlan.fsdp_experts)
FSDP_EXPERT_BYTES = 2e9


def P(*dims) -> Tuple:
    """A spec, entries normalised as JAX's ``PartitionSpec`` stores them (a
    tuple of one axis name is that name)."""
    return tuple(d[0] if isinstance(d, tuple) and len(d) == 1 else d
                 for d in dims)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in _axes(axes))


def _map_with_path(fn: Callable, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts (sorted keys)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    return fn(path, tree)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: DPMesh
    dp_axes: Tuple[str, ...]          # ('data',) or ('pod', 'data')
    tp_axis: Optional[str]            # 'model' or None
    seq_shard: bool = True            # Megatron-SP residual stream
    zero1: bool = True
    # dp_heavy (auto-planner, dense archs): batch shards over ALL mesh axes
    # (model included); weights stay model-sharded for storage and are
    # all-gathered at use (FSDP) -- activations never reshard.
    dp_heavy: bool = False
    # top-level param keys placed by the embeddings subsystem (name ->
    # embeddings.table.EmbedPlan) rather than the LM rules: the recsys CF
    # tables under the hybrid mesh
    embed_plans: Optional[Dict[str, Any]] = None

    # -- helpers -----------------------------------------------------------

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        if self.dp_heavy and self.tp_axis is not None:
            return self.dp_axes + (self.tp_axis,)
        return self.dp_axes

    def guard(self, spec: Sequence, shape: Sequence[int]) -> Tuple:
        """Drop sharding on any dim that does not divide evenly."""
        out = []
        for dim_spec, size in zip(spec, shape):
            if dim_spec is None:
                out.append(None)
            elif size % _axis_size(self.mesh, dim_spec) == 0 and size > 0:
                out.append(dim_spec)
            else:
                out.append(None)
        return P(*out)

    def named(self, spec: Tuple) -> "NamedSharding":
        return NamedSharding(self.mesh, spec)

    # -- parameters ---------------------------------------------------------

    def fsdp_experts(self, cfg: ArchConfig) -> bool:
        """FSDP for expert weights: when a device's expert bytes after EP
        sharding are still above :data:`FSDP_EXPERT_BYTES`, the ``d_ff``
        dim is sharded over the dp axes too (the weights all-gathered at
        use, their gradients reduce-scattered back)."""
        M = self.tp_axis
        if not cfg.is_moe or M is None:
            return False
        mats = 3 if cfg.mlp_gated else 2
        n_moe_layers = sum(1 for i in range(cfg.num_layers)
                           if i % cfg.moe_period == cfg.moe_period - 1)
        expert_bytes = (n_moe_layers * cfg.num_experts * mats * cfg.d_model
                        * cfg.d_ff * 2 / max(self.mesh.shape[M], 1))
        return expert_bytes > FSDP_EXPERT_BYTES

    def param_specs(self, cfg: ArchConfig, params_shape) -> Any:
        """Tree of specs matching a params tree (of tensors, or anything
        with ``.shape``)."""
        M = self.tp_axis
        q_ok = M is not None and cfg.num_heads % self.mesh.shape[M] == 0
        kv_ok = M is not None and cfg.num_kv_heads % self.mesh.shape[M] == 0

        fsdp_experts = self.fsdp_experts(cfg)

        def rule(names, leaf) -> Tuple:
            last = names[-1]
            shape = tuple(leaf.shape)
            if self.embed_plans and names[0] in self.embed_plans \
                    and len(shape) == 2:
                ep = self.embed_plans[names[0]]
                return self.guard((ep.row_axis, ep.col_axis), shape)
            base: Tuple = ()
            if "moe" in names:
                dp = self.dp_axes if len(self.dp_axes) > 1 \
                    else self.dp_axes[0]
                if last == "router":
                    base = (None, None)
                elif fsdp_experts and last in ("wi", "wi_gate", "wi_up"):
                    base = (M, None, dp)                # (E, d, f): f over dp
                elif fsdp_experts and last == "wo":
                    base = (M, dp, None)                # (E, f, d)
                else:                                   # (E, din, dout)
                    base = (M, None, None)
            elif "mlp" in names or "cmix" in names:
                if last in ("wi", "wi_gate", "wi_up", "Wk"):
                    base = (None, M)
                elif last in ("wo", "Wv"):
                    base = (M, None)
                elif last == "Wr":
                    base = (None, None)
                elif last == "mix":
                    base = (None, None)
                else:
                    base = (None,) * 2
            elif "tmix" in names:
                if last in ("Wr", "Wk", "Wv", "Wg"):
                    base = (None, M)
                elif last == "Wo":
                    base = (M, None)
                elif last == "w_lora_b":
                    base = (None, M)
                elif last == "u":
                    base = (M, None)
                elif last in ("w_base",):
                    base = (M,)
                elif last in ("scale", "bias"):
                    base = (None,)
                elif last == "mix":
                    base = (None, None)
                else:
                    base = (None,) * len(shape)
            elif "m" in names or "mamba" in names:      # mamba inner
                if last in ("in_proj",):
                    base = (None, M)
                elif last in ("conv_w",):
                    base = (None, M)
                elif last in ("x_proj", "A_log", "out_proj"):
                    base = (M, None)
                elif last in ("D", "dt_bias"):
                    base = (M,)
                elif last in ("scale", "bias"):
                    base = (None,)
                else:
                    base = (None,) * len(shape)
            elif "attn" in names or "cross" in names:
                if last == "wq":
                    base = (None, M if q_ok else None)
                elif last in ("wk", "wv"):
                    base = (None, M if kv_ok else None)
                elif last == "wo":
                    base = (M if q_ok else None, None)
                else:                                   # norms, q/k_norm
                    base = (None,) * len(shape)
            elif last == "embed":
                base = (M, None)
            elif last == "lm_head":
                base = (None, M)
            elif last == "dec_pos":
                base = (None, None)
            else:                                       # final norms etc.
                base = (None,) * len(shape)
            # prepend Nones for stacked layer/period dims
            full = (None,) * (len(shape) - len(base)) + tuple(base)
            return self.guard(full, shape)

        return _map_with_path(rule, params_shape)

    # -- optimizer state (ZeRO-1) --------------------------------------------

    def zero1_spec(self, pspec: Tuple, shape: Sequence[int]) -> Tuple:
        """Add dp axes to the largest unsharded, divisible dim (ZeRO-1)."""
        if not self.zero1:
            return pspec
        dp_n = _axis_size(self.mesh, self.dp_axes)
        spec = list(pspec) + [None] * (len(shape) - len(pspec))
        # already dp-sharded (e.g. FSDP expert weights): nothing to add
        used = set()
        for s in spec:
            used.update(_axes(s))
        if used & set(self.dp_axes):
            return pspec
        best, best_size = -1, 0
        for i, (sp, size) in enumerate(zip(spec, shape)):
            if sp is None and size % dp_n == 0 and size > best_size:
                best, best_size = i, size
        if best >= 0:
            spec[best] = self.dp_axes if len(self.dp_axes) > 1 \
                else self.dp_axes[0]
        return P(*spec)

    def opt_specs(self, cfg: ArchConfig, params_shape) -> Any:
        pspecs = self.param_specs(cfg, params_shape)
        return tree_map(lambda sp, leaf: self.zero1_spec(sp, leaf.shape),
                        pspecs, params_shape)

    # -- batches -------------------------------------------------------------

    def batch_specs(self, batch_shape) -> Any:
        def rule(names, leaf) -> Tuple:
            shape = tuple(leaf.shape)
            if len(shape) == 0:
                return P()
            base = (self.batch_axes,) + (None,) * (len(shape) - 1)
            return self.guard(base, shape)
        return _map_with_path(rule, batch_shape)


def pp_stage_specs(cfg: ArchConfig, stage_shape, mesh,
                   tp_axis: str = "model", stage_axis: str = "stage") -> Any:
    """Specs for the stage-stacked uniform blocks ({"blocks": (S, L_max,
    ...), "mask": (S, L_max)} from ``transformer.stage_slice_params``):
    leading dim over ``stage_axis``, Megatron TP dims over ``tp_axis``
    where head / d_ff counts divide (non-dividing dims replicate, the
    guard rule of ``param_specs``).  The pipelined step cuts its stage
    by them, and reads "has a tp dim" to tell exact local gradient shards
    from per-rank partials that need a sum over ``tp_axis``."""
    tp = mesh.shape.get(tp_axis, 1)
    q_ok = cfg.num_heads % tp == 0
    kv_ok = cfg.num_kv_heads % tp == 0
    ff_ok = cfg.d_ff % tp == 0
    M = tp_axis

    def rule(names, leaf):
        last = names[-1]
        nd = len(leaf.shape)
        if last == "mask":
            return P(stage_axis, None)
        if last == "wq":
            base = (None, M if q_ok else None)
        elif last in ("wk", "wv"):
            base = (None, M if kv_ok else None)
        elif last == "wo" and "attn" in names:
            base = (M if q_ok else None, None)
        elif last in ("wi", "wi_gate", "wi_up"):
            base = (None, M if ff_ok else None)
        elif last == "wo":                          # mlp down-projection
            base = (M if ff_ok else None, None)
        else:                                       # norms, qk_norm
            base = (None,) * max(nd - 2, 0)
        return P(stage_axis, *((None,) * (nd - 1 - len(base)) + base))

    return _map_with_path(rule, stage_shape)


def spec_has_axis(spec: Tuple, axis: str) -> bool:
    return any(axis in _axes(dim) for dim in spec)


def make_plan(mesh: DPMesh, pcfg: ParallelConfig,
              seq_shard: Optional[bool] = None,
              dp_heavy: bool = False,
              embed_plans: Optional[Dict[str, Any]] = None
              ) -> ShardingPlan:
    axes = set(mesh.axis_names)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    tp_axis = "model" if "model" in axes else None
    return ShardingPlan(
        mesh=mesh,
        dp_axes=dp_axes or ("data",),
        tp_axis=tp_axis,
        seq_shard=pcfg.seq_shard_activations if seq_shard is None
        else seq_shard,
        zero1=True,
        dp_heavy=dp_heavy,
        embed_plans=embed_plans,
    )


# ---------------------------------------------------------------------------
# Placement: full arrays <-> this rank's shards
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: how one full array lies across the ranks (the
    counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: DPMesh
    spec: Tuple

    def _dims(self, ndim: int):
        """(dim, axes) of every dim sharded over more than one rank."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [(i, _axes(e)) for i, e in enumerate(spec)
                if self.mesh.size(_axes(e)) > 1]

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full array ``x`` (a copy, so the full
        array can be freed; ``x`` itself when nothing is sharded)."""
        out = x
        for i, axes in self._dims(x.dim()):
            n = self.mesh.size(axes)
            c = x.shape[i] // n
            out = out.narrow(i, self.mesh.shard_index(axes) * c, c)
        return out if out is x else out.clone()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full array from every rank's block (collective over the
        sharded dims' axes; every rank gets it)."""
        for i, axes in self._dims(x.dim()):
            x = hier.gather_dim(x, self.mesh, axes, i)
        return x


def device_put(tree, shardings):
    """Every leaf of a full tree cut to this rank's block."""
    return tree_map(lambda x, s: s.shard(x), tree, shardings)


def gather(tree, shardings):
    """Every leaf of a tree of this rank's blocks made whole."""
    return tree_map(lambda x, s: s.gather(x), tree, shardings)


# ---------------------------------------------------------------------------
# Tensor parallelism by hand: autograd-aware collectives and the model hooks
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.where = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return hier.all_reduce_sum(g, *ctx.where), None, None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return hier.all_reduce_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather on ``dim`` forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.where = (mesh, axes, dim)
        return hier.gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return hier.reduce_scatter_dim(g, *ctx.where), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter on ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.where = (mesh, axes, dim)
        return hier.reduce_scatter_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return hier.gather_dim(g, *ctx.where), None, None, None


class _AllToAll(torch.autograd.Function):
    """All-to-all over one axis (``split_dim`` blocks swapped for
    ``concat_dim`` blocks) forward, the inverse all-to-all backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.where = (mesh, axis, concat_dim, split_dim)
        return hier.all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return hier.all_to_all(g, *ctx.where), None, None, None, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward, the gradient times ``s`` backward."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


class _VocabNLL(torch.autograd.Function):
    """Per-position NLL over vocab-sharded logits: the row max and the sum
    of exps all-reduced over ``model``, the target's logit from the rank
    that holds its column.  Backward as the plain NLL's: ``g * (softmax -
    onehot)`` on this rank's columns, in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, targets, off, mesh, axes):
        group = mesh.group(axes)
        m = torch.amax(logits, dim=-1).float()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        s = torch.sum(torch.exp(logits.float() - m[..., None]), dim=-1)
        dist.all_reduce(s, group=group)
        lse = m + torch.log(s)
        local = targets.long() - off
        mine = (local >= 0) & (local < logits.shape[-1])
        local = torch.where(mine, local, torch.zeros_like(local))
        gold = torch.gather(logits, -1, local[..., None])[..., 0].float()
        gold = torch.where(mine, gold, torch.zeros_like(gold))
        dist.all_reduce(gold, group=group)
        ctx.save_for_backward(logits, local, mine, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, local, mine, lse = ctx.saved_tensors
        d = torch.exp(logits.float() - lse[..., None])
        d.scatter_add_(-1, local[..., None], -mine[..., None].float())
        return (g[..., None] * d).to(logits.dtype), None, None, None, None


class TPHooks:
    """What ``ShardingPlan.constrain`` places under GSPMD, for one
    micro-batch of ``rows`` sequences of ``seq_len`` tokens: the model's
    collectives (Megatron TP over ``model``, SP) and the loss's global
    mean over the plan's batch axes.  ``ModelCtx.tp`` carries it through
    the stack; ``None`` there is the plain single-rank model.

    Megatron TP runs when the plan has a ``model`` axis of size > 1 and is
    not ``dp_heavy`` (``dp_heavy`` gathers the weights before the model
    runs: :func:`gather_weights`).  SP runs when the plan asks for it and
    ``seq_len`` divides over ``model`` (the guard of the ``residual``
    constraint).  A micro-batch whose rows do not divide over the batch
    axes is replicated over them, as the guard replicates it: every rank
    then computes the whole loss, and :meth:`mean` divides it by the
    number of ranks so that the gradient sums stay exact.

    ``tables`` maps each table of ``plan.embed_plans`` to the plan it is
    looked up by (``embeddings.lookup.embed_table_plans``), for the
    model's ``tp_embed_lookup``/``tp_embed_rows``.

    For an MoE arch, ``experts`` is this rank's expert range under EP
    (``num_experts`` must split over ``model``: JAX's guard replicates
    experts that do not, the port refuses them), and ``fsdp_axes`` the dp
    axes the experts' ``d_ff`` lies over under the FSDP-expert rule.

    For rwkv6 the time mix's heads (``d_model / rwkv_head_size``) and the
    channel mix's ``d_ff`` must split over ``model`` likewise; the models
    (``models/ssm.py``) place the rest through :meth:`enter`,
    :meth:`copy`, :meth:`channel_norm` and :meth:`exit`."""

    def __init__(self, plan: ShardingPlan, cfg: ArchConfig, *, seq_len: int,
                 rows: int, tables: Optional[Dict[str, Any]] = None):
        mesh = self.mesh = plan.mesh
        M = plan.tp_axis
        self.axis = (M,) if M else ()
        n = mesh.shape[M] if M else 1
        self.tp = 1 if plan.dp_heavy else n
        self.rank = mesh.coords[M] if self.tp > 1 else 0
        self.seq = self.tp > 1 and plan.seq_shard and seq_len % n == 0
        self.batch_axes = plan.batch_axes
        n_b = mesh.size(self.batch_axes)
        self.rep = 1 if rows % n_b == 0 else n_b
        self.vocab_off, self.kv_cols = 0, None
        self.tables = dict(tables or {})
        # EP: this rank's experts [lo, hi) (None: all of them)
        self.experts = None
        # the FSDP-expert rule: the dp axes the experts' d_ff lies over
        # (empty where the guard replicates it, or at one dp rank)
        dp_n = mesh.size(plan.dp_axes)
        self.fsdp_axes = (tuple(plan.dp_axes) if plan.fsdp_experts(cfg)
                          and dp_n > 1 and cfg.d_ff % dp_n == 0 else ())
        if self.tp > 1:
            self._check(cfg)
            self.vocab_off = self.rank * cfg.padded_vocab // n
            if cfg.is_moe:
                e = cfg.num_experts // n
                self.experts = (self.rank * e, (self.rank + 1) * e)
            hq = cfg.num_heads // n
            if cfg.num_kv_heads % n:            # GQA rule: kv replicated
                g = cfg.num_heads // cfg.num_kv_heads
                lo = self.rank * hq // g
                hi = ((self.rank + 1) * hq - 1) // g + 1
                self.kv_cols = (lo * cfg.head_dim, hi * cfg.head_dim)

    def _check(self, cfg: ArchConfig) -> None:
        n = self.tp
        hq = cfg.num_heads // n
        g = cfg.num_heads // cfg.num_kv_heads
        # an MoE arch's d_ff is the per-expert width, which EP leaves whole
        dense_ffn = not cfg.is_moe or cfg.moe_period > 1
        bad = [what for what, ok in (
            ("num_heads", cfg.num_heads % n == 0),
            ("d_ff", not dense_ffn or cfg.d_ff % n == 0),
            ("num_experts", not cfg.is_moe or cfg.num_experts % n == 0),
            ("padded_vocab", cfg.padded_vocab % n == 0),
            ("the local q heads' kv grouping",
             cfg.num_kv_heads % n == 0 or hq % g == 0 or g % hq == 0),
            ("the rwkv6 heads", cfg.ssm_type != "rwkv6"
             or (cfg.d_model // cfg.rwkv_head_size) % n == 0),
        ) if not ok]
        if bad:
            raise NotImplementedError(
                f"{cfg.name} at tp {n}: {', '.join(bad)} do not split over "
                "model; a Megatron plan that replicates those blocks is not "
                "ported (ROADMAP.md)")

    # -- collectives on the residual stream ---------------------------------

    def copy(self, x):
        """A replicated tensor entering a rank's share of the work: its
        gradient is summed over ``model``."""
        return _Copy.apply(x, self.mesh, self.axis) if self.tp > 1 else x

    def enter(self, h):
        """Before a column-parallel product: the whole sequence (SP: an
        all-gather) with a gradient summed over ``model``."""
        if self.seq:
            return _Gather.apply(h, self.mesh, self.axis, 1)
        return self.copy(h)

    def exit(self, y):
        """After a row-parallel product: the partial outputs summed over
        ``model`` (SP: reduce-scattered along the sequence)."""
        if self.seq:
            return _Scatter.apply(y, self.mesh, self.axis, 1)
        if self.tp > 1:
            return _Reduce.apply(y, self.mesh, self.axis)
        return y

    def norm(self, p):
        """A norm's parameters: under SP the norm sees a sequence shard."""
        return tree_map(self.copy, p) if self.seq else p

    def channel_norm(self, norm_cfg, p, x):
        """A norm over the whole channel dim of ``x``, whose last dim holds
        this rank's contiguous block of channels (a column-parallel
        product's output): the channels all-gathered over ``model`` (their
        gradient reduce-scattered back), normed with the replicated ``p``
        (its gradient summed over ``model``), this rank's block kept."""
        if self.tp == 1:
            return layers.apply_norm(norm_cfg, p, x)
        c = x.shape[-1]
        full = _Gather.apply(x, self.mesh, self.axis, x.dim() - 1)
        y = layers.apply_norm(norm_cfg, tree_map(self.copy, p), full)
        return y[..., self.rank * c:(self.rank + 1) * c]

    def kv_weights(self, wk, wv):
        """``wk``/``wv`` as this rank uses them: its kv heads' columns of
        the replicated weights under the GQA rule, else its shard."""
        if self.kv_cols is None:
            return wk, wv
        lo, hi = self.kv_cols
        return self.copy(wk)[:, lo:hi], self.copy(wv)[:, lo:hi]

    # -- vocabulary ---------------------------------------------------------

    def embed(self, emb, tokens):
        """The token embedding: a masked lookup in this rank's vocab rows,
        then summed over ``model`` (under SP, reduce-scattered along the
        sequence)."""
        if self.tp == 1:
            return layers.embed_tokens(emb, tokens)
        local = tokens.long() - self.vocab_off
        mine = (local >= 0) & (local < emb.shape[0])
        local = torch.where(mine, local, torch.zeros_like(local))
        h = layers.embed_tokens(emb, local) * mine[..., None].to(emb.dtype)
        return self.exit(h)

    def vocab_rows(self, table):
        """This rank's vocab rows of a replicated ``(V, ...)`` table."""
        if self.tp == 1:
            return table
        n_rows = table.shape[0] // self.tp
        return self.copy(table)[self.vocab_off:self.vocab_off + n_rows]

    def nll(self, logits, targets):
        if self.tp == 1:
            return layers._nll(logits, targets)
        return _VocabNLL.apply(logits, targets, self.vocab_off, self.mesh,
                               self.axis)

    # -- MoE: expert parallelism over ``model`` -------------------------------

    def expert_weight(self, w, dim: int):
        """An expert leaf as this rank uses it: under the FSDP-expert rule
        its ``d_ff`` dim ``dim`` all-gathered over the dp axes, its
        gradient reduce-scattered back onto the shard (summed over the dp
        ranks there)."""
        if not self.fsdp_axes:
            return w
        return _Gather.apply(w, self.mesh, self.fsdp_axes, dim)

    def batch_mean(self, x):
        """The mean over the batch axes of a per-rank mean ``x`` taken
        over equal row counts, without a gradient (the top-1 shares of
        the Switch loss: one-hots)."""
        x = x.detach()
        if self.rep > 1:
            return x
        return (hier.all_reduce_sum(x, self.mesh, self.batch_axes)
                / self.mesh.size(self.batch_axes))

    def once(self, x):
        """A loss term that every ``model`` rank computes whole from the
        same tokens (the router's aux losses under EP): its value kept,
        its gradient divided by tp, so that the sums over ``model`` of
        ``enter``'s and ``copy``'s backward count it once."""
        if self.tp == 1:
            return x
        return _ScaleGrad.apply(x, 1.0 / self.tp)

    # -- the loss -------------------------------------------------------------

    def mean(self, s, n):
        """This rank's share of the global mean ``sum(s) / sum(n)`` over
        the batch axes (``n`` carries no gradient)."""
        if self.rep > 1:
            return s / torch.clamp(n, min=1.0) / self.rep
        n = hier.all_reduce_sum(n.detach().float(), self.mesh,
                                self.batch_axes)
        return s / torch.clamp(n, min=1.0)

    def total(self, loss):
        """The global loss from each rank's share (no gradient)."""
        return hier.all_reduce_sum(loss.detach().float(), self.mesh,
                                   self.batch_axes)


def gather_weights(params, pspecs, mesh: DPMesh, axis: str):
    """``dp_heavy``'s weights at use: each leaf's ``axis``-sharded dims
    all-gathered (gradient reduce-scattered back), the replicated leaves
    through the identity whose gradient is summed over ``axis``."""
    def one(p, spec):
        if isinstance(p, list):         # a stacked leaf, one leaf a layer
            return [one(x, spec[1:]) for x in p]
        dims = [i for i, e in enumerate(spec) if axis in _axes(e)]
        if mesh.shape[axis] == 1:
            return p
        if not dims:
            return _Copy.apply(p, mesh, (axis,))
        for i in dims:
            p = _Gather.apply(p, mesh, (axis,), i)
        return p
    return tree_map(one, params, pspecs)
