"""RecLLM: the paper's LLM-based recommender (Fig. 1); port of
``repro/recsys/model.py``.

A decoder-only LM over item-token sequences gives next-item logits; a CF
(matrix-factorization) head over user/item embeddings gives collaborative
scores; a learned sigmoid gate fuses the two.  Trained end to end with
next-item CE.  Parameters are a dict ``{"lm", "cf_user", "cf_item",
"fusion_gate"}``, keyed like the JAX pytree; the CF tables and the gate
are float32 whatever the LM's dtype.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch import convert, resolve_device
from repro_torch.config import ArchConfig
from repro_torch.embeddings import (EmbedPlan, EmbedSpec, dedup_lookup,
                                    init_table, make_plan)
from repro_torch.embeddings.lookup import tp_embed_lookup, tp_embed_rows
from repro_torch.models import layers, transformer as tf
from repro_torch.models.transformer import ModelCtx


def embed_specs(cfg: ArchConfig, n_users: int, cf_dim: int = 64
                ) -> Dict[str, EmbedSpec]:
    """The model's embedding tables, as subsystem specs."""
    return {
        "cf_user": EmbedSpec("cf_user", rows=n_users, dim=cf_dim),
        "cf_item": EmbedSpec("cf_item", rows=cfg.padded_vocab, dim=cf_dim),
    }


def embed_id_fns() -> Dict[str, Callable[[Dict], torch.Tensor]]:
    """Which batch field indexes each sparse-synced table (for
    ``runtime.trainer.EmbedSyncConfig``).  ``cf_item`` is scored densely
    against every user (``u @ cf_item.T``), so only ``cf_user`` has a
    sparse gradient."""
    return {"cf_user": lambda batch: batch["user"]}


def embed_plans(kind: str = "row", row_axis: str = "model",
                col_axis: str = "data") -> Dict[str, EmbedPlan]:
    """The :class:`~repro_torch.embeddings.EmbedPlan` placement of the CF
    tables under the hybrid mesh: pass to ``auto_plan(...,
    embed_plans=...)`` / ``ShardingPlan.embed_plans`` so the train step
    places and looks up the tables by it (row-sharded vocab by default;
    a table that does not divide falls back to replication through the
    plan's guard)."""
    plan = make_plan(kind, row_axis=row_axis, col_axis=col_axis)
    return {"cf_user": plan, "cf_item": plan}


def init_recllm(cfg: ArchConfig, n_users: int, generator: torch.Generator,
                device=None, cf_dim: int = 64) -> Dict:
    """Fresh RecLLM parameters from ``generator``: the LM as
    :func:`repro_torch.convert.init_params` draws it, then the CF tables
    (normal * 0.02, float32) and a zero fusion gate, with the JAX init's
    shapes and scales (not its draws)."""
    dev = resolve_device(device)
    specs = embed_specs(cfg, n_users, cf_dim)
    return {
        "lm": convert.init_params(cfg, generator, dev),
        "cf_user": init_table(generator, specs["cf_user"], dev),
        "cf_item": init_table(generator, specs["cf_item"], dev),
        "fusion_gate": torch.zeros((), dtype=torch.float32, device=dev),
    }


def fuse(lm_logits, cf_scores, fusion_gate):
    """The cross-modal fusion gate (Fig. 1): LM logits plus sigmoid-gated
    CF scores, in float32."""
    return lm_logits.float() + torch.sigmoid(fusion_gate) * cf_scores


def rec_logits(cfg: ArchConfig, params: Dict, batch: Dict,
               ctx: ModelCtx = ModelCtx()):
    """LM logits fused with CF scores.  batch: tokens (B, S), user (B,).
    Under ``ctx.tp`` the logits are this rank's vocab columns and the CF
    tables are used on that shard: a replicated table through the identity
    whose gradient is summed over ``model``; a table under an embed plan
    through the sharded lookup (``cf_user``) and as its rows of this
    rank's vocab shard (``cf_item``: a ``row`` shard is exactly them, so
    the CF scores land vocab-sharded beside the LM logits; ``col`` shards
    are gathered over ``data``)."""
    lm_logits, aux, _ = tf.forward(cfg, params["lm"], batch, ctx)
    cf_item, gate = params["cf_item"], params["fusion_gate"]
    if ctx.tp is not None:
        u = tp_embed_lookup(ctx.tp, "cf_user", params["cf_user"],
                            batch["user"])
        cf_item = tp_embed_rows(ctx.tp, "cf_item", cf_item)
        gate = ctx.tp.copy(gate)
    else:
        u = dedup_lookup(params["cf_user"], batch["user"])   # (B, dc)
    cf = u @ cf_item.T                                   # (B, V)
    return fuse(lm_logits, cf[:, None, :], gate), aux


def recllm_loss(cfg: ArchConfig, params: Dict, batch: Dict,
                ctx: ModelCtx = ModelCtx()) -> Tuple[torch.Tensor, Dict]:
    logits, _ = rec_logits(cfg, params, batch, ctx)
    loss = layers.cross_entropy_loss(logits, batch["targets"],
                                     batch.get("mask"), tp=ctx.tp)
    return loss, {"ce": loss}


def score_users(cfg: ArchConfig, params: Dict, tokens, users, lens,
                ctx: ModelCtx = ModelCtx()):
    """Scores for ranking: the fused logits at each user's last history
    position, (B, V).  ``lens`` is clamped to the last position, so a
    full-window history (``lens == S``) reads the last token's logits, as
    JAX's gather clamps."""
    logits, _ = rec_logits(cfg, params, {"tokens": tokens, "user": users},
                           ctx)
    B, S = tokens.shape
    pos = torch.clamp(lens.long(), max=S - 1)
    return logits[torch.arange(B, device=logits.device), pos]
