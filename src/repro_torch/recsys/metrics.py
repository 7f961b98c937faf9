"""Recommendation quality metrics: HR@K and NDCG@K (paper §IV.B); port of
``repro/recsys/metrics.py``."""
from __future__ import annotations

import numpy as np
import torch


def hr_ndcg_at_k(scores: torch.Tensor, gold: torch.Tensor, k: int = 10,
                 exclude: torch.Tensor = None):
    """scores (U, V) full-ranking scores; gold (U,) gold item ids; exclude
    an optional (U, V) bool of items removed from the ranking (the user's
    own history, leave-one-out).  Returns (hr@k, ndcg@k) 0-d tensors."""
    s = scores.float()
    gold = gold.long()
    if exclude is not None:
        gold_onehot = torch.zeros_like(exclude)
        gold_onehot.scatter_(-1, gold[:, None], True)
        s = torch.where(exclude & ~gold_onehot,
                        torch.full_like(s, -float("inf")), s)
    gold_score = torch.gather(s, -1, gold[:, None])
    # rank = number of items scoring strictly higher than gold
    rank = torch.sum(s > gold_score, dim=-1)
    hit = rank < k
    hr = torch.mean(hit.float())
    ndcg = torch.mean(torch.where(hit, 1.0 / torch.log2(rank + 2.0),
                                  torch.zeros_like(s[:, 0])))
    return hr, ndcg


def history_exclusion(tokens: np.ndarray, n_vocab: int) -> np.ndarray:
    """(U, S) history tokens -> (U, V) bool mask of seen items (+specials)."""
    U = tokens.shape[0]
    mask = np.zeros((U, n_vocab), bool)
    for u in range(U):
        mask[u, tokens[u]] = True
    mask[:, :3] = True                         # pad/bos/mask tokens
    return mask
