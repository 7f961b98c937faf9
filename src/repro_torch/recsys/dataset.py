"""Synthetic Amazon-Electronics-like recommendation dataset (paper Table 1);
a numpy copy of ``repro/recsys/dataset.py``: the same seed gives the same
arrays.

The real dataset is not available offline; this generator reproduces its
*statistics* at a configurable scale: 192,403 users, 63,001 items, ~2M
interactions, zipf item popularity, log-normal user activity, and a
chronological 80/10/10 split.  Sequences are per-user item histories for
next-item prediction (the standard LLM-recsys formulation, Fig. 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

FULL_USERS = 192_403
FULL_ITEMS = 63_001
FULL_INTERACTIONS = 1_735_654 + 216_957 + 216_956   # paper Table 1


@dataclasses.dataclass(frozen=True)
class RecDataset:
    n_users: int
    n_items: int
    # (N,) arrays sorted chronologically
    user: np.ndarray
    item: np.ndarray
    time: np.ndarray
    split: Tuple[int, int]          # train/val boundary indices

    @property
    def train(self):
        return self.user[:self.split[0]], self.item[:self.split[0]]

    @property
    def val(self):
        s = slice(self.split[0], self.split[1])
        return self.user[s], self.item[s]

    @property
    def test(self):
        return self.user[self.split[1]:], self.item[self.split[1]:]


def generate(scale: float = 0.02, seed: int = 0) -> RecDataset:
    """scale=1.0 reproduces the full Table 1 sizes."""
    rng = np.random.default_rng(seed)
    n_users = max(32, int(FULL_USERS * scale))
    n_items = max(64, int(FULL_ITEMS * scale))
    n_inter = max(1024, int(FULL_INTERACTIONS * scale))

    # item popularity: zipf; user activity: log-normal
    item_pop = 1.0 / np.arange(1, n_items + 1) ** 1.1
    item_pop /= item_pop.sum()
    user_act = rng.lognormal(0.0, 1.0, n_users)
    user_act /= user_act.sum()

    users = rng.choice(n_users, n_inter, p=user_act)
    # per-user taste cluster: users prefer a popularity-biased item window
    centers = rng.integers(0, n_items, n_users)
    window = max(16, n_items // 20)
    base_items = rng.choice(n_items, n_inter, p=item_pop)
    offset = rng.integers(-window, window + 1, n_inter)
    clustered = (centers[users] + offset) % n_items
    use_cluster = rng.random(n_inter) < 0.6
    items = np.where(use_cluster, clustered, base_items).astype(np.int64)

    times = np.sort(rng.integers(0, 2 ** 31, n_inter))
    order = np.arange(n_inter)                   # already time-sorted
    b1 = int(n_inter * 0.8)
    b2 = int(n_inter * 0.9)
    return RecDataset(n_users=n_users, n_items=n_items,
                      user=users[order], item=items[order],
                      time=times[order], split=(b1, b2))


def user_histories(ds: RecDataset, part: str = "train") -> Dict[int, np.ndarray]:
    u, i = getattr(ds, part)
    hist: Dict[int, list] = {}
    for uu, ii in zip(u, i):
        hist.setdefault(int(uu), []).append(int(ii))
    return {k: np.asarray(v, np.int64) for k, v in hist.items()}


def seq_batches(ds: RecDataset, batch: int, seq_len: int, steps: int,
                seed: int = 0, part: str = "train",
                item_offset: int = 3) -> Iterator[Dict[str, np.ndarray]]:
    """Next-item prediction batches.  Token ids = item id + offset
    (0=pad, 1=bos, 2=mask reserved).  targets[t] = tokens[t+1]."""
    hist = user_histories(ds, part)
    users = [u for u, h in hist.items() if len(h) >= 3]
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        tok = np.zeros((batch, seq_len + 1), np.int64)
        for b in range(batch):
            h = hist[users[rng.integers(len(users))]]
            take = h[-(seq_len):] if len(h) >= seq_len else h
            tok[b, 0] = 1                               # bos
            tok[b, 1:1 + len(take)] = take + item_offset
        yield {"tokens": tok[:, :-1].astype(np.int32),
               "targets": tok[:, 1:].astype(np.int32),
               "mask": (tok[:, 1:] > 0).astype(np.float32),
               "user": np.zeros((batch,), np.int32)}


def eval_examples(ds: RecDataset, seq_len: int, max_users: int = 512,
                  item_offset: int = 3, part: str = "test"):
    """Leave-one-out eval: history (from train) -> held-out item (from part).

    Returns (tokens (U, seq), gold (U,)) for HR@K / NDCG@K ranking."""
    train_hist = user_histories(ds, "train")
    u_eval, i_eval = getattr(ds, part)
    seen = set()
    toks, gold, lens = [], [], []
    for uu, ii in zip(u_eval, i_eval):
        uu = int(uu)
        if uu in seen or uu not in train_hist:
            continue
        seen.add(uu)
        h = train_hist[uu][-(seq_len - 1):]
        row = np.zeros(seq_len, np.int64)
        row[0] = 1
        row[1:1 + len(h)] = h + item_offset
        toks.append(row)
        gold.append(int(ii) + item_offset)
        lens.append(len(h))                     # last filled position
        if len(toks) >= max_users:
            break
    return (np.stack(toks).astype(np.int32),
            np.asarray(gold, np.int32),
            np.asarray(lens, np.int32))
