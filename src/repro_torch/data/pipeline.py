"""Synthetic LM batches (a numpy copy of ``repro/data/pipeline.py``'s
``synthetic_lm_batches``): the training launcher's data.  The JAX
module's device placement and prefetcher are not needed: the hybrid step
takes the global batch and cuts its own rows."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_lm_batches(vocab: int, batch: int, seq: int, steps: int,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic LM stream (zipf-ish token distribution)."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        ranks = rng.zipf(1.3, size=(batch, seq + 1))
        tokens = np.minimum(ranks - 1, vocab - 1).astype(np.int32)
        yield {"tokens": tokens[:, :-1],
               "targets": tokens[:, 1:],
               "mask": np.ones((batch, seq), np.float32)}
