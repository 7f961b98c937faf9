"""Host-side data: synthetic batch sources, device placement, the
prefetcher and the hash tokenizer."""
from repro_torch.data.pipeline import (Prefetcher, place_batch,
                                       synthetic_lm_batches)
from repro_torch.data.tokenizer import HashTokenizer

__all__ = ["synthetic_lm_batches", "place_batch", "Prefetcher",
           "HashTokenizer"]
