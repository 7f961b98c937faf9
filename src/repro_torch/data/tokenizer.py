"""Toy deterministic hash tokenizer for synthetic item text (a copy of
``repro/data/tokenizer.py``).

Real deployments plug a sentencepiece model in here; the framework only
requires ``encode -> List[int] < vocab``.
"""
from __future__ import annotations

import hashlib
from typing import List


class HashTokenizer:
    def __init__(self, vocab_size: int, reserved: int = 4):
        self.vocab_size = vocab_size
        self.reserved = reserved          # 0=pad, 1=bos, 2=eos, 3=unk

    def _tok(self, word: str) -> int:
        h = int(hashlib.md5(word.encode()).hexdigest()[:8], 16)
        return self.reserved + h % (self.vocab_size - self.reserved)

    def encode(self, text: str, max_len: int = 0) -> List[int]:
        ids = [1] + [self._tok(w) for w in text.lower().split()] + [2]
        if max_len:
            ids = ids[:max_len] + [0] * max(0, max_len - len(ids))
        return ids

    @property
    def pad_id(self) -> int:
        return 0
