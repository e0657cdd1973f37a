"""Byte-level tokenizer with trailing special tokens.

Vocabulary layout matches ModelConfig's convention: the last two ids are
[EOS] (vocab-2) and [MASK] (vocab-1); [PAD] sits at vocab-3. Plain bytes
occupy [0, 256).
"""
from __future__ import annotations

from typing import List

import numpy as np


class ByteTokenizer:
    def __init__(self, vocab_size: int = 320):
        assert vocab_size >= 259
        self.vocab_size = vocab_size
        self.pad_id = vocab_size - 3
        self.eos_id = vocab_size - 2
        self.mask_id = vocab_size - 1

    def encode(self, text: str, add_eos: bool = False) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if add_eos:
            ids.append(self.eos_id)
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        out: List[int] = []
        for i in np.asarray(ids).tolist():
            if i == self.eos_id:
                break
            if i < 256:
                out.append(i)
        return bytes(out).decode("utf-8", errors="replace")
