"""Byte-level tokenizer (vocab 256 bytes + specials), a copy of
``repro.data.tokenizer``. Dependency-free and loss-free over arbitrary
text."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

PAD, BOS, EOS = 256, 257, 258
VOCAB = 259


class ByteTokenizer:
    vocab_size = VOCAB
    pad_id, bos_id, eos_id = PAD, BOS, EOS

    def encode(self, text: str, *, bos: bool = True,
               eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        by = bytes(i for i in ids if 0 <= i < 256)
        return by.decode("utf-8", errors="replace")

    def pad_batch(self, seqs: Sequence[Sequence[int]], length: int = 0,
                  align: int = 1) -> np.ndarray:
        """Right-pad to a common length (rounded up to `align`)."""
        n = max(len(s) for s in seqs) if not length else length
        n = -(-n // align) * align
        out = np.full((len(seqs), n), PAD, np.int32)
        for i, s in enumerate(seqs):
            out[i, :min(len(s), n)] = s[:n]
        return out
