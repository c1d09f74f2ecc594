"""Sharding-aware training data pipeline.

Deterministic, restart-safe token batches: batch content is a pure function
of (seed, step), and each data-parallel host materializes ONLY its shard —
`global_batch / dp_world` sequences — so input bandwidth scales with the
fleet. A background prefetch thread keeps `prefetch` steps in flight.

Sources:
  * synthetic LM streams (seeded)
  * text corpora via the byte tokenizer (list of documents, packed into
    fixed-length sequences with BOS separators)
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer


class TokenPipeline:
    def __init__(self, *, vocab_size: int, global_batch: int, seq_len: int,
                 dp_rank: int = 0, dp_world: int = 1, seed: int = 0,
                 documents: Optional[Sequence[str]] = None,
                 prefetch: int = 2):
        if global_batch % dp_world:
            raise ValueError(f"global_batch {global_batch} not divisible "
                             f"by dp_world {dp_world}")
        self.vocab_size = vocab_size
        self.global_batch = global_batch
        self.local_batch = global_batch // dp_world
        self.seq_len = seq_len
        self.dp_rank = dp_rank
        self.dp_world = dp_world
        self.seed = seed
        self._packed = self._pack(documents) if documents else None
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self.prefetch = prefetch

    # ------------------------------------------------------------------
    def _pack(self, documents: Sequence[str]) -> np.ndarray:
        """Pack documents into one token stream with BOS separators."""
        tok = ByteTokenizer()
        ids: List[int] = []
        for d in documents:
            ids.extend(tok.encode(d, bos=True, eos=True))
        arr = np.asarray(ids, np.int32) % self.vocab_size
        n = max(1, len(arr) // self.seq_len)
        return arr[: n * self.seq_len].reshape(n, self.seq_len)

    def batch_at(self, step: int) -> dict:
        """The dp-local batch for `step` — pure function of (seed, step,
        dp_rank), which is what makes checkpoint-restart deterministic."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        if self._packed is not None:
            idx = rng.integers(0, self._packed.shape[0],
                               size=self.global_batch)
            lo = self.dp_rank * self.local_batch
            sel = idx[lo: lo + self.local_batch]
            return {"tokens": self._packed[sel]}
        # synthetic: draw the global batch, slice the local shard (ranks
        # agree on the stream; each materializes 1/dp_world of it)
        tokens = rng.integers(
            0, self.vocab_size,
            size=(self.global_batch, self.seq_len), dtype=np.int32)
        lo = self.dp_rank * self.local_batch
        return {"tokens": tokens[lo: lo + self.local_batch]}

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, step: int) -> Iterator[dict]:
        """Prefetching iterator starting at `step` (restart entry point)."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker(start):
            s = start
            while not stop.is_set():
                q.put((s, self.batch_at(s)))
                s += 1

        t = threading.Thread(target=worker, args=(step,), daemon=True)
        t.start()
        try:
            while True:
                _, batch = q.get()
                yield batch
        finally:
            stop.set()
