"""The one generator of every traffic mix: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and makes its inputs from the run's seed.

Serving mixes replay a trace of model calls (the file the mix names under
``calls``, one JSON line for each distinct call: its operator, its prompt,
the tokens it generates, how often it was made; ``bench/record_calls.py``
records the system's own). The calls, each as often as it was made, are
dealt into a fixed order (the same for every seed, so that any stretch of
it samples the whole trace), cut into blocks of ``block``; the seed orders
each block. So any run of whole blocks, as a window serves them, holds the
same work whatever the seed: seeds change the order.

Training mixes: each step's (batch, seq) tokens are uniform over the
vocabulary, drawn on the device from the seed and the step, so every step's
rows differ.
"""
from __future__ import annotations

import dataclasses
import random

import torch

from bench import weights

BATCH_STREAM = 0xBA7C
TRACE_ORDER = 0x7ACE


@dataclasses.dataclass
class Request:
    prompt: str
    max_new_tokens: int
    op: str


def trace_calls(mix: dict) -> list:
    """Every call of the mix's trace, as often as it was made, in the fixed
    order, cut to whole blocks."""
    calls = [Request(c["prompt"], c["new_tokens"], c["op"])
             for c in mix["calls"] for _ in range(c["count"])]
    random.Random(TRACE_ORDER).shuffle(calls)
    return calls[:len(calls) - len(calls) % mix["block"]]


def serve_requests(mix: dict, seed: int) -> list:
    """The mix's pool of requests, each block ordered by the seed."""
    calls, n = trace_calls(mix), mix["block"]
    rng = random.Random(int(seed))
    out = []
    for i in range(0, len(calls), n):
        block = calls[i:i + n]
        rng.shuffle(block)
        out += block
    return out


def warmup_lengths(mix: dict, align: int) -> list:
    """Every padded prompt length the mix's pool reaches, in byte tokens
    with the BOS token."""
    lengths = {len(r.prompt.encode("utf-8")) + 1 for r in trace_calls(mix)}
    return sorted({-(-n // align) * align for n in lengths})


def train_tokens(mix: dict, vocab: int, seed: int, step: int, device):
    """Step ``step``'s (batch, seq) int64 tokens, uniform over the
    vocabulary."""
    g = weights.generator(seed, BATCH_STREAM + 7919 * step, device)
    return torch.randint(0, vocab, (mix["batch"], mix["seq"]), generator=g,
                         device=device)
