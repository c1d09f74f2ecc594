"""Faults planted under the timed path, for the tests and the readings that
set each limit's upper end (``bench/calibrate.py``): a fault has to make
``correct`` come out false."""
from __future__ import annotations

import random

import torch

from bench import check


def half_batch(step):
    """The step on half of each batch, the loss's mean over the rest: half
    its rows, or of a single row half its tokens."""
    def broken(state, batch):
        t = batch["tokens"]
        t = t[:t.shape[0] // 2] if t.shape[0] > 1 else t[:, :t.shape[1] // 2]
        return step(state, dict(batch, tokens=t))
    return broken


def unchanged_state(step):
    """The step returns the state it was given."""
    def broken(state, batch):
        _, metrics = step(state, batch)
        return state, metrics
    return broken


def alter_tokens(recorder, every: int = 2):
    """Makes the engine produce, once for every ``every``-th watched
    request, a token drawn at random in place of its argmax: the logit row
    the engine reads is changed after the recorder kept the true one."""
    inner = recorder.decode_step
    done = set()

    def decode_step(params, cache, token, **kw):
        logits, cache = inner(params, cache, token, **kw)
        eng = recorder.engine
        for i, req in enumerate(eng.slot_req):
            if (req is not None and eng.active[i]
                    and req.rid in recorder.watched
                    and req.rid % every == 0 and req.rid not in done):
                done.add(req.rid)
                logits[i, -1, random.Random(req.rid).randrange(
                    logits.shape[-1])] += 1e4
        return logits, cache
    recorder.decode_step = decode_step


@torch.no_grad()
def altered_token_gap(w, cfg, sample, align, device, seed) -> float:
    """The served gap a token altered where it is produced would read,
    planted in the reference put in the program's place: at one position
    of each sampled request, chosen by the seed, a token drawn at random;
    the least such gap over the sample."""
    rng = random.Random(int(seed))
    least = float("inf")
    for r in sample:
        truth = check.reference_rows(w, cfg, r.prompt_ids, r.output_ids,
                                     align, "fp32", device)
        j = rng.randrange(truth.shape[0])
        t = rng.randrange(truth.shape[1])
        least = min(least, float(truth[j].max() - truth[j, t]))
    return least
