"""How ``correct`` is decided: what the timed path produced, held against
the plain reference of the configuration's architecture
(``bench/reference/<reference>.py``, ``spec.reference``) at the timed
sizes.

Serving: for a seeded sample of the requests finished in the window, the
program's logit rows (recorded as the engine produced them: the prefill's
last padded row, then each tick's row of the request's slot) against the
reference's fp32 forward over the prompt padded as the engine pads it (the
first token) and over the prompt and the served tokens (the rest):
``logit_err`` is the largest |program - reference| of any logit, and
``served_gap`` the largest gap by which a served token's reference logit
lies below the reference's best at its position.

Training: the first three steps, which set-up drives through the window's
own step and feed. ``loss_gap``: the largest relative gap of a step's loss.
``grad_gap``: of each leaf, the gap between the norms of the first
gradient as the optimizer takes it (clipped; the program's worked out from
its first moment after one step, m / (1 - b1)), over the larger of the
reference leaf's norm and the median leaf's; the worst leaf. ``change_gap``:
the same of each leaf's change over the three steps, leaving out leaves
whose reference gradient is under a thousandth of the median leaf's (they
move by AdamW's rounding alone). ``grad_err``: of each leaf, the norm of
the difference of that first gradient at up to 65,536 elements the seed
draws, over the larger of the reference's norm there and the median
leaf's; the worst leaf (``grad_err_median``: the median leaf;
``grad_err_head``: the worst of the leaves that follow the stack of layers,
the final norm's scale and an untied unembedding, which every position's
last products reach directly). A gap of norms hardly moves under rounding
that is random from element to element, which the difference shows.
"""
from __future__ import annotations

import math
import random
import statistics

import torch

from bench import spec, trafficgen, weights
from bench.reference import adamw

# the control: the reference in the nearest precision below the one the
# configuration states, put in the program's place
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
# the byte tokenizer's ids and the engine's padding of a prompt: the
# serving contract the reference reproduces
BOS, PAD = 257, 256
SAMPLE, SAMPLE_STREAM = 1 << 16, 0x5A3B


def tokens_of(prompt: str) -> list:
    return [BOS] + list(prompt.encode("utf-8"))


def padded(ids: list, align: int) -> list:
    return ids + [PAD] * (-len(ids) % align)


def pick_sample(done: list, rows: dict, want_tokens: int, seed: int) -> list:
    """Finished requests whose every served token has its recorded row:
    the one with the longest prompt, the one with the most served tokens,
    then others drawn by the seed until ``want_tokens`` served tokens."""
    ok = [r for r in done if len(rows.get(r.rid, ())) == len(r.output_ids)]
    if not ok:
        return []
    chosen = {max(ok, key=lambda r: len(r.prompt_ids)).rid,
              max(ok, key=lambda r: len(r.output_ids)).rid}
    rest = [r for r in ok if r.rid not in chosen]
    random.Random(int(seed)).shuffle(rest)
    out = [r for r in ok if r.rid in chosen]
    for r in rest:
        if sum(len(x.output_ids) for x in out) >= want_tokens:
            break
        out.append(r)
    return out


@torch.no_grad()
def reference_rows(w: dict, cfg: dict, ids: list, out: list, align: int,
                   prec: str, device):
    """The reference's logit rows for each served token: the first from
    the padded prompt's last row, the rest from prompt + served tokens."""
    ref = spec.reference(cfg)
    first = ref.forward(w, cfg, torch.tensor([padded(ids, align)],
                                             device=device), prec)[0, -1:]
    if len(out) == 1:
        return first
    seq = torch.tensor([ids + out[:-1]], device=device)
    rest = ref.forward(w, cfg, seq, prec)[0, len(ids):]
    return torch.cat([first, rest])


def serve_numbers(w, cfg, sample, rows, align, device, prec="fp32"):
    """(logit_err, served_gap) of the program's rows, or with ``prec`` of
    the reference computed in that precision put in the program's place
    (the control: its served tokens are the ones its own logits put
    first)."""
    err = gap = 0.0
    for r in sample:
        if r.prompt_ids != tokens_of(r.prompt)[:len(r.prompt_ids)]:
            raise AssertionError(f"request {r.rid}: the engine's prompt "
                                 f"tokens are not the prompt's bytes")
        truth = reference_rows(w, cfg, r.prompt_ids, r.output_ids, align,
                               "fp32", device)
        if prec == "fp32":
            got = torch.stack(rows[r.rid]).to(device)
            served = torch.tensor(r.output_ids, device=device)
        else:
            got = reference_rows(w, cfg, r.prompt_ids, r.output_ids, align,
                                 prec, device)
            served = got.argmax(-1)
        err = max(err, float((got - truth).abs().max()))
        best = truth.max(-1).values
        gap = max(gap, float((best - truth.gather(
            1, served[:, None])[:, 0]).max()))
    return {"logit_err": err, "served_gap": gap}


def first_moment_grads(opt_state: dict, b1: float) -> dict:
    """The first gradient as the optimizer took it: m / (1 - b1) after one
    step."""
    return {p: m / (1 - b1) for p, m in opt_state.items()}


def grad_sample(grads: dict, seed: int, device) -> dict:
    """Each leaf's gradient at up to ``SAMPLE`` elements drawn by the seed,
    the same elements on both sides."""
    out = {}
    for j, path in enumerate(sorted(grads)):
        g = grads[path].detach().reshape(-1)
        idx = torch.randint(0, g.numel(), (min(SAMPLE, g.numel()),),
                            generator=weights.generator(
                                seed, SAMPLE_STREAM + j, device),
                            device=device)
        out[path] = g[idx].float()
    return out


def norms(tree: dict) -> dict:
    return {p: float(torch.linalg.vector_norm(t.detach().float()))
            for p, t in tree.items()}


def change_norms(params: dict, cfg: dict, seed: int, device) -> dict:
    """Each leaf's change from the seed's initial weights."""
    start = weights.make({p: tuple(t.shape) for p, t in params.items()},
                         cfg["init"], seed, device)
    return {p: float(torch.linalg.vector_norm(params[p].detach().float()
                                              - start[p]))
            for p in params}


def train_reference(cfg: dict, mix: dict, seed: int, device, shapes: dict,
                    prec: str = "fp32") -> dict:
    """The reference's first three steps from the seed's weights and
    batches: each step's loss, the first clipped gradient's leaf norms,
    each leaf's change over the three steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = spec.reference(cfg)
    w = weights.make(shapes, cfg["init"], seed, device)
    for t in w.values():
        t.requires_grad_(True)
    m = {p: torch.zeros_like(t) for p, t in w.items()}
    v = {p: torch.zeros_like(t) for p, t in w.items()}
    names = sorted(w)
    losses, grad = [], None
    for i in range(mix["first_steps"]):
        tokens = trafficgen.train_tokens(mix, cfg["vocab_size"], seed, i,
                                         device)
        loss = ref.loss(w, cfg, tokens, prec, remat=True)
        grads = dict(zip(names, torch.autograd.grad(loss,
                                                    [w[p] for p in names])))
        clipped = adamw.step(mix["optimizer"], w, grads, m, v, i + 1)
        losses.append(float(loss.detach()))
        if i == 0:
            grad = norms(clipped)
            sample = grad_sample(clipped, seed, device)
        del grads, clipped, loss
    return {"losses": losses, "grad": grad, "sample": sample,
            "change": change_norms(w, cfg, seed, device)}


def _worst_leaf(got: dict, want: dict, leaves) -> float:
    floor = statistics.median(want[p] for p in leaves)
    return max(abs(got[p] - want[p]) / max(want[p], floor) for p in leaves)


def leaf_differences(got: dict, want: dict) -> dict:
    """Each leaf's sampled gradient difference, over the larger of the
    reference's norm there and the median leaf's."""
    size = {p: float(torch.linalg.vector_norm(t)) for p, t in want.items()}
    floor = statistics.median(size.values())
    return {p: float(torch.linalg.vector_norm(got[p].to(want[p].device)
                                              - want[p])) / max(size[p], floor)
            for p in want}


# the leaves after the stack of layers, by their top-level names
HEAD_LEAVES = ("final_norm", "unembed")


def train_numbers(prog: dict, truth: dict) -> dict:
    floor = statistics.median(truth["grad"].values())
    moved = [p for p, g in truth["grad"].items() if g >= 1e-3 * floor]
    diff = leaf_differences(prog["sample"], truth["sample"])
    head = [p for p in diff if p.split("/")[0] in HEAD_LEAVES]
    return {"grad_err": max(diff.values()),
            "grad_err_median": statistics.median(diff.values()),
            "grad_err_head": max(diff[p] for p in head),
            "loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(prog["losses"], truth["losses"])),
            "grad_gap": _worst_leaf(prog["grad"], truth["grad"],
                                    list(truth["grad"])),
            "change_gap": _worst_leaf(prog["change"], truth["change"],
                                      moved)}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a missing or non-finite number fails."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
