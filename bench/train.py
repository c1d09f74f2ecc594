"""Training cells: the step ``launch.train.run`` builds (``make_train_step``:
the loss's gradient by autograd with each layer recomputed, then AdamW),
with no checkpoint, on one state built once from the seed's weights.

Set-up drives that state through its first steps with the window's own
step and feed (they are also the warm-up: every shape the window runs) and
keeps what the comparison needs: each step's loss, the first gradient's
leaf norms as the optimizer took it, each leaf's change over those steps.
The window then runs steps until ``seconds`` have passed and waits for the
last to end.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from bench import check, faults, program, trafficgen, weights

# the host spans the window records, read by the traced run's breakdown
SPANS = ("train.feed", "train.step")


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def release(device) -> None:
    gc.collect()
    if _cuda(device):
        torch.cuda.empty_cache()


class Trainer:
    def __init__(self, cell: dict, device):
        self.cfg = cell["config"]
        self.mix = dict(cell["traffic"], dtype=self.cfg["train_dtype"])
        self.device = device
        self.bundle = program.build(self.cfg)
        self.shapes = program.param_shapes(self.bundle)

    def feed(self, seed: int, i: int) -> dict:
        return {"tokens": trafficgen.train_tokens(
            self.mix, self.cfg["vocab_size"], seed, i, self.device)}

    def first_steps(self, seed: int, wrap_step=None, tracer=None):
        """(state, step, the numbers compared): the state built from the
        seed's weights, driven through the mix's first steps.
        ``wrap_step``: a function of the step returning the step run in
        its place (faults are planted with it)."""
        state = program.train_state(program.nest(
            weights.make(self.shapes, self.cfg["init"], seed, self.device)))
        step = program.train_step(self.bundle, self.mix)
        if wrap_step is not None:
            step = wrap_step(step)
        if tracer is not None:
            tracer.mark("weights made, state built")
        losses = []
        for i in range(self.mix["first_steps"]):
            state, m = step(state, self.feed(seed, i))
            losses.append(float(m["loss"]))
            if i == 0:
                first = check.first_moment_grads(
                    program.flatten(state["opt"]["m"]),
                    self.mix["optimizer"]["b1"])
                grad = check.norms(first)
                sample = check.grad_sample(first, seed, self.device)
                del first
        if tracer is not None:
            tracer.mark("first steps")
        change = check.change_norms(program.flatten(state["params"]),
                                    self.cfg, seed, self.device)
        return state, step, {"losses": losses, "grad": grad,
                             "sample": sample, "change": change}

    def reference(self, seed: int, prec: str = "fp32") -> dict:
        return check.train_reference(self.cfg, self.mix, seed, self.device,
                                     self.shapes, prec)


def run(cell: dict, seed: int, seconds: float, tracer, device,
        plant=None) -> dict:
    """``plant``: a function of the step returning the step run in its
    place (the tests plant faults with it)."""
    tr = Trainer(cell, device)
    tracer.mark("program built")
    mix = tr.mix
    state, step, prog = tr.first_steps(seed, plant, tracer)
    n, window_losses = mix["first_steps"], []
    counts0 = program.launch_counts()
    with tracer.window():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with tracer.span("train.feed"):
                batch = tr.feed(seed, n)
            with tracer.span("train.step"):
                state, m = step(state, batch)
            window_losses.append(m["loss"])
            n += 1
        if _cuda(device):
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
    counts = {k: v - counts0.get(k, 0)
              for k, v in program.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(device) if _cuda(device) else 0
    steps = len(window_losses)
    failed = sum(not math.isfinite(x)
                 for x in torch.stack(window_losses).tolist())
    window = t1 - t0
    out = {
        "window_start": t0, "window_s": window, "attempted": steps,
        "failed": failed,
        "metrics": {"train_tok_s": steps * mix["batch"] * mix["seq"]
                    / window},
        "peak": peak, "launches": counts,
        "layer": {"kind": "train", "cfg": tr.cfg, "mix": mix, "steps": steps,
                  "window_s": window, "launches": counts},
    }
    del state, step, m, batch, window_losses
    release(device)
    out["numbers"] = check.train_numbers(prog, tr.reference(seed))
    return out


def readings(cell: dict, seeds: list, controls: int, seconds: float,
             device):
    """For ``bench/calibrate.py``: each seed's first steps, the program's
    numbers and each leaf's ``grad_err``; for the first ``controls`` seeds
    also the control's (the reference in the precision below the
    configuration's put in the program's place) and half the batch's.
    ``seconds``: unused, training's readings need no window."""
    tr = Trainer(cell, device)
    for n, seed in enumerate(seeds):
        state, step, prog = tr.first_steps(seed)
        del state, step
        release(device)
        truth = tr.reference(seed)
        leaves = {"program": check.leaf_differences(prog["sample"],
                                                    truth["sample"])}
        line = {"seed": seed, "program": check.train_numbers(prog, truth),
                "losses": prog["losses"], "ref_losses": truth["losses"]}
        if n < controls:
            ctrl = tr.reference(seed, check.CONTROL[tr.cfg["train_dtype"]])
            line["control"] = check.train_numbers(ctrl, truth)
            state, step, half = tr.first_steps(seed, faults.half_batch)
            del state, step
            release(device)
            line["fault_half_batch"] = check.train_numbers(half, truth)
            for name, got in (("control", ctrl), ("fault_half_batch", half)):
                leaves[name] = check.leaf_differences(got["sample"],
                                                      truth["sample"])
        line["grad_err_by_leaf"] = leaves
        release(device)
        yield line
