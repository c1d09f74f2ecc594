"""Serving cells: the port's ``ContinuousBatcher`` over its
``GenerationEngine``, driven in one thread by a closed loop of callers.

Each caller submits a morsel of requests and, once all of them are done,
the next, as the runtime's dispatcher threads do through ``TorchBackend``;
so ``callers * morsel`` requests are in flight. The window starts from an
empty engine and ends at the first scheduling round that ends after
``seconds``; every round ends at a host read of the sampled tokens, so the
window's time holds all of its work.
"""
from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from bench import check, faults, program, tracing, trafficgen, weights

# the host spans the window records, read by the traced run's breakdown
SPANS = ("serve.insert", "serve.tick")


class Recorder:
    """The model bundle as the engine sees it, keeping a copy of the logit
    row of every token it produces for a watched request, and the padded
    length of every prefill."""

    def __init__(self, bundle, max_rows: int):
        self.bundle, self.max_rows = bundle, max_rows
        self.engine = None
        self.reset()

    def reset(self) -> None:
        self.watched, self.rows, self.reserved = set(), {}, 0
        self.current = None            # the request being inserted
        self.prefill_lens = []

    def __getattr__(self, name):
        return getattr(self.bundle, name)

    def watch(self, rid: int, max_new: int) -> None:
        if self.reserved + max_new <= self.max_rows:
            self.watched.add(rid)
            self.rows[rid] = []
            self.reserved += max_new

    def prefill(self, params, batch, *a, **kw):
        logits, cache = self.bundle.prefill(params, batch, *a, **kw)
        self.prefill_lens.append(batch["tokens"].shape[1])
        if self.current in self.watched:
            self.rows[self.current].append(logits[0, -1].clone())
        return logits, cache

    def decode_step(self, params, cache, token, **kw):
        logits, cache = self.bundle.decode_step(params, cache, token, **kw)
        eng = self.engine
        for i, req in enumerate(eng.slot_req):
            if req is not None and eng.active[i] and req.rid in self.watched:
                self.rows[req.rid].append(logits[i, -1].clone())
        return logits, cache


class Server:
    """The engine of a serving cell, built once; ``load`` gives it a
    seed's weights."""

    def __init__(self, cell: dict, device):
        self.cfg = cell["config"]
        self.mix = dict(cell["traffic"], dtype=self.cfg["serve_dtype"])
        self.device = device
        bundle = program.build(self.cfg)
        self.shapes = program.param_shapes(bundle)
        self.rec = Recorder(bundle, self.mix["check"]["max_rows"])
        self.eng = None
        self.w = None

    def load(self, seed: int, tracer=None) -> None:
        """The seed's weights; the first call builds the engine and warms
        up every padded prompt length the mix reaches, and a tick."""
        self.w = None
        self.w = weights.make(self.shapes, self.cfg["init"], seed,
                              self.device)
        params = program.nest(self.w)
        if self.eng is not None:
            self.eng.params = params
            return
        self.eng = program.engine(self.rec, params, self.mix, self.device)
        self.rec.engine = self.eng
        if tracer is not None:
            tracer.mark("weights made, engine built")
        for n in trafficgen.warmup_lengths(self.mix, program.prefill_align()):
            self.eng.insert(program.request(
                "a" * (min(n, self.mix["max_len"] - 1) - 1), 2), 0)
        self.eng.decode_tick()
        if tracer is not None:
            tracer.mark("warmed up")

    def window(self, seed: int, seconds: float, tracer) -> dict:
        """One window from an empty engine; the result's numbers, and the
        seeded sample of finished requests for the comparison."""
        eng, rec, mix = self.eng, self.rec, self.mix
        eng.active[:] = False
        eng.slot_req = [None] * eng.n_slots
        for k in eng.stats:
            eng.stats[k] = type(eng.stats[k])(0)
        rec.reset()
        pool = trafficgen.serve_requests(mix, seed)
        watch_rng = random.Random(int(seed) ^ 0x3A7C)
        batcher = program.batcher(eng)
        insert, tick = eng.insert, eng.decode_tick
        tick_lens = []

        def spanned_insert(req, slot):
            rec.current = req.rid
            with tracer.span("serve.insert"):
                return insert(req, slot)

        def spanned_tick(*a):
            if tracer.enabled:
                # each slot's valid cache rows after this tick's write; 0
                # for a parked slot (its kernel reads one row)
                tick_lens.append([len(r.prompt_ids) + len(r.output_ids)
                                  if r is not None and eng.active[i] else 0
                                  for i, r in enumerate(eng.slot_req)])
            with tracer.span("serve.tick"):
                return tick(*a)
        eng.insert, eng.decode_tick = spanned_insert, spanned_tick

        reqs, owner, outstanding = {}, {}, [0] * mix["callers"]
        cursor = 0

        def submit_morsel(caller: int) -> None:
            nonlocal cursor
            for _ in range(mix["morsel"]):
                r = pool[cursor % len(pool)]
                cursor += 1
                rid = batcher.submit(r.prompt, r.max_new_tokens)
                reqs[rid] = batcher.queue[-1]
                owner[rid] = caller
                outstanding[caller] += 1
                if watch_rng.random() * mix["check"]["every"] < 1:
                    rec.watch(rid, r.max_new_tokens)

        done = []
        counts0 = program.launch_counts()
        try:
            with tracer.window():
                t0 = time.perf_counter()
                for c in range(mix["callers"]):
                    submit_morsel(c)
                while time.perf_counter() - t0 < seconds:
                    batcher.step()
                    for rid in list(batcher.finished):
                        done.append(batcher.finished.pop(rid))
                        c = owner[rid]
                        outstanding[c] -= 1
                        if outstanding[c] == 0:
                            submit_morsel(c)
                t1 = time.perf_counter()
        finally:
            eng.insert, eng.decode_tick = insert, tick
        counts = {k: v - counts0.get(k, 0)
                  for k, v in program.launch_counts().items()}
        window = t1 - t0
        prompt_tok = sum(len(r.prompt_ids) for r in reqs.values()
                         if r.prompt_ids is not None)
        gen_tok = sum(len(r.output_ids) for r in reqs.values()
                      if r.output_ids is not None)
        lat = [r.done_s - r.submitted_s for r in done]
        sample = check.pick_sample(done, rec.rows, mix["check"]["tokens"],
                                   seed)
        return {
            "window_start": t0, "window_s": window, "attempted": len(reqs),
            "failed": 0,
            "metrics": {"serve_tok_s": (prompt_tok + gen_tok) / window,
                        "request_p95_s": float(np.percentile(lat, 95))},
            "launches": counts,
            "layer": {"kind": "serve", "cfg": self.cfg, "mix": mix,
                      "stats": dict(eng.stats), "prompt_tokens": prompt_tok,
                      "generated_tokens": gen_tok, "completed": len(done),
                      "prefill_lens": list(rec.prefill_lens),
                      "tick_lens": tick_lens, "window_s": window,
                      "launches": counts},
            "sample": sample,
            "rows": {r.rid: rec.rows[r.rid] for r in sample},
        }

    def release(self) -> None:
        """Frees the engine (its cache); the weights stay for the
        reference."""
        self.eng = self.rec.engine = None
        self.rec.reset()
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, out: dict, prec: str = "fp32") -> dict:
        if not out["sample"]:
            return {}
        return check.serve_numbers(self.w, self.cfg, out["sample"],
                                   out["rows"], program.prefill_align(),
                                   self.device, prec)


def run(cell: dict, seed: int, seconds: float, tracer, device,
        plant=None) -> dict:
    """``plant``: a function of the server, called before the window (the
    tests plant faults with it)."""
    server = Server(cell, device)
    tracer.mark("program built")
    server.load(seed, tracer)
    if plant is not None:
        plant(server)
    out = server.window(seed, seconds, tracer)
    out["peak"] = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    server.release()
    out["numbers"] = server.numbers(out)
    out["sampled"] = {"requests": len(out["sample"]),
                      "tokens": sum(len(r.output_ids)
                                    for r in out["sample"])}
    return out


def readings(cell: dict, seeds: list, controls: int, seconds: float,
             device):
    """For ``bench/calibrate.py``: each seed's window of ``seconds`` on one
    engine, the program's numbers; for the first ``controls`` seeds also
    the control's (the reference in the precision below the configuration's
    put in the program's place) and a token altered where it is produced."""
    server = Server(cell, device)
    for n, seed in enumerate(seeds):
        server.load(seed)
        out = server.window(seed, seconds, tracing.Tracer(False))
        line = {"seed": seed, "program": server.numbers(out),
                "metrics": out["metrics"],
                "sampled": [len(out["sample"]),
                            sum(len(r.output_ids) for r in out["sample"])]}
        if n < controls:
            line["control"] = server.numbers(
                out, check.CONTROL[server.cfg["serve_dtype"]])
            line["fault_altered_token"] = {
                "served_gap": faults.altered_token_gap(
                    server.w, server.cfg, out["sample"],
                    program.prefill_align(), device, seed)}
        yield line
