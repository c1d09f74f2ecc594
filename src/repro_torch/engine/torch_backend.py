"""TorchBackend — a core.Backend whose tier is an actually-served model of
the port, the counterpart of ``repro.engine.jax_backend.JAXBackend``.

Wires the Nirvana executor to the serving engine: each semantic-operator
record becomes a prompt; outputs come from real prefill+decode over a model
from the zoo, on the card through the Hopper attention kernels (full width
or reduced), or on the CPU through their plain versions. Usage is metered
with *measured* wall-clock plus the tier's price card, so end-to-end
examples report true serving latency.

Untrained reduced models emit noise — examples use this backend to
demonstrate the real serving path, optionally composing it with the oracle
("echo" mode) so the analytics answer stays meaningful while latency/cost
numbers are real.

Thread-safety: ``run_values`` may be called from many worker threads at
once (the ``runtime.ThreadPoolDispatcher`` driver). All callers submit into
ONE shared :class:`ContinuousBatcher` and then cooperate on driving it —
each takes the backend lock for a single ``step()`` at a time — so
concurrent operators' requests genuinely share the engine's decode slots
(continuous batching across callers) instead of corrupting the KV cache.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import backends as bk
from repro_torch.core import cost as cost_mod
from repro_torch.core import plan as plan_ir
from repro_torch.engine.engine import ContinuousBatcher, GenerationEngine


def render_prompt(op: plan_ir.Operator, value: Any) -> str:
    head = {plan_ir.FILTER: "Answer true or false.",
            plan_ir.MAP: "Answer concisely.",
            plan_ir.REDUCE: "Aggregate the inputs.",
            plan_ir.RANK: "Score the input 0-9."}[op.kind]
    return f"{head}\nInstruction: {op.instruction}\nInput: {value}\nAnswer:"


@dataclasses.dataclass
class TorchBackend:
    tier: cost_mod.TierSpec
    engine: GenerationEngine
    oracle: Optional[Any] = None      # echo mode: answers from the oracle,
    max_new_tokens: int = 16          # latency/cost from the real engine
    # shared continuous batcher + the lock serializing engine access; every
    # run_values (possibly from many dispatcher threads) submits here
    _lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, init=False, repr=False,
        compare=False)
    _batcher: Optional[ContinuousBatcher] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __getstate__(self):
        # the procs driver ships every backend that pickles to its worker
        # processes; this one holds the engine (weights and cache on the
        # card), so it refuses at once, before anything is serialized, and
        # stays in the process that built it, as JAXBackend does
        raise TypeError("TorchBackend holds the engine and stays in the "
                        "process that built it")

    def _submit(self, prompts: Sequence[str]) -> List[int]:
        with self._lock:
            if self._batcher is None:
                self._batcher = ContinuousBatcher(self.engine)
            return [self._batcher.submit(p,
                                         max_new_tokens=self.max_new_tokens)
                    for p in prompts]

    def _collect(self, rids: Sequence[int]) -> Dict[int, Any]:
        """Drive the shared batcher until this caller's requests finish.

        Concurrent callers cooperate: whoever holds the lock advances the
        engine by one ``step`` (slot refill + one decode tick), then
        releases it so other threads can submit mid-flight — their
        requests join the same slot batch."""
        pending = set(rids)
        out: Dict[int, Any] = {}
        while pending:
            with self._lock:
                for r in list(pending):
                    req = self._batcher.finished.pop(r, None)
                    if req is not None:
                        out[r] = req
                        pending.discard(r)
                if pending:
                    self._batcher.step()
        return out

    def run_values(self, op: plan_ir.Operator, values: Sequence[Any],
                   meter: Optional[bk.UsageMeter] = None,
                   batch_size: int = 1) -> List[Any]:
        t0 = time.perf_counter()
        if op.kind == plan_ir.REDUCE:
            joined = "; ".join(str(v)[:60] for v in list(values)[:32])
            prompts = [render_prompt(op, joined)]
        else:
            prompts = [render_prompt(op, v) for v in values]

        rids = self._submit(prompts)
        finished = self._collect(rids)
        raw = [finished[r].text for r in rids]

        wall = time.perf_counter() - t0  # noqa: F841 — true batch wall
        tok_in = sum(cost_mod.text_tokens(p) for p in prompts)
        tok_out = sum(len(finished[r].output_ids or []) for r in rids)
        if meter is not None:
            # per-call latencies are the *measured* per-request SERVICE
            # times (slot insert -> done) from the continuous batcher; the
            # event scheduler re-queues jobs itself, so sojourn time
            # (submit -> done) would double-count the slot-queue wait
            per_call = [max(0.0, finished[r].done_s
                            - (finished[r].started_s
                               or finished[r].submitted_s))
                        for r in rids]
            meter.record(self.tier.name, bk.Usage(
                calls=len(prompts), tok_in=tok_in, tok_out=tok_out,
                usd=self.tier.usd(tok_in, tok_out),
                latency_s=sum(per_call)),
                per_call_latency_s=per_call, op_kind=op.kind)

        if self.oracle is not None:
            if op.kind == plan_ir.REDUCE:
                return [self.oracle.answer_reduce(op, values)]
            return [self.oracle.answer(op, v) for v in values]
        return self._parse(op, raw, values)

    def _parse(self, op: plan_ir.Operator, raw: List[str],
               values: Sequence[Any]) -> List[Any]:
        if op.kind == plan_ir.FILTER:
            return [r.strip().lower().startswith(("t", "y")) for r in raw]
        if op.kind == plan_ir.RANK:
            out = []
            for r in raw:
                digits = [c for c in r if c.isdigit()]
                out.append(int(digits[0]) if digits else 0)
            return out
        return raw
