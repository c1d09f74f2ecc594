"""Backend model tiers: the execution engines physical plans assign to
operators (paper §4's M = {m1, m2, m3, m*}).

Two implementations of the :class:`Backend` protocol:

* :class:`SimulatedBackend` — the calibrated **capability simulator**. Each
  tier answers an operator on a record correctly iff the record's hidden
  difficulty draw falls below the tier's capability; difficulty draws are
  shared across tiers, so correctness sets are *nested* (Hypothesis 2 holds
  exactly) except on records flagged as violations at rate
  ``violation_rate`` — where a stronger tier fails a record a weaker tier
  gets right, reproducing Table-2-style statistics. Wrong answers follow
  the paper's Figure-5 **binary response model** by default (one canonical
  wrong answer per (op, record)); ``diverse_wrong=True`` makes wrong answers
  tier-specific, deliberately breaking that assumption for robustness tests.

* ``TorchBackend`` lives in ``repro_torch.engine.torch_backend`` — it serves
  a real model from the zoo through the prefill/decode engine; tiers map
  to architectures per ``cost.DEFAULT_TIERS``.

All backends report token/price/latency usage so optimizer overhead
accounting (Tables 6 & 9) includes *everything the optimizer spends*.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from typing import Any, Dict, List, Optional, Protocol, Sequence

from repro_torch.core import cost as cost_mod
from repro_torch.core import plan as plan_ir


# ---------------------------------------------------------------------------
# Usage accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Usage:
    calls: int = 0
    tok_in: float = 0.0
    tok_out: float = 0.0
    usd: float = 0.0
    latency_s: float = 0.0     # sum of per-call latencies (sequential time)

    def add(self, other: "Usage"):
        self.calls += other.calls
        self.tok_in += other.tok_in
        self.tok_out += other.tok_out
        self.usd += other.usd
        self.latency_s += other.latency_s


class UsageMeter:
    """Per-tier usage accumulator; threaded through optimizers/executors so
    every experiment can report calls/usd/latency per model (Fig. 10).

    Besides the per-tier totals, the meter keeps ``call_log`` — one
    ``(tier, latency_s)`` entry per LLM call, in issue order. The
    event-driven scheduler (``runtime.EventScheduler``) consumes this log
    to place each call on a simulated worker, so wall-clock accounting is
    per-call rather than per-operator-wave. Backends that know their true
    per-call latencies pass them explicitly; otherwise the aggregate
    latency is split uniformly across the calls.

    ``record`` is lock-protected: under the threaded execution driver
    (``runtime.ThreadPoolDispatcher``) concurrent backend calls bill into
    one shared meter, and totals must match the sequential driver's.

    Calls can carry an optional **logical key** — a tuple like
    ``(op_index, morsel_index, chunk, call)`` identifying the call's place
    in the plan rather than its arrival time. Keys are attached either
    explicitly (``record(..., key=...)``) or ambiently via the
    :meth:`keyed` context manager, which the runtime wraps around backend
    invocations (the ambient form survives the hop onto a tier-pool
    thread because the runtime re-enters it inside the pool thunk).
    ``call_keys`` parallels ``call_log``; :meth:`merge` uses the keys to
    combine per-shard meters into one log with *deterministic* ordering —
    sorted by logical key, not by which shard's thread billed first."""

    def __init__(self):
        self.by_tier: Dict[str, Usage] = {}
        self.call_log: List[tuple] = []      # (tier_name, latency_s)
        self.call_keys: List[Optional[tuple]] = []   # parallel logical keys
        # parallel (op_kind, tok_out_per_call) — CostModel.observe's food;
        # call_log itself stays 2-tuples (the scheduler drain unpacks two)
        self.call_ops: List[Optional[tuple]] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def __getstate__(self):
        # meters cross process boundaries under the ``procs`` driver:
        # worker call logs ship back to the coordinator with their
        # logical keys attached. Lock and thread-local state is
        # per-process; only the billed data travels.
        with self._lock:
            return {"by_tier": {t: dataclasses.replace(u)
                                for t, u in self.by_tier.items()},
                    "call_log": list(self.call_log),
                    "call_keys": list(self.call_keys),
                    "call_ops": list(self.call_ops)}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextlib.contextmanager
    def keyed(self, key: Optional[tuple]):
        """Attach ``key`` to every call recorded in this thread inside the
        ``with`` block (per-call index appended per entry)."""
        prev = getattr(self._local, "key", None)
        self._local.key = key
        try:
            yield self
        finally:
            self._local.key = prev

    def current_key(self) -> Optional[tuple]:
        """The ambient logical key installed by :meth:`keyed` on this
        thread (None outside a keyed block). Fault-injection harnesses
        (``testing.FlakyBackend``) key their deterministic fault plans
        off it: the logical call identity is driver- and shard-invariant,
        so a seeded plan injects the same faults into the same logical
        calls no matter how execution is scheduled."""
        return getattr(self._local, "key", None)

    def record(self, tier_name: str, usage: Usage,
               per_call_latency_s: Optional[Sequence[float]] = None,
               key: Optional[tuple] = None,
               op_kind: Optional[str] = None):
        if key is None:
            key = getattr(self._local, "key", None)
        if per_call_latency_s is None and usage.calls > 0:
            per_call_latency_s = [usage.latency_s / usage.calls] \
                * usage.calls
        op_info = None
        if op_kind is not None and usage.calls > 0:
            op_info = (op_kind, usage.tok_out / usage.calls)
        with self._lock:
            self.by_tier.setdefault(tier_name, Usage()).add(usage)
            for i, lat in enumerate(per_call_latency_s or ()):
                self.call_log.append((tier_name, lat))
                self.call_keys.append(None if key is None
                                      else tuple(key) + (i,))
                self.call_ops.append(op_info)

    def absorb(self, other: "UsageMeter") -> "UsageMeter":
        """Add another meter's totals and call log into this one (shard
        merge target; also the judge's two-run accounting)."""
        with other._lock:
            tiers = {t: dataclasses.replace(u)
                     for t, u in other.by_tier.items()}
            log, keys = list(other.call_log), list(other.call_keys)
            ops = list(other.call_ops)
            ops += [None] * (len(log) - len(ops))
        with self._lock:
            for t, u in tiers.items():
                self.by_tier.setdefault(t, Usage()).add(u)
            self.call_log.extend(log)
            self.call_keys.extend(keys)
            self.call_ops.extend(ops)
        return self

    @staticmethod
    def merge(meters: Sequence["UsageMeter"]) -> "UsageMeter":
        """Combine meters (e.g. one per shard) into a new meter whose
        ``call_log`` ordering is **deterministic**: entries sort by their
        logical (morsel, call) key, not by arrival time — so two threaded
        sharded runs that made the same calls report identical logs.
        Un-keyed entries keep (meter position) order after the keyed ones."""
        out = UsageMeter()
        entries = []
        for mi, m in enumerate(meters):
            with m._lock:
                for tier, u in m.by_tier.items():
                    out.by_tier.setdefault(tier, Usage()).add(u)
                for pos, entry in enumerate(m.call_log):
                    k = m.call_keys[pos] if pos < len(m.call_keys) else None
                    o = m.call_ops[pos] if pos < len(m.call_ops) else None
                    sort_key = (0, k) if k is not None else (1, (mi, pos))
                    entries.append((sort_key, entry, k, o))
        entries.sort(key=lambda e: e[0])
        for _, entry, k, o in entries:
            out.call_log.append(entry)
            out.call_keys.append(k)
            out.call_ops.append(o)
        return out

    @property
    def total(self) -> Usage:
        t = Usage()
        with self._lock:
            for u in self.by_tier.values():
                t.add(u)
        return t

    def calls(self, tier_name: str) -> int:
        with self._lock:
            u = self.by_tier.get(tier_name)
            return u.calls if u is not None else 0

    def latency(self, tier_name: str) -> float:
        with self._lock:
            u = self.by_tier.get(tier_name)
            return u.latency_s if u is not None else 0.0


class Backend(Protocol):
    tier: cost_mod.TierSpec

    def run_values(self, op: plan_ir.Operator, values: Sequence[Any],
                   meter: Optional[UsageMeter] = None,
                   batch_size: int = 1) -> List[Any]:
        """Execute `op` on each value (reduce: one call over all values).
        batch_size > 1 = batch prompting (App. C): several records share one
        call — cheaper, but the per-record accuracy degrades."""
        ...


# ---------------------------------------------------------------------------
# Oracle protocol — ground truth provider (datasets implement it)
# ---------------------------------------------------------------------------

class Oracle(Protocol):
    def answer(self, op: plan_ir.Operator, value: Any) -> Any:
        """The true output of `op` for one record value."""
        ...

    def answer_reduce(self, op: plan_ir.Operator,
                      values: Sequence[Any]) -> Any:
        ...


class UDFOracle:
    """Fallback oracle: answers via the compiled-UDF grammar. Datasets wrap
    it with instruction-specific truth functions for non-computable ops."""

    def answer(self, op: plan_ir.Operator, value: Any):
        from repro_torch.core import udf as udf_mod
        c = udf_mod.compile_udf(op)
        if c is None:
            raise KeyError(
                f"no oracle for instruction {op.instruction!r}")
        return c.fn(value)

    def answer_reduce(self, op: plan_ir.Operator, values: Sequence[Any]):
        from repro_torch.core import udf as udf_mod
        c = udf_mod.compile_reduce(op.instruction)
        if c is None:
            raise KeyError(
                f"no reduce oracle for instruction {op.instruction!r}")
        return c.fn(list(values))


# ---------------------------------------------------------------------------
# Capability simulator
# ---------------------------------------------------------------------------

def _unit_hash(*parts) -> float:
    """Deterministic U[0,1) from content (stable across runs/processes)."""
    h = hashlib.blake2b("\x1f".join(map(str, parts)).encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") / 2.0 ** 64


_IMAGE_WORDS = ("picture", "image", "poster", "photo", "observed", "badge",
                "audio")


def op_hardness(op: plan_ir.Operator) -> float:
    """Structural instruction difficulty in [0.1, 1.8]."""
    base = {plan_ir.FILTER: 0.35, plan_ir.MAP: 0.85, plan_ir.REDUCE: 0.6,
            plan_ir.RANK: 1.0}[op.kind]
    h = base + min(0.4, len(op.instruction) / 400.0)
    ins = op.instruction.lower()
    if any(w in ins for w in _IMAGE_WORDS):
        h += 0.45
    h += 0.5 * (_unit_hash("hardness", op.kind, op.instruction) - 0.5)
    return max(0.1, min(1.8, h))


_WRONG_TOKENS = ("unclear from the data", "not specified", "mixed signals",
                 "requires manual review", "ambiguous entry")


def corrupt_value(truth: Any, salt: str) -> Any:
    """A canonical wrong answer for a record (binary response model). Wrong
    answers must be *semantically* wrong — they may not retain the truth's
    key content (else the embedding comparator correctly treats them as
    equal and they are not errors at all)."""
    if isinstance(truth, bool):
        return not truth
    if isinstance(truth, (int, float)):
        u = _unit_hash("corrupt", salt)
        delta = (0.07 + 0.5 * u) * (abs(float(truth)) + 1.0)
        return type(truth)(truth + delta if u > 0.5 else truth - delta)
    if truth is None:
        return "unknown"
    s = str(truth)
    u = _unit_hash("corrupt-mode", salt, s)
    if u < 0.34:
        return "No relevant information found."
    if u < 0.67:
        return _WRONG_TOKENS[int(u * 1e6) % len(_WRONG_TOKENS)]
    return "possibly " + s[::-1][: max(4, len(s) // 2)]


@dataclasses.dataclass
class SimulatedBackend:
    tier: cost_mod.TierSpec
    oracle: Oracle
    violation_rate: float = 0.03   # P(a record violates Hypothesis 2)
    diverse_wrong: bool = False    # break the binary response model
    batch_penalty: float = 0.012   # capability loss per extra batched record
    seed: int = 0

    # -- correctness model -------------------------------------------------
    def _capability(self, op: plan_ir.Operator, batch_size: int = 1) -> float:
        """Effective capability on this operator = capability^hardness.

        Hardness is a structural difficulty model: maps (open-ended
        generation) are harder than filters (binary); image/audio-grounded
        instructions are harder than text; long instructions are harder;
        plus a small per-instruction jitter. cap^h preserves the tier
        ordering (Hypothesis 2's nesting) while making weak tiers degrade
        faster on hard operators — the source of the per-operator tier
        diversity in Fig. 10."""
        h = op_hardness(op)
        cap = min(self.tier.capability, 1.0) ** h \
            if self.tier.capability <= 1.0 else self.tier.capability
        return cap - self.batch_penalty * (batch_size - 1)

    def _is_correct(self, op: plan_ir.Operator, value: Any,
                    batch_size: int = 1) -> bool:
        diff = _unit_hash("difficulty", self.seed, op.kind, op.instruction,
                          value)
        cap = self._capability(op, batch_size)
        if _unit_hash("violation", self.seed, op.instruction,
                      value) < self.violation_rate:
            # hypothesis-2 violation: the record has a capability *pivot* —
            # tiers at or below it answer correctly, stronger tiers
            # overthink and fail (the paper's Table-2 "nano is right"
            # cases). Shared pivot across tiers keeps the violation
            # record-consistent.
            pivot = 0.7 + 0.3 * _unit_hash("pivot", self.seed,
                                           op.instruction, value)
            return cap <= pivot
        return diff < cap

    _UNANSWERABLE = {plan_ir.FILTER: False, plan_ir.MAP: "n/a",
                     plan_ir.RANK: 0, plan_ir.REDUCE: None}

    def _output(self, op: plan_ir.Operator, value: Any,
                batch_size: int = 1) -> Any:
        try:
            truth = self.oracle.answer(op, value)
        except KeyError:
            # nonsense instruction (e.g. a corrupted rewrite dropped half a
            # conjunct): a real LLM answers *something*; the simulator
            # returns the kind's degenerate answer
            return self._UNANSWERABLE[op.kind]
        if self._is_correct(op, value, batch_size):
            return truth
        salt_parts = [op.instruction, str(value)]
        if self.diverse_wrong:
            salt_parts.append(self.tier.name)
        return corrupt_value(truth, "|".join(salt_parts))

    # -- protocol ------------------------------------------------------------
    def run_values(self, op: plan_ir.Operator, values: Sequence[Any],
                   meter: Optional[UsageMeter] = None,
                   batch_size: int = 1) -> List[Any]:
        if op.kind == plan_ir.REDUCE:
            try:
                truth = self.oracle.answer_reduce(op, values)
            except KeyError:
                truth = None            # unanswerable reduce instruction
            ok = self._is_correct(op, "\x1e".join(map(str, values))[:512])
            out = truth if ok else corrupt_value(
                truth, op.instruction + "|reduce")
            usage = self._usage(op, n_calls=max(1, (len(values) + 31) // 32),
                                values=values)
            if meter:
                meter.record(self.tier.name, usage,
                             per_call_latency_s=self._per_call(usage),
                             op_kind=op.kind)
            return [out]
        outs = [self._output(op, v, batch_size) for v in values]
        n_calls = max(1, (len(values) + batch_size - 1) // batch_size)
        usage = self._usage(op, n_calls=n_calls, values=values)
        if meter:
            meter.record(self.tier.name, usage,
                         per_call_latency_s=self._per_call(usage),
                         op_kind=op.kind)
        return outs

    @staticmethod
    def _per_call(usage: Usage) -> List[float]:
        """Per-call latency report: tier latency is homogeneous per op."""
        return [usage.latency_s / usage.calls] * usage.calls

    def _usage(self, op: plan_ir.Operator, n_calls: int,
               values: Sequence[Any]) -> Usage:
        ins_tok = cost_mod.text_tokens(op.instruction)
        val_tok = sum(cost_mod.text_tokens(v) for v in values)
        tok_in = n_calls * ins_tok + val_tok
        tok_out = n_calls * cost_mod.OUT_TOKENS[op.kind]
        per_call_out = tok_out / max(1, n_calls)
        return Usage(calls=n_calls, tok_in=tok_in, tok_out=tok_out,
                     usd=self.tier.usd(tok_in, tok_out),
                     latency_s=n_calls * self.tier.latency(per_call_out))


def make_backends(oracle: Oracle,
                  tiers: Optional[Dict[str, cost_mod.TierSpec]] = None,
                  violation_rate: float = 0.02,
                  diverse_wrong: bool = False,
                  seed: int = 0) -> Dict[str, Backend]:
    """The standard four-tier simulated cascade."""
    tiers = tiers or cost_mod.DEFAULT_TIERS
    return {name: SimulatedBackend(spec, oracle,
                                   violation_rate=violation_rate,
                                   diverse_wrong=diverse_wrong, seed=seed)
            for name, spec in tiers.items()}
