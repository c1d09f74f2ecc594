"""Shared fake backends for the test suite and benchmarks.

One metering implementation (instead of per-file copies drifting apart):
the driver-equivalence and coalescing suites assert exact call counts,
batch groupings, and per-call latencies against these fakes, and
``benchmarks/bench_coalesce.py`` uses the same class so its measured
walls are comparable with the tests' acceptance bounds.
:class:`EmbeddingOracle` plays the same role for the tier-0 cascade:
a deterministic encoder whose cosine scores track the capability
simulator's difficulty draws, shared by the cascade tests and
``benchmarks/bench_cascade.py``.
"""
from __future__ import annotations

import hashlib
import math
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import backends as bk
from repro_torch.core import plan as plan_ir
from repro_torch.core import runtime as rt
from repro_torch.core.cost import TierSpec


class EchoOracle:
    """Deterministic value-derived answers — lets tests assert outputs."""

    def answer(self, op, value):
        return f"A:{value}"

    def answer_reduce(self, op, values):
        return len(list(values))


class ConstOracle:
    """Always-true filter oracle (every row survives)."""

    def answer(self, op, value):
        return True

    def answer_reduce(self, op, values):
        return len(list(values))


class KindOracle:
    """Kind-aware deterministic oracle for multi-operator pipelines:
    filters pass every row, maps echo the value, reduces count — so
    filter -> map -> reduce chains produce assertable outputs."""

    def answer(self, op, value):
        return True if op.kind == plan_ir.FILTER else f"A:{value}"

    def answer_reduce(self, op, values):
        return len(list(values))


def tagged_table(tag: str, n: int = 32):
    """A one-column table whose values are tagged (``tag-i``) — paired
    with :func:`tagged_plan` so distinct tags never share cache keys."""
    from repro_torch.core.table import Table
    return Table({"v": [f"{tag}-{i}" for i in range(n)]}, name=tag)


def tagged_plan(tag: str, reduce_tail: bool = False) -> plan_ir.LogicalPlan:
    """filter -> map (-> reduce) over :func:`tagged_table`, with the tag
    baked into every instruction: queries built from different tags
    never overlap on ``OutputCache`` keys, so their billing is
    independent of co-tenants on a shared server — the property the
    serve suite's solo-identity assertions and ``bench_serve`` rely on."""
    ops = [
        plan_ir.Operator(plan_ir.FILTER, f"keep-{tag}", "v"),
        plan_ir.Operator(plan_ir.MAP, f"annotate-{tag}", "v", "a"),
    ]
    if reduce_tail:
        ops.append(plan_ir.Operator(plan_ir.REDUCE, f"count-{tag}", "v"))
    return plan_ir.LogicalPlan(tuple(ops))


def result_fingerprint(res):
    """Canonical byte-comparable key for an ExecutionResult of a
    :func:`tagged_plan` run (reduce scalar, or rowids + mapped column)."""
    from repro_torch.core import executor as ex
    if res.is_reduce:
        return ("reduce", res.scalar)
    return ("table", tuple(res.table.columns[ex.ROWID]),
            tuple(map(str, res.table.columns["a"])))


class EmbeddingOracle:
    """Deterministic seedable encoder for ``core.cascade`` tests/benches.

    Implements the cascade ``Encoder`` protocol with hash-derived unit
    vectors whose cosine against the operator anchor *correlates with the
    capability simulator's difficulty draws*: a value with difficulty
    ``d`` (the exact ``_unit_hash("difficulty", ...)`` draw the
    :class:`~repro_torch.core.backends.SimulatedBackend` uses) embeds at

        cos = sign * (base + spread * (1 - d))

    where ``sign`` is +1 iff the oracle's true answer is truthy. Easy
    records sit far from the decision boundary, hard ones near it — so
    band routing is testable end-to-end without a real encoder, and
    :meth:`bands_for` can place thresholds such that every on-device
    resolution targets a record the given backend answers correctly
    (making cascade and no-cascade results identical at
    ``violation_rate=0``)."""

    def __init__(self, oracle, seed: int = 0, dim: Optional[int] = None,
                 base: float = 0.15, spread: float = 0.80):
        from repro_torch.core import semhash
        self.oracle = oracle
        self.seed = seed
        self.dim = dim if dim is not None else semhash.DIM
        self.base = base
        self.spread = spread

    def _unit(self, *parts) -> np.ndarray:
        h = hashlib.blake2b("\x1f".join(map(str, parts)).encode(),
                            digest_size=8).digest()
        rng = np.random.default_rng(int.from_bytes(h, "little"))
        v = rng.standard_normal(self.dim)
        return v / np.linalg.norm(v)

    def encode_anchor(self, op) -> np.ndarray:
        return self._unit("anchor", self.seed, op.kind,
                          op.instruction).astype(np.float32)

    def encode_values(self, op, values: Sequence) -> np.ndarray:
        a = self._unit("anchor", self.seed, op.kind, op.instruction)
        rows = []
        for v in values:
            diff = bk._unit_hash("difficulty", self.seed, op.kind,
                                 op.instruction, v)
            truth = self.oracle.answer(op, v)
            sign = 1.0 if bool(truth) else -1.0
            cos = sign * min(0.999,
                             self.base + self.spread * (1.0 - diff))
            b = self._unit("tangent", self.seed, op.kind, str(v))
            b = b - float(b @ a) * a
            b = b / np.linalg.norm(b)
            rows.append(cos * a + math.sqrt(max(0.0, 1.0 - cos * cos)) * b)
        return np.asarray(rows, np.float32)

    def bands_for(self, op, backend, batch_size: int = 1,
                  margin: float = 0.02):
        """Bands under which every on-device resolution hits a record
        ``backend`` answers correctly: resolved => |cos| >= hi =>
        difficulty <= cap - margin/spread < cap => correct (at
        ``violation_rate=0``), so cascade results match no-cascade
        byte-for-byte while everything easier than the backend's
        effective capability skips the LLM."""
        from repro_torch.core.cascade import CascadeBands
        cap = backend._capability(op, batch_size) \
            if hasattr(backend, "_capability") else 1.0
        cap = min(max(cap, 0.0), 1.0)
        hi = min(0.999, self.base + self.spread * (1.0 - cap) + margin)
        return CascadeBands(lo=-hi, hi=hi)


class SleepBackend:
    """Always-correct fake backend whose calls *really* sleep.

    Each (batched) call bills ``delay_s`` metered latency — exactly like
    SimulatedBackend bills its modeled latency — and sleeps ``sleep_s``
    real seconds (defaults to ``delay_s``; pass ``sleep_s=0.0`` for
    event-time-only tests that want 1s modeled calls without 1s waits).
    Counts calls and records each call's value group under a lock, so
    tests can assert the exact batch grouping the runtime formed."""

    def __init__(self, oracle, delay_s: float = 0.05, name: str = "m*",
                 capability: float = 1.01,
                 sleep_s: Optional[float] = None):
        self.tier = TierSpec(name, capability, 0.0, 0.0, delay_s, 0.0)
        self.oracle = oracle
        self.delay_s = delay_s
        self.sleep_s = delay_s if sleep_s is None else sleep_s
        self.calls_made = 0
        self.groups = []
        self._lock = threading.Lock()

    def __getstate__(self):
        # picklable for the ``procs`` driver's worker processes; answers
        # are value-derived (oracles are stateless), so a shipped copy
        # answers identically to the coordinator's original
        state = dict(self.__dict__)
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def run_values(self, op, values: Sequence, meter=None,
                   batch_size: int = 1):
        values = list(values)
        if op.kind == plan_ir.REDUCE:
            n_calls = 1
            outs = [self.oracle.answer_reduce(op, values)]
        else:
            n_calls = max(1, -(-len(values) // batch_size))
            outs = [self.oracle.answer(op, v) for v in values]
        with self._lock:
            self.calls_made += n_calls
            self.groups.append(tuple(map(str, values)))
        if self.sleep_s:
            time.sleep(self.sleep_s * n_calls)
        if meter is not None:
            meter.record(self.tier.name,
                         bk.Usage(calls=n_calls, tok_in=8.0 * len(values),
                                  tok_out=4.0 * n_calls, usd=0.0,
                                  latency_s=self.delay_s * n_calls),
                         per_call_latency_s=[self.delay_s] * n_calls,
                         op_kind=op.kind)
        return outs


class FlakyBackend:
    """Deterministic chaos wrapper around any backend — the fault plan
    is a pure function of ``(seed, logical call key)``.

    Each ``run_values`` call draws ``u = _unit_hash("fault-plan", seed,
    key)`` where the key is the ambient :meth:`UsageMeter.current_key`
    the runtime installs around every backend call. Logical keys are
    driver-, shard-count- and admission-order-invariant, and retry
    attempts carry their own ``(RETRY_KEY_MARK, attempt)`` suffix — so a
    fixed ``(seed, rates)`` plan injects the same faults into the same
    logical calls under any scheduling, and a retried call draws fresh.
    Bands (in order): ``u < error_rate`` raises
    :class:`runtime.TransientCallError`; next ``timeout_rate`` raises
    :class:`runtime.CallTimeoutError` (billing the call's deadline as
    its latency); next ``slow_rate`` sleeps ``slow_s`` real seconds
    (only when ``real_sleep``) then answers normally. ``poison_values``
    fail *every* attempt — the permanent-failure band retries cannot
    mask (used by the coalescer-poison regression tests).

    Faulted attempts are billed as one call with ``op_kind=None``: they
    land in the call log and the spend totals (retries are not free),
    but :meth:`CostModel.observe` skips them, so fault noise never
    corrupts the latency/q-error EWMAs."""

    def __init__(self, inner, *, error_rate: float = 0.0,
                 timeout_rate: float = 0.0, slow_rate: float = 0.0,
                 slow_s: float = 0.0, seed: int = 0,
                 fault_latency_s: float = 0.01,
                 poison_values=(), real_sleep: bool = False):
        self.inner = inner
        self.tier = inner.tier
        self.error_rate = error_rate
        self.timeout_rate = timeout_rate
        self.slow_rate = slow_rate
        self.slow_s = slow_s
        self.seed = seed
        self.fault_latency_s = fault_latency_s
        self.poison_values = frozenset(map(str, poison_values))
        self.real_sleep = real_sleep
        self.calls_seen = 0
        self.faults_injected = 0
        self._lock = threading.Lock()
        self._anon_attempts: dict = {}

    def __getstate__(self):
        # fault plans are pure functions of (seed, logical key) via a
        # content hash — a pickled copy in a worker process draws the
        # exact same plan, so chaos runs stay deterministic over the wire
        state = dict(self.__dict__)
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def __getattr__(self, name):
        # delegate capability probes etc. (_capability, oracle, ...);
        # never delegate dunders (pickle probes __reduce_ex__ machinery
        # before __dict__ exists — delegating would recurse on `inner`)
        if name.startswith("__") or "inner" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.inner, name)

    def _ident(self, op, values, meter):
        """Logical identity of this call for the fault draw."""
        key = meter.current_key() if meter is not None else None
        if key is not None:
            return key
        # no ambient key (bare run_values outside the runtime): fall
        # back to content identity plus a per-identity attempt counter
        # so repeated identical calls still draw independently
        base = (op.kind, op.instruction, tuple(map(str, values)))
        with self._lock:
            n = self._anon_attempts.get(base, 0)
            self._anon_attempts[base] = n + 1
        return base + (n,)

    def _bill_fault(self, op, values, meter, latency_s: float):
        with self._lock:
            self.faults_injected += 1
        if meter is None:
            return
        tok_in = 8.0 * len(list(values))
        meter.record(self.tier.name,
                     bk.Usage(calls=1, tok_in=tok_in, tok_out=0.0,
                              usd=self.tier.usd(tok_in, 0.0),
                              latency_s=latency_s),
                     per_call_latency_s=[latency_s],
                     op_kind=None)

    def run_values(self, op, values: Sequence, meter=None,
                   batch_size: int = 1):
        values = list(values)
        with self._lock:
            self.calls_seen += 1
        if self.poison_values and any(str(v) in self.poison_values
                                      for v in values):
            self._bill_fault(op, values, meter, self.fault_latency_s)
            raise rt.TransientCallError(
                f"poisoned value in {op.kind}:{op.instruction}")
        u = bk._unit_hash("fault-plan", self.seed,
                          repr(self._ident(op, values, meter)))
        if u < self.error_rate:
            self._bill_fault(op, values, meter, self.fault_latency_s)
            raise rt.TransientCallError(
                f"injected transient error (u={u:.3f})")
        if u < self.error_rate + self.timeout_rate:
            budget = rt.current_call_timeout()
            self._bill_fault(op, values, meter,
                             budget if budget is not None
                             else self.fault_latency_s)
            raise rt.CallTimeoutError(
                f"injected timeout (u={u:.3f})")
        if u < self.error_rate + self.timeout_rate + self.slow_rate \
                and self.real_sleep and self.slow_s:
            time.sleep(self.slow_s)
        return self.inner.run_values(op, values, meter=meter,
                                     batch_size=batch_size)


# One lock per *process* (module-level: spawn re-imports this module in
# each worker, so every worker process gets its own). GilBoundBackend
# holds it across its modeled compute — the GIL model below.
_GIL_MODEL_LOCK = threading.Lock()


class GilBoundBackend:
    """Always-correct fake whose per-call work is *GIL-bound by model*:
    each call sleeps ``work_s`` while holding the process-global
    :data:`_GIL_MODEL_LOCK`.

    Why model instead of burning CPU: the bench containers often expose
    a single core, where real CPU-bound work cannot show parallel
    speedup for *any* execution substrate — the measurement would say
    nothing about the GIL. This fake models the GIL's defining property
    directly, the same way :class:`SleepBackend` models I/O with
    ``time.sleep``: within one Python process, concurrent calls
    serialize on the lock exactly as bytecode serializes on the GIL
    (threads driver: total wall ≥ calls × ``work_s`` regardless of pool
    width); across ``procs`` workers, each spawned process re-imports
    this module and gets its *own* lock, so calls overlap exactly as
    separate interpreters escape each other's GIL. ``bench_shard.py``
    uses it to locate the thread-scaling knee and the process-worker
    speedup past it.

    Billing mirrors :class:`SleepBackend` (``work_s`` metered latency
    per call, deterministic token counts), so invariance assertions
    compare byte-identically across drivers and shard counts."""

    def __init__(self, oracle, work_s: float = 0.004, name: str = "m*",
                 capability: float = 1.01):
        self.tier = TierSpec(name, capability, 0.0, 0.0, work_s, 0.0)
        self.oracle = oracle
        self.work_s = work_s
        self.calls_made = 0
        self._lock = threading.Lock()

    def __getstate__(self):
        state = dict(self.__dict__)
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def run_values(self, op, values: Sequence, meter=None,
                   batch_size: int = 1):
        values = list(values)
        if op.kind == plan_ir.REDUCE:
            n_calls = 1
            outs = [self.oracle.answer_reduce(op, values)]
        else:
            n_calls = max(1, -(-len(values) // batch_size))
            outs = [self.oracle.answer(op, v) for v in values]
        for _ in range(n_calls):
            with _GIL_MODEL_LOCK:      # "hold the GIL" for the work
                time.sleep(self.work_s)
        with self._lock:
            self.calls_made += n_calls
        if meter is not None:
            meter.record(self.tier.name,
                         bk.Usage(calls=n_calls, tok_in=8.0 * len(values),
                                  tok_out=4.0 * n_calls, usd=0.0,
                                  latency_s=self.work_s * n_calls),
                         per_call_latency_s=[self.work_s] * n_calls,
                         op_kind=op.kind)
        return outs
