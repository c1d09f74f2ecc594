"""CostModel: the single calibrated estimation surface for both optimizers.

Everything that prices an operator — tier specs, per-op output-token
priors, the tokens-per-char rule, batch/cascade call-count math — lives on
one :class:`CostModel` object instead of a bag of module constants and
free functions (the old ``core.cost``, which now delegates here). One
model instance is threaded through ``ExecutionContext.cost_model`` to the
logical optimizer (candidate objective), the physical optimizer
(Algorithm-2 tier selection, including the tier-0 cascade pricing), the
judge (rating-call price), the query server, ``launch/serve.py`` and the
benchmarks — so a calibration learned anywhere is visible everywhere.

Two capabilities beyond the static price card:

* **Online calibration** — :meth:`observe` ingests a finalized
  ``UsageMeter``'s call log (each entry now carries its operator kind and
  per-call output tokens) and maintains, per (op kind, tier), the q-error
  ``max(pred/meas, meas/pred)`` of the model's latency prediction plus
  EWMA estimates of measured per-call latency and output tokens. The
  estimates feed back into :meth:`op_cost`/:meth:`plan_cost`, so the
  second query is priced with what the first one measured. ``observe``
  runs only at deterministic sync points — executor finalize and
  per-query server finalize, never mid-execution — and folds the window
  in *logical call-key order* (the same sort ``UsageMeter.merge`` uses),
  so calibration state is identical across drivers, shard counts, and
  admission orders. Per-meter cursors make repeated observation of the
  same meter idempotent.

* **Scheduler-aware cost** — :meth:`plan_cost` can replay the candidate
  plan's calls onto an :class:`runtime.EventScheduler` seeded with the
  current dispatcher pool occupancy (``PlanCost.makespan_s``), and
  :meth:`op_makespan` does the same for one operator, so the physical
  optimizer can select tiers on a weighted USD x makespan objective.
  ``latency_weight=0`` (the default) reproduces the pure-USD behaviour
  exactly: no makespan is computed and no penalty is applied.

The module-level :data:`DEFAULT_MODEL` backs the deprecated free
functions in ``core.cost``; it is **never calibrated implicitly** — only
a model explicitly placed on an ``ExecutionContext`` observes meters, so
library defaults stay byte-stable across runs and tests.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from typing import Dict, List, Optional, Tuple

from repro_torch.core import plan as plan_ir

TOKENS_PER_CHAR = 0.25   # ~4 chars/token


# ---------------------------------------------------------------------------
# Backend tiers (m1 < m2 < m3 < m*) — §4's four-model setting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TierSpec:
    name: str
    capability: float            # P(correct) scale for the simulator
    usd_per_m_in: float
    usd_per_m_out: float
    latency_call_s: float        # per-call overhead (network + queue)
    latency_tok_s: float         # per output token
    arch: Optional[str] = None   # model zoo id backing this tier

    def usd(self, tok_in: float, tok_out: float) -> float:
        return (tok_in * self.usd_per_m_in
                + tok_out * self.usd_per_m_out) / 1e6

    def latency(self, tok_out: float) -> float:
        return self.latency_call_s + tok_out * self.latency_tok_s


# price card mirrors OpenAI's GPT-4.1 family (paper §5.1.4); capabilities are
# the simulator's knobs calibrated so Table-2-style alignment stats reproduce
# (misaligned fraction ~0.15 on a hard map; see benchmarks/table2).
DEFAULT_TIERS: Dict[str, TierSpec] = {
    "m1": TierSpec("m1", 0.88, 0.10, 0.40, 0.35, 0.004, arch="qwen2-0.5b"),
    "m2": TierSpec("m2", 0.92, 0.15, 0.60, 0.45, 0.006,
                   arch="granite-moe-1b-a400m"),
    "m3": TierSpec("m3", 0.96, 0.40, 1.60, 0.60, 0.010, arch="minicpm3-4b"),
    "m*": TierSpec("m*", 0.99, 2.00, 8.00, 0.90, 0.022,
                   arch="codeqwen1.5-7b"),
}
TIER_ORDER = ("m1", "m2", "m3", "m*")

# tier-0 embedding pass (core.cascade): one batched kernel launch
# scores a whole morsel, so the per-row price is ~1000x below m1's and the
# "per-call" latency is a kernel launch, not a network round trip. Not part
# of TIER_ORDER — it cannot answer an operator alone; it only *routes*
# (cascade bands decide pass/drop, the uncertain band escalates to an LLM
# tier), so improvement-score tier selection never assigns it directly.
EMBED_TIER_NAME = "tier0-embed"
EMBED_ROW_S = 2e-6              # modeled per-row device time
EMBED_TIER = TierSpec(EMBED_TIER_NAME, 0.0, 0.0001, 0.0, 0.002, 0.0)

# output length model per operator kind (tokens per record)
OUT_TOKENS = {plan_ir.FILTER: 2.0, plan_ir.MAP: 24.0, plan_ir.REDUCE: 16.0,
              plan_ir.RANK: 6.0}

# fallback per-call output tokens for kinds outside OUT_TOKENS (e.g. the
# judge's rating call bills under op kind "judge")
_OUT_TOKENS_DEFAULT = 8.0

# plans with more calls than this are priced analytically (waves formula)
# instead of being replayed call-by-call through the event scheduler
_MAX_REPLAY_CALLS = 4096


# ---------------------------------------------------------------------------
# Cost records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpCost:
    llm_calls: float = 0.0
    tok_in: float = 0.0
    tok_out: float = 0.0
    usd: float = 0.0
    latency_s: float = 0.0       # sequential latency of this op's calls
    rows_in: float = 0.0
    rows_out: float = 0.0


@dataclasses.dataclass
class PlanCost:
    per_op: list
    llm_calls: float = 0.0
    tok_in: float = 0.0
    tok_out: float = 0.0
    usd: float = 0.0
    latency_s: float = 0.0       # wall-clock under `concurrency`
    rows_processed: float = 0.0  # paper Fig. 10/13 metric
    # event-scheduler replay of the plan's calls (0.0 unless the model
    # computed it — latency_weight > 0, an occupancy seed, or makespan=True)
    makespan_s: float = 0.0

    @property
    def cost(self) -> float:
        """The scalar the logical optimizer minimizes (Alg. 1 line 9)."""
        return self.usd

    def describe(self) -> str:
        return (f"calls={self.llm_calls:.0f} tok_in={self.tok_in:.0f} "
                f"usd={self.usd:.4f} latency={self.latency_s:.1f}s "
                f"rows={self.rows_processed:.0f}")


def _qerror(pred: float, meas: float) -> float:
    """The classic cardinality-estimation metric, applied to latency/tokens:
    symmetric multiplicative error, >= 1.0, 1.0 = perfect."""
    p = max(float(pred), 1e-12)
    m = max(float(meas), 1e-12)
    return max(p / m, m / p)


@dataclasses.dataclass
class _CalEntry:
    """EWMA calibration state for one (op kind, tier) pair."""
    n: int = 0
    latency_s: float = 0.0       # EWMA measured per-call latency
    tok_out: float = 0.0         # EWMA measured per-call output tokens
    qerr_ewma: float = 0.0       # EWMA of prospective latency q-error
    qerr_last: float = 0.0
    qerr_max: float = 0.0


@dataclasses.dataclass
class _AdmissionCal:
    """Whole-plan makespan calibration for the admission controller:
    an EWMA correction ratio (measured / raw-replay makespan) applied to
    future :meth:`CostModel.admission_estimate` calls, plus the q-error
    trajectory of the *corrected* predictions against measurements."""
    n: int = 0
    ratio: float = 1.0           # EWMA of measured / raw-replay makespan
    qerr_ewma: float = 0.0       # q-error of corrected pred vs measured
    qerr_last: float = 0.0
    qerr_max: float = 0.0


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class CostModel:
    """One calibrated estimation surface (see module docstring).

    ``latency_weight`` steers the cost x makespan trade: 0 = pure USD
    (byte-identical to the pre-CostModel behaviour; test-enforced),
    > 0 mixes a normalized makespan term into the physical optimizer's
    upgrade margin and a USD-equivalent makespan term into the logical
    optimizer's objective (``usd_per_second`` is the exchange rate).
    ``ewma_alpha`` is the calibration smoothing factor; the first
    observation snaps the estimate to the measurement so one run is
    enough to converge on a stationary backend."""

    def __init__(self, tiers: Optional[Dict[str, TierSpec]] = None,
                 out_tokens: Optional[Dict[str, float]] = None,
                 tokens_per_char: float = TOKENS_PER_CHAR,
                 embed_tier: TierSpec = EMBED_TIER,
                 embed_row_s: float = EMBED_ROW_S,
                 latency_weight: float = 0.0,
                 usd_per_second: float = 0.001,
                 ewma_alpha: float = 0.5):
        self.tiers = dict(tiers or DEFAULT_TIERS)
        self.out_tokens = dict(out_tokens or OUT_TOKENS)
        self.tokens_per_char = float(tokens_per_char)
        self.embed_tier = embed_tier
        self.embed_row_s = float(embed_row_s)
        self.latency_weight = float(latency_weight)
        self.usd_per_second = float(usd_per_second)
        self.ewma_alpha = float(ewma_alpha)
        self._cal: Dict[Tuple[str, str], _CalEntry] = {}
        # whole-plan makespan calibration for admission control — kept
        # OUT of the per-(op, tier) state and out of calibration_state():
        # admission feedback only exists on serving paths, and the
        # invariance suites byte-compare calibration_state between served
        # and solo runs
        self._adm = _AdmissionCal()
        # meter -> consumed call_log length; weak keys so a long-lived
        # model does not pin every per-query meter it ever observed
        self._cursors = weakref.WeakKeyDictionary()
        self._lock = threading.Lock()

    # -- token model -----------------------------------------------------
    def text_tokens(self, text) -> float:
        """The single source of truth for the ~4-chars-per-token rule."""
        return max(1.0, len(str(text)) * self.tokens_per_char)

    def judge_tokens(self, n_rows: int) -> float:
        """Prompt-length model of one judge rating call (both plans'
        rendered sample outputs)."""
        return 200.0 + 40.0 * float(n_rows)

    def tier_list(self, tiers: Optional[Dict[str, TierSpec]] = None
                  ) -> List[TierSpec]:
        t = tiers or self.tiers
        return [t[k] for k in TIER_ORDER if k in t]

    # -- calibrated priors ----------------------------------------------
    def _prior_tok_out(self, kind: str) -> float:
        return self.out_tokens.get(kind, _OUT_TOKENS_DEFAULT)

    def _prior_call_latency(self, kind: str, tier_name: str) -> float:
        spec = self.tiers.get(tier_name)
        if spec is None:
            if tier_name == self.embed_tier.name:
                return self.embed_tier.latency_call_s
            return 0.0
        return spec.latency(self._prior_tok_out(kind))

    def predicted_call_latency(self, kind: str, tier_name: str) -> float:
        """Per-call latency the model currently predicts for (kind, tier):
        the calibrated EWMA when observed, the price-card prior otherwise."""
        with self._lock:
            e = self._cal.get((kind, tier_name))
            if e is not None and e.n > 0:
                return e.latency_s
        return self._prior_call_latency(kind, tier_name)

    def predicted_tok_out(self, kind: str, tier_name: str) -> float:
        with self._lock:
            e = self._cal.get((kind, tier_name))
            if e is not None and e.n > 0:
                return e.tok_out
        return self._prior_tok_out(kind)

    # -- operator / plan estimation --------------------------------------
    def op_cost(self, op: plan_ir.Operator, rows_in: float, tier: TierSpec,
                avg_value_tokens: float = 60.0,
                concurrency: int = 1, batch_size: int = 1,
                cascade_escalate: Optional[float] = None) -> OpCost:
        """Cost of one operator over ``rows_in`` records.

        LLM ops: ``ceil(rows / batch_size)`` calls — the executor's batch
        coalescer packs surviving rows across morsel boundaries, so the
        model prices whole-table batching, not per-morsel ragged ceilings.
        Batched records share the instruction prompt and the call's output
        budget. (Reduce: hierarchical tree over batches of ~32 values per
        call.) UDF ops: zero LLM cost, negligible latency.

        ``cascade_escalate`` prices a tier-0 embedding cascade on this
        operator (``core.cascade``): one batched kernel pass scores every
        row (EMBED_TIER prices + a launch latency), and only the escalated
        fraction reaches the LLM tier — ``ceil(rows * frac / batch)``
        calls instead of ``ceil(rows / batch)``.

        Output-token and latency estimates use the calibrated per-(kind,
        tier) EWMAs when :meth:`observe` has seen measurements; otherwise
        the static priors — so an uncalibrated model reproduces the old
        free-function numbers exactly."""
        rows_out = rows_in * op.selectivity if op.kind == plan_ir.FILTER \
            else (1.0 if op.kind == plan_ir.REDUCE else rows_in)
        c = OpCost(rows_in=rows_in, rows_out=rows_out)
        if not op.is_llm:
            c.latency_s = rows_in * 2e-6
            return c
        ins_tok = self.text_tokens(op.instruction)
        out_per_call = self.predicted_tok_out(op.kind, tier.name)
        if op.kind == plan_ir.REDUCE:
            batch = 32.0
            calls = 0.0
            level = rows_in
            while level > 1.0:
                level = math.ceil(level / batch)
                calls += level
            calls = max(calls, 1.0)
            c.llm_calls = calls
            c.tok_in = calls * (ins_tok + batch * avg_value_tokens * 0.5)
            c.tok_out = calls * out_per_call
        else:
            b = max(1, int(batch_size))
            llm_rows = rows_in
            if cascade_escalate is not None:
                llm_rows = rows_in * min(max(cascade_escalate, 0.0), 1.0)
            calls = math.ceil(llm_rows / b) if llm_rows > 0 else 0.0
            c.llm_calls = float(calls)
            c.tok_in = calls * ins_tok + llm_rows * avg_value_tokens
            c.tok_out = calls * out_per_call
        c.usd = tier.usd(c.tok_in, c.tok_out)
        c.latency_s = c.llm_calls * self._call_latency(op.kind, tier, c)
        if cascade_escalate is not None and op.kind != plan_ir.REDUCE:
            # the device pass itself: every row is embedded and scored in
            # one batched kernel launch, billed under the tier-0 price card
            c.usd += self.embed_tier.usd(rows_in * avg_value_tokens, 0.0)
            c.latency_s += (self.embed_tier.latency_call_s
                            + rows_in * self.embed_row_s)
        return c

    def _call_latency(self, kind: str, tier: TierSpec, c: OpCost) -> float:
        with self._lock:
            e = self._cal.get((kind, tier.name))
            if e is not None and e.n > 0:
                return e.latency_s
        per_call_out = c.tok_out / max(c.llm_calls, 1.0)
        return tier.latency(per_call_out)

    def plan_cost(self, plan: plan_ir.LogicalPlan, n_rows: int,
                  tiers: Optional[Dict[str, TierSpec]] = None,
                  default_tier: str = "m*",
                  avg_value_tokens: float = 60.0,
                  concurrency: int = 16, batch_size: int = 1,
                  shards: int = 1,
                  cascade: Optional[Dict[int, float]] = None,
                  occupancy: Optional[Dict[str, List[float]]] = None,
                  makespan: Optional[bool] = None) -> PlanCost:
        """Estimate a full plan: record counts flow through selectivities.

        ``concurrency`` is one shard worker's replica width; ``shards``
        multiplies it (morsel-parallel sharded execution runs a
        pool-per-(shard, tier), so un-quota'd effective width is
        ``concurrency * shards`` — matching ``ShardedDispatcher``).

        ``cascade`` maps op index -> expected escalation fraction for
        operators running behind a tier-0 embedding cascade (see
        ``op_cost``); ``rows_processed`` then counts only the escalated
        (LLM-seen) rows — the Fig. 13 metric the cascade is built to
        shrink.

        ``makespan`` controls the event-scheduler replay that fills
        ``PlanCost.makespan_s``: ``None`` computes it iff the model's
        ``latency_weight > 0`` or an ``occupancy`` seed was given (so the
        default-weight path never pays for it), ``True``/``False`` force
        it. ``occupancy`` is ``Dispatcher.occupancy()`` — per-tier lists
        of busy-until offsets the replay pre-loads, so the estimate sees
        the pools as the scheduler currently does."""
        tiers = tiers or self.tiers
        rows = float(n_rows)
        total = PlanCost(per_op=[])
        width = max(1, int(concurrency)) * max(1, int(shards))
        for k, op in enumerate(plan.ops):
            tier = tiers[op.tier or default_tier]
            esc = None if cascade is None else cascade.get(k)
            c = self.op_cost(op, rows, tier, avg_value_tokens,
                             batch_size=batch_size, cascade_escalate=esc)
            total.per_op.append(c)
            total.llm_calls += c.llm_calls
            total.tok_in += c.tok_in
            total.tok_out += c.tok_out
            total.usd += c.usd
            # ops execute in sequence; each op's calls run `width`-wide
            total.latency_s += c.latency_s / width
            if op.is_llm:
                total.rows_processed += c.rows_in if esc is None \
                    else c.rows_in * min(max(esc, 0.0), 1.0)
            rows = c.rows_out
        want_makespan = (self.latency_weight > 0 or occupancy is not None) \
            if makespan is None else bool(makespan)
        if want_makespan:
            total.makespan_s = self._replay(
                plan, total.per_op, tiers, default_tier,
                concurrency=concurrency, shards=shards, occupancy=occupancy)
        return total

    def objective(self, pc: PlanCost) -> float:
        """The scalar a cost-aware optimizer minimizes: pure USD at
        ``latency_weight=0`` (exactly the old ``PlanCost.cost``), else
        USD plus a USD-equivalent makespan term."""
        if self.latency_weight <= 0:
            return pc.usd
        return pc.usd + (self.latency_weight * self.usd_per_second
                         * pc.makespan_s)

    # -- event-scheduler replay ------------------------------------------
    def _replay(self, plan, per_op, tiers, default_tier, *,
                concurrency: int, shards: int,
                occupancy: Optional[Dict[str, List[float]]],
                per_tier: Optional[Dict[str, int]] = None,
                mode: str = "async") -> float:
        # lazy import: runtime builds on backends -> cost -> this module,
        # so the dependency must not exist at import time
        from repro_torch.core import runtime as rt
        sched = rt.EventScheduler(
            concurrency=max(1, int(concurrency)) * max(1, int(shards)),
            per_tier=per_tier, mode=mode)
        sched.seed_occupancy(occupancy)
        ready = 0.0
        for op, c in zip(plan.ops, per_op):
            if not op.is_llm:
                if c.latency_s > 0:
                    ready = sched.submit(rt.HOST_TIER, c.latency_s, ready)
                continue
            tname = op.tier or default_tier
            calls = int(round(c.llm_calls))
            if calls <= 0:
                continue
            per_call = c.latency_s / calls
            if calls > _MAX_REPLAY_CALLS:
                # analytic waves fallback: occupy one long slab instead of
                # replaying every call (keeps huge-table estimates cheap)
                waves = -(-calls // sched.workers(tname))
                ready = sched.submit(tname, waves * per_call, ready)
                continue
            finish = ready
            for _ in range(calls):
                finish = max(finish, sched.submit(tname, per_call, ready))
            ready = finish   # the next operator consumes this one's output
        return sched.makespan

    def op_makespan(self, op: plan_ir.Operator, rows_in: float,
                    tier_name: str, *, batch_size: int = 1,
                    concurrency: int = 16, shards: int = 1,
                    per_tier: Optional[Dict[str, int]] = None,
                    occupancy: Optional[Dict[str, List[float]]] = None,
                    avg_value_tokens: float = 60.0) -> float:
        """Makespan estimate of running ``op`` alone on ``tier_name``
        under the given pool occupancy — the physical optimizer's
        per-candidate latency axis."""
        from repro_torch.core import runtime as rt
        spec = self.tiers[tier_name]
        c = self.op_cost(op, rows_in, spec, avg_value_tokens,
                         batch_size=batch_size)
        sched = rt.EventScheduler(
            concurrency=max(1, int(concurrency)) * max(1, int(shards)),
            per_tier=per_tier)
        sched.seed_occupancy(occupancy)
        calls = int(round(c.llm_calls))
        if calls <= 0:
            return sched.makespan
        per_call = c.latency_s / calls
        if calls > _MAX_REPLAY_CALLS:
            waves = -(-calls // sched.workers(tier_name))
            sched.submit(tier_name, waves * per_call, 0.0)
        else:
            for _ in range(calls):
                sched.submit(tier_name, per_call, 0.0)
        return sched.makespan

    # -- admission control (QueryServer digital twin) --------------------
    def admission_estimate(self, plan: plan_ir.LogicalPlan, n_rows: int, *,
                           occupancy: Optional[Dict[str, List[float]]] = None,
                           default_tier: str = "m*",
                           concurrency: int = 16, batch_size: int = 1,
                           shards: int = 1,
                           avg_value_tokens: float = 60.0) -> float:
        """Predicted makespan (seconds) of running ``plan`` over
        ``n_rows`` rows under the *current* serving load — the admission
        controller's gate. The candidate's calls are replayed onto an
        ``EventScheduler`` seeded with ``occupancy`` (the live
        ``Dispatcher.occupancy()`` snapshot: the simulated driver as a
        free digital twin of the fleet), then scaled by the EWMA
        correction ratio :meth:`observe_makespan` has learned from
        predicted-vs-actual feedback. Per-call latencies inside the
        replay already use the per-(op, tier) calibrated EWMAs, so both
        calibration loops compound."""
        pc = self.plan_cost(plan, n_rows, default_tier=default_tier,
                            avg_value_tokens=avg_value_tokens,
                            concurrency=concurrency, batch_size=batch_size,
                            shards=shards, occupancy=occupancy or {},
                            makespan=True)
        with self._lock:
            ratio = self._adm.ratio if self._adm.n > 0 else 1.0
        return pc.makespan_s * ratio

    def observe_makespan(self, predicted_s: float, measured_s: float
                         ) -> None:
        """Fold one completed query's predicted-vs-actual makespan into
        the admission calibration: the q-error of the prediction we
        *made* (post-correction) and an EWMA update of the correction
        ratio. With corrected = raw * r and k = measured / corrected, the
        ideal ratio is measured / raw = k * r — so the update needs only
        the corrected prediction, not the raw replay value."""
        pred = max(float(predicted_s), 1e-12)
        meas = max(float(measured_s), 1e-12)
        q = _qerror(pred, meas)
        a = self.ewma_alpha
        with self._lock:
            e = self._adm
            e.qerr_last = q
            e.qerr_max = max(e.qerr_max, q)
            e.qerr_ewma = q if e.n == 0 else a * q + (1.0 - a) * e.qerr_ewma
            ideal = (meas / pred) * e.ratio
            e.ratio = ideal if e.n == 0 else a * ideal + (1.0 - a) * e.ratio
            e.n += 1

    def admission_report(self) -> dict:
        """Admission-estimate accuracy snapshot (``--explain-cost``):
        how many makespan predictions have been checked against
        measurements, the learned correction ratio, and the q-error
        trajectory of the corrected predictions."""
        with self._lock:
            e = self._adm
            return {"observations": e.n, "ratio": e.ratio,
                    "qerr_ewma": e.qerr_ewma, "qerr_last": e.qerr_last,
                    "qerr_max": e.qerr_max, "ewma_alpha": self.ewma_alpha}

    # -- online calibration ----------------------------------------------
    def observe(self, meter) -> int:
        """Ingest a finalized meter's call log since this model's last
        cursor for it; returns how many calls were folded in.

        Callers invoke this only at sync points (executor finalize,
        per-query server finalize) where the log is complete for the unit
        of work — never mid-execution. The window is sorted by logical
        call key (``UsageMeter.merge`` semantics) before folding, so the
        EWMA/q-error state is independent of thread arrival order, the
        driver, and the shard count. Idempotent per meter: a second
        observe of the same meter ingests only entries recorded since.

        Fault-tolerance contract: only calls that *produced an answer*
        calibrate. A retried call's successful attempt carries its op
        kind and folds normally under the tier that served it — including
        a breaker/fallback substitution, which bills (and therefore
        calibrates) under the fallback tier's own name, keeping q-error
        state truthful about who actually answered. Failed attempts are
        billed untyped (``op_kind=None`` — e.g. ``testing.FlakyBackend``
        fault entries), so the ``info is None`` skip below excludes them:
        a storm of injected faults never corrupts the latency EWMAs."""
        with meter._lock:
            log = list(meter.call_log)
            keys = list(meter.call_keys)
            ops = list(getattr(meter, "call_ops", ()))
        start = self._cursors.get(meter, 0)
        if start >= len(log):
            return 0
        window = []
        for pos in range(start, len(log)):
            tier_name, lat = log[pos]
            info = ops[pos] if pos < len(ops) else None
            if info is None:
                continue            # untyped call (e.g. rewriter usage)
            kind, tok_out = info
            k = keys[pos] if pos < len(keys) else None
            sort_key = (0, k) if k is not None else (1, (pos,))
            window.append((sort_key, tier_name, kind,
                           float(lat), float(tok_out)))
        try:
            window.sort(key=lambda e: e[0])
        except TypeError:
            # un-comparable key mixture: keep meter position order (still
            # deterministic for single-threaded meters)
            window.sort(key=lambda e: e[0][0])
        a = self.ewma_alpha
        with self._lock:
            for _, tier_name, kind, lat, tok_out in window:
                e = self._cal.setdefault((kind, tier_name), _CalEntry())
                pred = e.latency_s if e.n > 0 \
                    else self._prior_call_latency(kind, tier_name)
                q = _qerror(pred, lat)
                e.qerr_last = q
                e.qerr_max = max(e.qerr_max, q)
                e.qerr_ewma = q if e.n == 0 \
                    else a * q + (1.0 - a) * e.qerr_ewma
                if e.n == 0:
                    # snap-to-first: one observation replaces the prior,
                    # so a single run converges on a stationary backend
                    e.latency_s, e.tok_out = lat, tok_out
                else:
                    e.latency_s = a * lat + (1.0 - a) * e.latency_s
                    e.tok_out = a * tok_out + (1.0 - a) * e.tok_out
                e.n += 1
        self._cursors[meter] = len(log)
        return len(window)

    def qerror_report(self) -> List[dict]:
        """Per-(op kind, tier) calibration rows, sorted by (kind, tier):
        current vs prior prediction, measured EWMAs, and the q-errors of
        both against the measurements. ``qerror`` is what the calibrated
        model is off by *now*; ``prior_qerror`` is what the uncalibrated
        price card would be off by — the gap is what :meth:`observe`
        bought."""
        with self._lock:
            items = sorted(self._cal.items())
            rows = []
            for (kind, tier_name), e in items:
                prior_lat = self._prior_call_latency(kind, tier_name)
                prior_out = self._prior_tok_out(kind)
                pred_lat = e.latency_s if e.n > 0 else prior_lat
                pred_out = e.tok_out if e.n > 0 else prior_out
                rows.append({
                    "op": kind, "tier": tier_name, "calls": e.n,
                    "meas_latency_s": e.latency_s,
                    "pred_latency_s": pred_lat,
                    "prior_latency_s": prior_lat,
                    "meas_tok_out": e.tok_out,
                    "pred_tok_out": pred_out,
                    "prior_tok_out": prior_out,
                    "qerror": _qerror(pred_lat, e.latency_s),
                    "prior_qerror": _qerror(prior_lat, e.latency_s),
                    "tok_qerror": _qerror(pred_out, e.tok_out),
                    "qerr_ewma": e.qerr_ewma,
                    "qerr_last": e.qerr_last,
                    "qerr_max": e.qerr_max,
                    "ewma_alpha": self.ewma_alpha,
                })
        return rows

    def calibration_state(self) -> Dict[Tuple[str, str], tuple]:
        """Canonical snapshot of the EWMA state — byte-comparable across
        runs (the determinism/invariance tests diff exactly this)."""
        with self._lock:
            return {k: (e.n, round(e.latency_s, 12), round(e.tok_out, 12),
                        round(e.qerr_ewma, 12))
                    for k, e in sorted(self._cal.items())}

    def reset_calibration(self) -> None:
        with self._lock:
            self._cal.clear()
            self._adm = _AdmissionCal()
            self._cursors = weakref.WeakKeyDictionary()


# ---------------------------------------------------------------------------
# Hardware-grounded cost (beyond-paper axis)
# ---------------------------------------------------------------------------

def chip_seconds(tok_in: float, tok_out: float, active_params: float,
                 mfu: float = 0.4, peak_flops: float = 197e12) -> float:
    """Approximate chip-seconds to serve the tokens on a TPU v5e chip:
    prefill 2*N*T_in + decode 2*N*T_out FLOPs at `mfu` utilization."""
    flops = 2.0 * active_params * (tok_in + tok_out)
    return flops / (mfu * peak_flops)


# the default instance behind core.cost's deprecated free functions —
# never observed/calibrated implicitly (see module docstring)
DEFAULT_MODEL = CostModel()
