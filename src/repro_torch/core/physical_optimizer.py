"""Cost-aware physical plan optimizer — paper §4, Algorithm 2.

Assigns the most cost-effective backend tier to every LLM operator of a
logical plan. Per operator: compute improvement scores I_{m1->m} over a
data sample (estimator selectable: exact / pushdown / reuse / approx — the
paper's headline configuration is `approx`, Eqs. 6-8), then upgrade from
the cheapest tier m1 only while the *marginal* improvement clears the
user's margin dI_min.

The sample flows through the plan operator-by-operator with the already-
selected backends (matching the paper's optimize-then-execute pipeline in
Fig. 4), so downstream operators are scored on realistic inputs.

Batch awareness: with ``ctx.batch_size > 1`` the scoring sweeps batch
records the way coalesced execution will — an operator's evaluation on a
tier costs ``ceil(sample / batch_size)`` calls (not one call per record),
and the improvement scores reflect the batch-prompting accuracy penalty —
so both the tier choice and the reported optimization overhead match the
batched execution the plan is headed for.

Sync vs async (Table 9): every backend call lands in the meter's call log
and runs through the context's dispatcher (``runtime.Dispatcher``). Under
the simulated driver, ``async`` places each operator's scoring calls
concurrently on per-tier event-scheduler pools with a barrier before the
next operator (its sample input depends on this operator's output) and
``sync`` collapses all tiers onto one worker, i.e. the sequential sum.
Under ``driver="threads"`` the scoring calls of one operator run
concurrently *for real* on the tier worker pools and ``opt_wall_s`` is
measured wall time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import backends as bk
from repro_torch.core import cascade as casc_mod
from repro_torch.core import cost_model as cm
from repro_torch.core import executor as ex
from repro_torch.core import improvement as imp
from repro_torch.core import plan as plan_ir
from repro_torch.core import runtime as rt
from repro_torch.core.table import Table


@dataclasses.dataclass
class PhysicalOptConfig:
    delta_min: float = 0.20        # improvement margin (paper §5.1.4: 20%)
    sample_ratio: float = 0.05
    sample_min: int = 8
    sample_max: int = 64
    estimator: str = "approx"      # exact | pushdown | reuse | approx
    max_cond_eval: int = 16        # bound conditional-term evaluations
    # None = inherit from the ExecutionContext (16 / "async" for bare dicts)
    concurrency: Optional[int] = None   # async worker count
    mode: Optional[str] = None          # sync | async
    seed: int = 0
    # band slack around the capability sample's class boundaries when
    # calibrating a tier-0 cascade (ctx.cascade is set): larger margins
    # escalate more rows
    cascade_margin: float = 0.02
    # cost x makespan weight for tier selection; None = inherit from the
    # context's CostModel (the library default model's weight is 0, which
    # reproduces pure improvement-margin selection exactly)
    latency_weight: Optional[float] = None


@dataclasses.dataclass
class PhysicalOptResult:
    plan: plan_ir.LogicalPlan               # with tiers assigned
    assignments: Dict[int, str]             # op index -> tier
    scores: Dict[int, Dict[str, float]]     # op index -> improvement scores
    meter: bk.UsageMeter                    # optimization-phase usage
    opt_wall_s: float
    # op index -> adopted cascade calibration (bands + sample agreement /
    # resolved-fraction / improvement stats); empty without ctx.cascade
    cascades: Dict[int, dict] = dataclasses.field(default_factory=dict)


def select_tier(scores: Dict[str, float], delta_min: float,
                order=("m2", "m3", "m*"),
                penalty: Optional[Dict[str, float]] = None) -> str:
    """Algorithm 2's greedy upgrade: start at m1, upgrade tier-by-tier while
    the marginal improvement I_curr - I_last exceeds the margin.

    ``penalty`` (scheduler-aware mode) charges each candidate a
    cost x makespan handicap in improvement-score units: an upgrade must
    clear ``delta_min`` *plus* the candidate's penalty increase over the
    incumbent. ``None`` (the default, and always the case at
    ``latency_weight=0``) is byte-identical to the classic walk."""
    chosen, i_last = "m1", 0.0
    for m in order:
        i_curr = scores[m]
        need = delta_min
        if penalty is not None:
            need += penalty.get(m, 0.0) - penalty.get(chosen, 0.0)
        if i_curr - i_last >= need:
            chosen, i_last = m, i_curr
    return chosen


def optimize(plan: plan_ir.LogicalPlan, table: Table,
             backends: "Dict[str, bk.Backend] | rt.ExecutionContext",
             cfg: PhysicalOptConfig = PhysicalOptConfig(),
             dispatcher: Optional[rt.Dispatcher] = None
             ) -> PhysicalOptResult:
    ctx = rt.as_context(backends)
    n_sample = min(max(int(table.n_rows * cfg.sample_ratio), cfg.sample_min),
                   cfg.sample_max, table.n_rows)
    sample = ex.with_rowids(table.sample(n_sample, seed=cfg.seed))

    meter = bk.UsageMeter()        # optimization-phase accounting only
    owns_dispatcher = dispatcher is None
    if dispatcher is None:
        over = {k: v for k, v in (("concurrency", cfg.concurrency),
                                  ("mode", cfg.mode)) if v is not None}
        dispatcher = ctx.fork(**over).make_dispatcher() if over \
            else ctx.make_dispatcher()
    try:
        return _optimize(plan, sample, ctx, cfg, meter, dispatcher,
                         n_rows=table.n_rows)
    finally:
        if owns_dispatcher:
            dispatcher.close()


def _tier_penalty(model, op, n_rows, ctx, disp,
                  weight: float) -> Optional[Dict[str, float]]:
    """Scheduler-aware handicap per candidate tier, in improvement-score
    units: each tier's full-table USD and makespan (event-scheduler replay
    seeded with the dispatcher's current pool occupancy, so a busy tier
    looks slower than an idle one), normalized by the worst candidate and
    scaled by ``weight``. At weight 0 there is no penalty (None) and
    ``select_tier`` runs its classic walk."""
    if weight <= 0:
        return None
    occ = disp.occupancy() if disp is not None else {}
    usd: Dict[str, float] = {}
    mk: Dict[str, float] = {}
    for m in cm.TIER_ORDER:
        if m not in model.tiers:
            continue
        c = model.op_cost(op, float(n_rows), model.tiers[m],
                          batch_size=ctx.batch_size)
        usd[m] = c.usd
        mk[m] = model.op_makespan(
            op, float(n_rows), m, batch_size=ctx.batch_size,
            concurrency=ctx.concurrency, shards=ctx.shards,
            per_tier=ctx.per_tier_concurrency, occupancy=occ)
    umax = max(usd.values()) or 1.0
    mmax = max(mk.values()) or 1.0
    return {m: weight * 0.5 * (usd[m] / umax + mk[m] / mmax)
            for m in usd}


def _optimize(plan, sample, ctx, cfg, meter, disp,
              n_rows: Optional[int] = None) -> PhysicalOptResult:
    cursor = 0
    assignments: Dict[int, str] = {}
    all_scores: Dict[int, Dict[str, float]] = {}
    cascades: Dict[int, dict] = {}
    model = ctx.cost_model or cm.DEFAULT_MODEL
    weight = cfg.latency_weight if cfg.latency_weight is not None \
        else model.latency_weight
    if n_rows is None:
        n_rows = sample.n_rows

    cur = sample
    for k, op in enumerate(plan.ops):
        if cur.n_rows == 0:
            if op.is_llm:
                assignments[k] = "m1"
            continue
        values = cur.resolve(op.input_column)
        if op.is_llm:
            # batch-aware scoring: sweeps run (and are priced) at the
            # context's batch size — ceil(sample/batch) calls per tier
            # instead of per-record ceilings, and the scores see the batch
            # accuracy penalty the execution will actually pay. The store
            # is built here (not inside improvement_scores) so cascade
            # calibration below reuses the sampled tier outputs.
            store = imp.OutputStore(ctx.backends, op, values, meter=meter,
                                    dispatcher=disp,
                                    batch_size=ctx.batch_size)
            if cfg.estimator == "approx":
                res = imp.improvement_approx(
                    store, max_cond_eval=cfg.max_cond_eval)
            else:
                res = imp.ESTIMATORS[cfg.estimator](store)
            tier = select_tier(res.scores, cfg.delta_min,
                               penalty=_tier_penalty(model, op, n_rows,
                                                     ctx, disp, weight))
            assignments[k] = tier
            all_scores[k] = dict(res.scores)
            adopted = _calibrate_cascade(ctx, cfg, op, values, store, tier,
                                         meter)
            if adopted is not None:
                cascades[k] = adopted
            # scoring calls for one operator run as one concurrent stage
            # (simulated driver: drain + barrier; threads: already real)
            cursor = disp.checkpoint(meter, cursor)
        # flow the sample forward using the chosen tier (or the UDF)
        cur = _apply_op(op, cur, values, ctx,
                        assignments.get(k, "m1"), meter, disp)
        cursor = disp.checkpoint(meter, cursor)
        # ^ the next operator consumes this one's output

    tiered = plan.with_tiers(assignments)
    return PhysicalOptResult(plan=tiered, assignments=assignments,
                             scores=all_scores, meter=meter,
                             opt_wall_s=disp.wall_s, cascades=cascades)


def _calibrate_cascade(ctx, cfg, op, values, store, tier, meter):
    """Calibrate tier-0 cascade bands for one operator from the capability
    sample and adopt them onto ``ctx.cascade`` when the cascade clears the
    improvement-score gate.

    The embedding pass over the sample bills into the optimizer's meter
    under ``tier0-embed`` (cascade calibration is optimization overhead,
    like every other scoring sweep). SEM_FILTER bands are adopted only if
    the resolved sample rows' disagreement with the selected tier stays
    within ``delta_min`` — the same margin Algorithm 2 applies between
    tiers; RANK bands (middle-quartile escalation) only need a non-empty
    resolved tail. Returns the adopted calibration record, or None."""
    router = ctx.cascade
    if (router is None or op.udf is not None
            or op.kind not in router.KINDS):
        return None
    cscores = router.backend.run_values(op, values, meter=meter,
                                        batch_size=max(1, len(values)))
    all_i = list(range(store.n))
    store.ensure(tier, all_i)
    ref_outs = [store.out(tier, i) for i in all_i]
    bands = casc_mod.calibrate_bands(cscores, ref_outs, op.kind,
                                     margin=cfg.cascade_margin)
    if bands is None:
        return None
    if op.kind == plan_ir.FILTER:
        decisions = {i: True for i, s in enumerate(cscores)
                     if s >= bands.hi}
        decisions.update({i: False for i, s in enumerate(cscores)
                          if s <= bands.lo})
        stats = imp.improvement_cascade(store, tier, decisions)
        if not decisions or (1.0 - stats["agree"]) > cfg.delta_min:
            return None
    else:
        resolved = sum(1 for s in cscores
                       if s >= bands.hi or s <= bands.lo)
        if resolved == 0:
            return None
        stats = {"agree": None, "resolved": resolved / len(cscores),
                 "improvement": None}
    router.set_bands(op, bands)
    return {"bands": (bands.lo, bands.hi), **stats}


def _apply_op(op: plan_ir.Operator, table: Table, values,
              ctx: rt.ExecutionContext, tier: str,
              meter: bk.UsageMeter,
              dispatcher: Optional[rt.Dispatcher] = None) -> Table:
    """Advance the optimizer's sample through one operator (shared
    ``runtime`` apply path — same UDF safety and bool-mask parsing as the
    executor, and the *same accounting*: calls bill under the backend's own
    tier name and honor the context's batch size and output cache, so
    optimizer-phase usage is directly comparable to execution-phase usage)."""
    if op.udf is not None:
        table, _ = rt.run_udf_op(op, table, values)
        return table
    backend = ctx.backends[tier]
    fan = dispatcher.fanout(backend.tier.name) \
        if dispatcher is not None else None
    outs, _, _ = rt.run_llm_op(op, values, backend, backend.tier.name,
                               meter, batch_size=ctx.batch_size,
                               cache=ctx.cache, fanout=fan)
    table, _ = rt.apply_outputs(op, table, outs)
    return table


# ---------------------------------------------------------------------------
# Smart [13] comparison baselines (Table 9): single-operator model selection
# without pushdown/reuse/approx, in three flavours.
# ---------------------------------------------------------------------------

def smart_select(op: plan_ir.Operator, values,
                 backends: Dict[str, bk.Backend], delta_min: float,
                 variant: str = "exhaustive",
                 meter: Optional[bk.UsageMeter] = None):
    """Smart-style selection for one operator.

    exhaustive   every tier runs the full sample; exact Eq.-2 scores
    efficient    early-exits the tier loop once a tier clears the margin
    multi-model  splits records among tiers (mixed-integer-ish heuristic):
                 each tier runs a 1/|M| slice plus m* on everything
    """
    meter = meter if meter is not None else bk.UsageMeter()
    store = imp.OutputStore(backends, op, values, meter=meter)
    n = store.n
    idx = list(range(n))
    if variant == "exhaustive":
        res = imp.improvement_exact(store)
        return select_tier(res.scores, delta_min), res.scores, meter
    if variant == "efficient":
        store.ensure("m1", idx)
        store.ensure("m*", idx)
        scores = {}
        chosen, i_last = "m1", 0.0
        for m in ("m2", "m3", "m*"):
            store.ensure(m, idx)
            s = sum(store.eq(m, "m*", i) and not store.eq("m1", m, i)
                    for i in idx) / n if m != "m*" else \
                sum(not store.eq("m1", "m*", i) for i in idx) / n
            scores[m] = s
            if s - i_last >= delta_min:
                chosen, i_last = m, s
                break   # early exit: first sufficient tier wins
        for m in ("m2", "m3", "m*"):
            scores.setdefault(m, 0.0)
        return chosen, scores, meter
    # multi-model
    store.ensure("m*", idx)
    scores = {}
    k = max(1, n // 3)
    slices = {"m2": idx[:k], "m3": idx[k:2 * k], "m*": idx}
    for m, sl in slices.items():
        if m == "m*":
            scores[m] = sum(not store.eq("m1", "m*", i) for i in idx) / n
            continue
        store.ensure(m, sl)
        store.ensure("m1", sl)
        scores[m] = (sum(store.eq(m, "m*", i) and not store.eq("m1", m, i)
                         for i in sl) / max(1, len(sl)))
    return select_tier(scores, delta_min), scores, meter
