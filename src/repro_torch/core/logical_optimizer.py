"""Agentic logical plan optimizer — paper §3, Algorithm 1.

Random-walk tree search over semantically-equivalent plans:

  1. sample a plan from the candidate set with Eq. 1's mixture probability
     Pr(p_i) = lam * 1/|P| + (1-lam) * softmax(cost_max - cost)_i
  2. rewrite it (LLM-sim / greedy-rule / local-model rewriter)
  3. verify by execution consistency on a data sample (LLM-as-a-judge) and
     estimate cost with the selectivity cost model
  4. accept iff accuracy >= epsilon and cost <= parent's cost

Returns the lowest-cost accepted plan plus the full search trace (the tree
of Fig. 3), and meters every LLM call the optimizer itself made — rewriter
calls, sample executions, judge ratings — so optimization overhead is a
first-class output (Tables 6 & 8; Fig. 9 breakdown).

Beam-search variant (App. D) included for the comparison benchmark.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence

from repro_torch.core import backends as bk
from repro_torch.core import cost_model
from repro_torch.core import judge as judge_mod
from repro_torch.core import plan as plan_ir
from repro_torch.core import rewriter as rw
from repro_torch.core import runtime as rt
from repro_torch.core.table import Table


@dataclasses.dataclass
class Candidate:
    plan: plan_ir.LogicalPlan
    cost: float
    acc: float
    parent: Optional[int]           # index into OptResult.candidates
    rule: str = ""
    accepted: bool = True
    judge_detail: str = ""
    rewrite_correct: Optional[bool] = None  # ground truth (Table 7 scoring)


@dataclasses.dataclass
class OptResult:
    best: plan_ir.LogicalPlan
    best_cost: float
    initial_cost: float
    candidates: List[Candidate]
    meter: bk.UsageMeter            # optimization-phase usage only
    opt_wall_s: float               # simulated optimizer wall-clock
    n_iterations: int

    @property
    def accepted_set(self) -> List[Candidate]:
        return [c for c in self.candidates if c.accepted]


@dataclasses.dataclass
class LogicalOptConfig:
    n_iterations: int = 3           # N_max (paper §5.1.4)
    epsilon: float = 0.8            # error tolerance
    lam: float = 0.2                # Eq. 1 exploration weight
    sample_ratio: float = 0.05
    sample_min: int = 8
    sample_max: int = 24            # verification sample cap — execution-
                                    # consistency needs far fewer rows than
                                    # the physical optimizer's scoring
    # None = inherit from the ExecutionContext (16 / "m*" for bare dicts)
    concurrency: Optional[int] = None
    default_tier: Optional[str] = None
    seed: int = 0


def sample_probabilities(costs: Sequence[float], lam: float) -> List[float]:
    """Eq. 1. Costs are normalized by cost_max so the softmax temperature is
    scale-free (USD costs span orders of magnitude across datasets)."""
    n = len(costs)
    cmax = max(costs)
    scale = max(cmax, 1e-12)
    ws = [math.exp((cmax - c) / scale) for c in costs]
    z = sum(ws)
    return [lam / n + (1.0 - lam) * w / z for w in ws]


def _cfg_context(backends, cfg: LogicalOptConfig) -> rt.ExecutionContext:
    """Context for candidate evaluation: explicit cfg fields win, otherwise
    inherit from a caller-supplied ExecutionContext."""
    over = {}
    if cfg.default_tier is not None:
        over["default_tier"] = cfg.default_tier
    if cfg.concurrency is not None:
        over["concurrency"] = cfg.concurrency
    return rt.as_context(backends, **over)


def optimize(plan: plan_ir.LogicalPlan, table: Table,
             backends: "Dict[str, bk.Backend] | rt.ExecutionContext",
             rewriter=None,
             cfg: LogicalOptConfig = LogicalOptConfig()) -> OptResult:
    rng = random.Random(cfg.seed)
    rewriter = rewriter or rw.LLMSimRewriter()
    ctx = _cfg_context(backends, cfg)
    judge = judge_mod.Judge(ctx)   # candidate evaluation shares the context
    n_sample = min(max(int(table.n_rows * cfg.sample_ratio), cfg.sample_min),
                   cfg.sample_max, table.n_rows)
    sample = table.sample(n_sample, seed=cfg.seed)

    meter = bk.UsageMeter()
    wall = 0.0

    model = ctx.cost_model or cost_model.DEFAULT_MODEL

    def plan_cost_of(p: plan_ir.LogicalPlan) -> float:
        # batch-aware: candidate costs price ceil(rows/batch) coalesced
        # calls, so rewrites are judged at the batch size they will run
        # at. The context's CostModel supplies the (possibly calibrated)
        # estimates and the objective — pure USD at latency_weight=0,
        # USD + makespan-equivalent otherwise.
        return model.objective(model.plan_cost(
            p, table.n_rows, default_tier=ctx.default_tier,
            concurrency=ctx.concurrency, batch_size=ctx.batch_size,
            shards=ctx.shards))

    c0 = plan_cost_of(plan)
    cands: List[Candidate] = [Candidate(plan, c0, 1.0, None, "init")]
    accepted = [0]

    for _ in range(cfg.n_iterations):
        probs = sample_probabilities([cands[i].cost for i in accepted],
                                     cfg.lam)
        pick = rng.choices(accepted, weights=probs, k=1)[0]
        parent = cands[pick]

        outcome = rewriter.rewrite(parent.plan, rng)
        meter.record("rewriter", outcome.usage)
        wall += outcome.usage.latency_s
        if outcome.plan is None:
            continue
        if outcome.plan.signature() == parent.plan.signature():
            continue
        if any(outcome.plan.signature() == c.plan.signature()
               for c in cands):
            continue

        jr = judge.rate(plan, outcome.plan, sample, meter=meter)
        wall += jr.usage.latency_s
        cost_new = plan_cost_of(outcome.plan)
        ok = jr.rating >= cfg.epsilon and cost_new <= parent.cost
        cand = Candidate(outcome.plan, cost_new, jr.rating, pick,
                         outcome.rewrite.rule, accepted=ok,
                         judge_detail=jr.detail,
                         rewrite_correct=outcome.rewrite.correct)
        cands.append(cand)
        if ok:
            accepted.append(len(cands) - 1)

    best_i = min(accepted, key=lambda i: cands[i].cost)
    return OptResult(best=cands[best_i].plan, best_cost=cands[best_i].cost,
                     initial_cost=c0, candidates=cands, meter=meter,
                     opt_wall_s=wall, n_iterations=cfg.n_iterations)


# ---------------------------------------------------------------------------
# App. D: beam-search comparison baseline
# ---------------------------------------------------------------------------

def optimize_beam(plan: plan_ir.LogicalPlan, table: Table,
                  backends: "Dict[str, bk.Backend] | rt.ExecutionContext",
                  rewriter=None,
                  cfg: LogicalOptConfig = LogicalOptConfig(),
                  beam_width: int = 2) -> OptResult:
    """Expands the `beam_width` lowest-cost plans every step (the App.-D
    baseline: ~2x the optimization cost at similar end-to-end quality)."""
    rng = random.Random(cfg.seed)
    rewriter = rewriter or rw.LLMSimRewriter()
    ctx = _cfg_context(backends, cfg)
    judge = judge_mod.Judge(ctx)
    n_sample = min(max(int(table.n_rows * cfg.sample_ratio), cfg.sample_min),
                   cfg.sample_max, table.n_rows)
    sample = table.sample(n_sample, seed=cfg.seed)

    meter = bk.UsageMeter()
    wall = 0.0

    model = ctx.cost_model or cost_model.DEFAULT_MODEL

    def plan_cost_of(p):
        return model.objective(model.plan_cost(
            p, table.n_rows, default_tier=ctx.default_tier,
            concurrency=ctx.concurrency, batch_size=ctx.batch_size,
            shards=ctx.shards))

    c0 = plan_cost_of(plan)
    cands: List[Candidate] = [Candidate(plan, c0, 1.0, None, "init")]
    accepted = [0]

    for _ in range(cfg.n_iterations):
        beam = sorted(accepted, key=lambda i: cands[i].cost)[:beam_width]
        for pick in beam:
            parent = cands[pick]
            outcome = rewriter.rewrite(parent.plan, rng)
            meter.record("rewriter", outcome.usage)
            wall += outcome.usage.latency_s
            if outcome.plan is None:
                continue
            if any(outcome.plan.signature() == c.plan.signature()
                   for c in cands):
                continue
            jr = judge.rate(plan, outcome.plan, sample, meter=meter)
            wall += jr.usage.latency_s
            cost_new = plan_cost_of(outcome.plan)
            ok = jr.rating >= cfg.epsilon and cost_new <= parent.cost
            cand = Candidate(outcome.plan, cost_new, jr.rating, pick,
                             outcome.rewrite.rule, accepted=ok,
                             judge_detail=jr.detail,
                             rewrite_correct=outcome.rewrite.correct)
            cands.append(cand)
            if ok:
                accepted.append(len(cands) - 1)

    best_i = min(accepted, key=lambda i: cands[i].cost)
    return OptResult(best=cands[best_i].plan, best_cost=cands[best_i].cost,
                     initial_cost=c0, candidates=cands, meter=meter,
                     opt_wall_s=wall, n_iterations=cfg.n_iterations)
