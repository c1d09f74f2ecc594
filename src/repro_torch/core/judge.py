"""Execution-consistency verification with an LLM-as-a-judge (paper §3.1).

Formal equivalence checking does not apply to NL-driven operators, so
Nirvana executes both the original and the rewritten plan on a data sample
and rates the similarity of their outputs. The paper prompts an LLM for a
0-10 rating; here the rating is computed from semantic output comparison
(the Sentence-BERT-style embedder), which keeps the verifier *independent*
of the rewriter — the paper's circular-trust requirement — while remaining
deterministic and measurable.

Rating model (normalized to [0, 1], the plan's `accuracy`):
  both reduce scalars   numeric closeness (relative error), else embedding
                        cosine of the rendered values
  both tables           Jaccard overlap of surviving row ids x mean semantic
                        similarity over columns produced by either plan
  table vs scalar       0.0

Judge failures are *emergent*, exactly the paper's two causes (§5.3.5): low
sample coverage (a sample may miss the rows where a corrupted predicate
diverges) and vague operator outputs (close-but-wrong map outputs clear the
embedding threshold). Table 7 measures both.

Every verification is also costed as one judge-LLM call (prompt = both
plans' rendered outputs), so optimizer-overhead accounting includes it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import backends as bk
from repro_torch.core import cost as cost_mod
from repro_torch.core import cost_model
from repro_torch.core import executor as ex
from repro_torch.core import plan as plan_ir
from repro_torch.core import runtime as rt
from repro_torch.core import semhash
from repro_torch.core.table import Table


@dataclasses.dataclass
class JudgeResult:
    rating: float                # in [0,1]; plan accuracy estimate
    usage: bk.Usage              # judge-call cost (one LLM rating call)
    detail: str = ""


def _scalar_similarity(a, b) -> float:
    na, nb = cost_mod.text_tokens(a), cost_mod.text_tokens(b)  # noqa: F841
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        if a == b:
            return 1.0
        scale = max(abs(float(a)), abs(float(b)), 1e-9)
        return float(max(0.0, 1.0 - abs(float(a) - float(b)) / scale))
    if a is None or b is None:
        return 1.0 if a is b else 0.0
    return float(np.dot(semhash.embed_one(a), semhash.embed_one(b)))


def _table_similarity(ta: Table, tb: Table, produced_cols) -> float:
    ids_a = set(ta.columns.get(ex.ROWID, []))
    ids_b = set(tb.columns.get(ex.ROWID, []))
    union = ids_a | ids_b
    if not union:
        return 1.0  # both empty — consistent
    jacc = len(ids_a & ids_b) / len(union)
    shared = sorted(ids_a & ids_b)
    if not shared or not produced_cols:
        return jacc
    pos_a = {r: i for i, r in enumerate(ta.columns[ex.ROWID])}
    pos_b = {r: i for i, r in enumerate(tb.columns[ex.ROWID])}
    sims = []
    for col in produced_cols:
        if col not in ta.columns or col not in tb.columns:
            continue
        xs = [ta.columns[col][pos_a[r]] for r in shared]
        ys = [tb.columns[col][pos_b[r]] for r in shared]
        s = semhash.pairwise_similarity(
            [str(x) for x in xs], [str(y) for y in ys])
        sims.append(float(np.mean(s)) if len(s) else 1.0)
    col_sim = float(np.mean(sims)) if sims else 1.0
    return jacc * col_sim


@dataclasses.dataclass
class Judge:
    """Rates semantic consistency between a rewritten plan and the original
    by execution consistency on a sample (Alg. 1's ``evaluate``).

    Sample executions share an :class:`executor.OutputCache` across
    ratings: the original plan is billed once, and rewritten plans only pay
    for operators the rewrite actually changed. Both sample executions of a
    rating run against **one** dispatcher, so they share the same worker
    pool (the paper's 16 coroutines serve the verifier too) — simulated or
    real threads, per the context's ``driver`` — instead of being
    accounted back-to-back. The context's ``batch_size``/``coalesce``/
    ``linger_s`` flow through unchanged, so with batching enabled each
    sample run packs its morsels through a ``runtime.BatchCoalescer`` and
    the verifier pays coalesced (not per-morsel) call counts."""
    backends: "Dict[str, bk.Backend] | rt.ExecutionContext"
    judge_tier: str = "m*"          # the tier priced for the rating call
    exec_tier: str = "m*"           # backend used to execute sample plans
    concurrency: int = 16

    def __post_init__(self):
        if isinstance(self.backends, rt.ExecutionContext):
            # a caller-built context wins over the field defaults
            self.ctx = self.backends.fork(cache=ex.OutputCache())
            self.exec_tier = self.ctx.default_tier
            self.concurrency = self.ctx.concurrency
        else:
            self.ctx = rt.ExecutionContext(
                backends=self.backends, default_tier=self.exec_tier,
                concurrency=self.concurrency, cache=ex.OutputCache())
        self.cache = self.ctx.cache

    def rate(self, original: plan_ir.LogicalPlan,
             rewritten: plan_ir.LogicalPlan, sample: Table,
             meter: Optional[bk.UsageMeter] = None) -> JudgeResult:
        meter = meter if meter is not None else bk.UsageMeter()
        rctx = self.ctx.fork(meter=meter)
        disp = rctx.make_dispatcher()
        try:
            ra = ex.execute(original, sample, rctx, dispatcher=disp)
            rb = ex.execute(rewritten, sample, rctx, dispatcher=disp)
            exec_wall = disp.wall_s
        finally:
            disp.close()

        # compare by the *declared* result kind: an unanswerable reduce
        # yields scalar=None yet is still a scalar-valued query
        if ra.is_reduce != rb.is_reduce:
            rating, detail = 0.0, "result-kind mismatch"
        elif ra.is_reduce:
            rating = _scalar_similarity(ra.scalar, rb.scalar)
            detail = f"scalar {ra.scalar!r} vs {rb.scalar!r}"
        else:
            produced = {c for op in original.ops for c in op.writes} | \
                       {c for op in rewritten.ops for c in op.writes}
            rating = _table_similarity(ra.table, rb.table, sorted(produced))
            detail = (f"rows {ra.table.n_rows} vs {rb.table.n_rows}")

        # the rating itself is one judge-LLM call over both rendered
        # outputs, priced by the context's cost model (tiers + the judge
        # prompt-length rule live there so a calibrated serve re-prices it)
        model = self.ctx.cost_model or cost_model.DEFAULT_MODEL
        tier = model.tiers[self.judge_tier]
        tok_in = model.judge_tokens(sample.n_rows)
        usage = bk.Usage(calls=1, tok_in=tok_in, tok_out=4.0,
                         usd=tier.usd(tok_in, 4.0),
                         latency_s=tier.latency(4.0))
        meter.record(self.judge_tier, usage, op_kind="judge")
        # execution + judging both contribute to verification wall-clock;
        # the shared dispatcher's wall covers both sample runs (modeled
        # makespan under the simulated driver, measured under threads)
        usage_total = bk.Usage(calls=usage.calls, tok_in=usage.tok_in,
                               tok_out=usage.tok_out, usd=usage.usd,
                               latency_s=usage.latency_s + exec_wall)
        return JudgeResult(rating=float(max(0.0, min(1.0, rating))),
                           usage=usage_total, detail=detail)
