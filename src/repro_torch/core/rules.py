"""Transformation rules for the logical optimizer (paper §3.2).

Three rules, exactly the paper's set, each expressed both as natural
language (the ``nl`` attribute — what the paper feeds its LLM rewriter) and
as a verified plan transformation:

  filter pushdown      move a filter that does not rely on results of
                       preceding operators to an earlier stage
  operator fusion      merge operators on the same field into one (predicates
                       conjoined; fused-filter selectivity 0.5/k)
  non-LLM replacement  swap an operator's NL instruction for an equivalent
                       compute function (repro_torch.core.udf)

plus the filter re-ordering the paper's case study applies (Fig. 11a:
"randomly reorders two filter operators, as the optimizer has no knowledge
of their selectivities").

Every applicable (rule, site) pair yields a :class:`Rewrite` whose
``apply()`` returns the new plan. ``corrupt()`` produces a *semantically
wrong* variant of a rewrite — the controlled error source used to measure
LLM-as-a-judge reliability (paper Table 7): rewriters in `llm_sim` mode
emit corrupted rewrites at a configurable rate, and the benchmark scores
the judge's accept/reject decisions against the known `correct` flag.
"""
from __future__ import annotations

import dataclasses
import random
import re
from typing import Callable, List, Optional

from repro_torch.core import plan as plan_ir
from repro_torch.core import udf as udf_mod


@dataclasses.dataclass
class Rewrite:
    rule: str
    description: str
    apply: Callable[[], plan_ir.LogicalPlan]
    correct: bool = True      # ground truth (hidden from the judge)


# ---------------------------------------------------------------------------
# Rule: filter pushdown
# ---------------------------------------------------------------------------

NL_FILTER_PUSHDOWN = (
    "Move a filter operator that does not rely on results of preceding "
    "operators to an earlier stage in the plan.")


def filter_pushdown_candidates(plan: plan_ir.LogicalPlan) -> List[Rewrite]:
    out = []
    for i, op in enumerate(plan.ops):
        if op.kind != plan_ir.FILTER:
            continue
        earliest = plan.movable_before(i)
        if earliest >= i:
            continue
        # only worthwhile if it jumps at least one LLM op (prunes rows early)
        crossed = plan.ops[earliest:i]
        if not any(o.is_llm for o in crossed):
            continue
        out.append(Rewrite(
            "filter_pushdown",
            f"push filter@{i} ({op.instruction!r}) to position {earliest}",
            lambda i=i, earliest=earliest: plan.move_op(i, earliest)))
    return out


# ---------------------------------------------------------------------------
# Rule: filter re-ordering (selectivity-blind random swap, Fig. 11a)
# ---------------------------------------------------------------------------

NL_FILTER_REORDER = (
    "Reorder two adjacent independent filter operators (their relative "
    "selectivities are unknown to the optimizer).")


def filter_reorder_candidates(plan: plan_ir.LogicalPlan) -> List[Rewrite]:
    out = []
    for i in range(len(plan.ops) - 1):
        a, b = plan.ops[i], plan.ops[i + 1]
        if (a.kind == plan_ir.FILTER and b.kind == plan_ir.FILTER
                and not plan.depends_on(i + 1, i)):
            out.append(Rewrite(
                "filter_reorder",
                f"swap filters @{i} and @{i + 1}",
                lambda i=i: plan.move_op(i + 1, i)))
    return out


# ---------------------------------------------------------------------------
# Rule: operator fusion
# ---------------------------------------------------------------------------

NL_OPERATOR_FUSION = (
    "Merge multiple operators applied to the same field into one operator, "
    "rewriting the predicate so semantics are preserved (e.g. two filters "
    "'higher than 8.5' and 'lower than 9' become one filter 'higher than "
    "8.5 and lower than 9').")


def _fuse_instructions(a: str, b: str) -> str:
    a = a.strip().rstrip(".")
    b = b.strip().rstrip(".")
    # drop a repeated subject for readability: "The rating is higher than
    # 8.5" + "The rating is lower than 9" -> "... higher than 8.5 and lower
    # than 9"
    m_a = re.match(r"(.*?\bis\b)\s+(.*)", a, re.I)
    m_b = re.match(r"(.*?\bis\b)\s+(.*)", b, re.I)
    if m_a and m_b and m_a.group(1).lower() == m_b.group(1).lower():
        return f"{m_a.group(1)} {m_a.group(2)} and {m_b.group(2)}."
    return f"{a} and {b}."


def operator_fusion_candidates(plan: plan_ir.LogicalPlan) -> List[Rewrite]:
    out = []
    for i in range(len(plan.ops)):
        a = plan.ops[i]
        if a.kind != plan_ir.FILTER or not a.is_llm:
            continue
        for j in range(i + 1, len(plan.ops)):
            b = plan.ops[j]
            if plan.depends_on(j, i) and b.kind != plan_ir.FILTER:
                break
            if (b.kind == plan_ir.FILTER and b.is_llm
                    and b.input_column == a.input_column
                    # b must be free to slide up to i
                    and plan.movable_before(j) <= i + 1):
                fused = a.with_(
                    instruction=_fuse_instructions(a.instruction,
                                                   b.instruction),
                    fused_from=a.fused_from + b.fused_from,
                    selectivity=None)
                out.append(Rewrite(
                    "operator_fusion",
                    f"fuse filters @{i} + @{j} on column "
                    f"{a.input_column!r}",
                    lambda i=i, j=j, fused=fused: plan.fuse_ops(i, j, fused)))
    return out


# ---------------------------------------------------------------------------
# Rule: non-LLM replacement
# ---------------------------------------------------------------------------

NL_NON_LLM_REPLACEMENT = (
    "Replace an operator's natural-language instruction with an equivalent "
    "compute function (UDF) when the instruction can be interpreted as a "
    "deterministic computation, e.g. 'Score is higher than 8.5 and lower "
    "than 9' -> lambda x: 8.5 < parse_number(x) < 9.")


def non_llm_candidates(plan: plan_ir.LogicalPlan) -> List[Rewrite]:
    out = []
    for i, op in enumerate(plan.ops):
        if not op.is_llm:
            continue
        compiled = udf_mod.compile_udf(op)
        if compiled is None:
            continue
        out.append(Rewrite(
            "non_llm_replacement",
            f"replace LLM op@{i} with UDF {compiled.source!r}",
            lambda i=i, src=compiled.source:
                plan.replace_op(i, plan.ops[i].with_(udf=src))))
    return out


# ---------------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------------

RULES = {
    "filter_pushdown": (NL_FILTER_PUSHDOWN, filter_pushdown_candidates),
    "filter_reorder": (NL_FILTER_REORDER, filter_reorder_candidates),
    "operator_fusion": (NL_OPERATOR_FUSION, operator_fusion_candidates),
    "non_llm_replacement": (NL_NON_LLM_REPLACEMENT, non_llm_candidates),
}

# the subset the paper calls "semantic-aware" (Table 8 ablation)
SEMANTIC_RULES = ("non_llm_replacement",)
BASIC_RULES = ("filter_pushdown", "filter_reorder", "operator_fusion")


def all_candidates(plan: plan_ir.LogicalPlan,
                   rules: Optional[tuple] = None) -> List[Rewrite]:
    names = rules if rules is not None else tuple(RULES)
    out = []
    for name in names:
        _, fn = RULES[name]
        out.extend(fn(plan))
    return out


# ---------------------------------------------------------------------------
# Controlled corruption (for judge-reliability measurement)
# ---------------------------------------------------------------------------

def corrupt(rewrite: Rewrite, plan: plan_ir.LogicalPlan,
            rng: random.Random) -> Rewrite:
    """Return a semantically WRONG variant of `rewrite` — models the LLM
    rewriter hallucinating. Corruption modes mirror the paper's observed
    failures (Fig. 12b): off-by-constant UDF boundaries, dropped conjuncts,
    filters pushed past the map that produces their input."""
    def bad_apply(rewrite=rewrite):
        new = rewrite.apply()
        ops = list(new.ops)
        # pick an op to damage, preferring ones the rewrite touched
        idxs = [k for k, (o_new) in enumerate(ops)]
        rng.shuffle(idxs)
        for k in idxs:
            op = ops[k]
            if op.udf and re.search(r"\d", op.udf):
                # perturb the first numeric constant in the UDF (keeping
                # int-ness so e.g. list indices stay valid python)
                def bump(m):
                    delta = rng.choice((-1, 1))
                    if "." in m.group(0):
                        return str(float(m.group(0)) + delta)
                    return str(abs(int(m.group(0)) + delta))
                ops[k] = op.with_(udf=re.sub(r"\d+(?:\.\d+)?", bump,
                                             op.udf, count=1))
                return plan_ir.LogicalPlan(tuple(ops), new.source)
            if op.kind == plan_ir.FILTER and " and " in op.instruction:
                # drop a conjunct
                kept = op.instruction.split(" and ")[0].rstrip(".") + "."
                ops[k] = op.with_(instruction=kept)
                return plan_ir.LogicalPlan(tuple(ops), new.source)
            if op.kind == plan_ir.FILTER and op.is_llm:
                # negate the predicate
                ops[k] = op.with_(
                    instruction="It is NOT the case that: " + op.instruction)
                return plan_ir.LogicalPlan(tuple(ops), new.source)
        # fallback: drop the last op entirely
        return plan_ir.LogicalPlan(tuple(ops[:-1]) or new.ops, new.source)

    return Rewrite(rewrite.rule, rewrite.description + " [corrupted]",
                   bad_apply, correct=False)
