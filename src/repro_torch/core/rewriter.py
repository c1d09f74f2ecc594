"""Plan rewriters — the `m` in Algorithm 1's ``rewrite(p_i, m)``.

Three interchangeable rewriters:

* :class:`LLMSimRewriter` — models the paper's cloud-LLM rewriter: picks a
  random applicable (rule, site) candidate (LLM nondeterminism), emits a
  semantically-wrong rewrite at ``error_rate`` (hallucination; the judge's
  job is to catch these), and bills each rewrite as one LLM call whose
  prompt is the rules text + plan JSON (Tables 6/8 overhead accounting).
* :class:`GreedyRuleRewriter` — deterministic: applies the candidate with
  the largest estimated cost gain. Used by the "2-step" baseline (Table 8)
  and as the teacher when generating local-rewriter training data (§3.3).
* :class:`LocalModelRewriter` — the paper's §3.3 local rewrite model: a
  JAX-trained policy scores candidate rewrites and picks one; falls back to
  uniform when unsure. Training lives in ``examples/train_rewriter.py``;
  at inference the call is billed at local-serving latency (no network),
  which is the point of §3.3.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.core import backends as bk
from repro_torch.core import cost as cost_mod
from repro_torch.core import cost_model as cm
from repro_torch.core import plan as plan_ir
from repro_torch.core import rules as rules_mod


@dataclasses.dataclass
class RewriteOutcome:
    rewrite: Optional[rules_mod.Rewrite]   # None = no applicable rule
    plan: Optional[plan_ir.LogicalPlan]
    usage: bk.Usage


def _rewrite_call_usage(plan: plan_ir.LogicalPlan, tier: cost_mod.TierSpec,
                        rule_names: Sequence[str]) -> bk.Usage:
    rules_text = " ".join(rules_mod.RULES[r][0] for r in rule_names)
    tok_in = cost_mod.text_tokens(rules_text) + cost_mod.text_tokens(
        plan.to_json())
    # the rewriter emits only the rewritten operator(s) — a diff, not the
    # whole plan (keeps per-rewrite latency in the paper's 1-3 s band)
    tok_out = 120.0
    return bk.Usage(calls=1, tok_in=tok_in, tok_out=tok_out,
                    usd=tier.usd(tok_in, tok_out),
                    latency_s=tier.latency(tok_out))


@dataclasses.dataclass
class LLMSimRewriter:
    rule_names: Tuple[str, ...] = tuple(rules_mod.RULES)
    error_rate: float = 0.12      # hallucinated (wrong) rewrites
    tier: cost_mod.TierSpec = dataclasses.field(
        default_factory=lambda: cost_mod.DEFAULT_TIERS["m*"])

    def rewrite(self, plan: plan_ir.LogicalPlan,
                rng: random.Random) -> RewriteOutcome:
        usage = _rewrite_call_usage(plan, self.tier, self.rule_names)
        cands = rules_mod.all_candidates(plan, self.rule_names)
        if not cands:
            return RewriteOutcome(None, None, usage)
        choice = rng.choice(cands)
        if rng.random() < self.error_rate:
            choice = rules_mod.corrupt(choice, plan, rng)
        return RewriteOutcome(choice, choice.apply(), usage)


@dataclasses.dataclass
class GreedyRuleRewriter:
    rule_names: Tuple[str, ...] = tuple(rules_mod.RULES)
    n_rows: int = 1000            # cost-model table size for gain estimates
    tier: cost_mod.TierSpec = dataclasses.field(
        default_factory=lambda: cost_mod.DEFAULT_TIERS["m*"])
    # gain estimates price through this model when set (e.g. a serve
    # loop's calibrated instance); None = the uncalibrated default
    cost_model: Optional[cm.CostModel] = None

    def rewrite(self, plan: plan_ir.LogicalPlan,
                rng: random.Random) -> RewriteOutcome:
        usage = _rewrite_call_usage(plan, self.tier, self.rule_names)
        cands = rules_mod.all_candidates(plan, self.rule_names)
        if not cands:
            return RewriteOutcome(None, None, usage)
        model = self.cost_model or cm.DEFAULT_MODEL
        base = model.objective(model.plan_cost(plan, self.n_rows))
        best, best_gain = None, -1e30
        for c in cands:
            try:
                gain = base - model.objective(
                    model.plan_cost(c.apply(), self.n_rows))
            except Exception:
                continue
            if gain > best_gain:
                best, best_gain = c, gain
        if best is None:
            return RewriteOutcome(None, None, usage)
        return RewriteOutcome(best, best.apply(), usage)


@dataclasses.dataclass
class LocalModelRewriter:
    """§3.3: replace the cloud rewriter with a locally-served model.

    ``policy(plan_json, candidate_descriptions) -> index`` is the trained
    scorer (see examples/train_rewriter.py, which distills the greedy rule
    teacher into a small JAX transformer). Local inference is billed at
    local latency — no network round trip, no per-token API price.
    """
    policy: Callable[[str, Sequence[str]], int]
    rule_names: Tuple[str, ...] = tuple(rules_mod.RULES)
    latency_s: float = 0.08      # local serving latency per rewrite

    def rewrite(self, plan: plan_ir.LogicalPlan,
                rng: random.Random) -> RewriteOutcome:
        usage = bk.Usage(calls=1, tok_in=0.0, tok_out=0.0, usd=0.0,
                         latency_s=self.latency_s)
        cands = rules_mod.all_candidates(plan, self.rule_names)
        if not cands:
            return RewriteOutcome(None, None, usage)
        try:
            idx = int(self.policy(plan.to_json(),
                                  [c.description for c in cands]))
            idx = max(0, min(idx, len(cands) - 1))
        except Exception:
            idx = rng.randrange(len(cands))
        choice = cands[idx]
        return RewriteOutcome(choice, choice.apply(), usage)


def training_pairs(plans: Sequence[plan_ir.LogicalPlan], n_rows: int = 1000,
                   rule_names: Tuple[str, ...] = tuple(rules_mod.RULES)):
    """§3.3 data collection: (un-optimized plan, teacher-chosen rewrite)
    pairs for fine-tuning the local rewriter."""
    teacher = GreedyRuleRewriter(rule_names=rule_names, n_rows=n_rows)
    rng = random.Random(0)
    out = []
    for p in plans:
        oc = teacher.rewrite(p, rng)
        if oc.rewrite is not None:
            cands = rules_mod.all_candidates(p, rule_names)
            label = [c.description for c in cands].index(
                oc.rewrite.description)
            out.append({"plan_json": p.to_json(),
                        "candidates": [c.description for c in cands],
                        "label": label})
    return out
