"""Deprecated shim over :mod:`repro_torch.core.cost_model`.

All cost estimation lives on :class:`repro_torch.core.cost_model.CostModel`
now — tier specs, token priors, ``op_cost``/``plan_cost``, plus the
online calibration and makespan estimation the free functions never had.
This module keeps the seed-era surface importable: the data structures
are re-exported and the free functions delegate to
:data:`cost_model.DEFAULT_MODEL` (which is never calibrated, so these
stay byte-stable). New code should take an explicit ``CostModel``
(usually ``ExecutionContext.cost_model``) instead of importing from here.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core import plan as plan_ir
from repro_torch.core.cost_model import (   # noqa: F401  (re-exported surface)
    DEFAULT_MODEL,
    DEFAULT_TIERS,
    EMBED_ROW_S,
    EMBED_TIER,
    EMBED_TIER_NAME,
    OUT_TOKENS,
    OpCost,
    PlanCost,
    TIER_ORDER,
    TOKENS_PER_CHAR,
    TierSpec,
    chip_seconds,
)


def text_tokens(text) -> float:
    return DEFAULT_MODEL.text_tokens(text)


def tier_list(tiers: Optional[Dict[str, TierSpec]] = None):
    return DEFAULT_MODEL.tier_list(tiers)


def op_cost(op: plan_ir.Operator, rows_in: float, tier: TierSpec,
            avg_value_tokens: float = 60.0,
            concurrency: int = 1, batch_size: int = 1,
            cascade_escalate: Optional[float] = None) -> OpCost:
    return DEFAULT_MODEL.op_cost(
        op, rows_in, tier, avg_value_tokens, concurrency=concurrency,
        batch_size=batch_size, cascade_escalate=cascade_escalate)


def plan_cost(plan: plan_ir.LogicalPlan, n_rows: int,
              tiers: Optional[Dict[str, TierSpec]] = None,
              default_tier: str = "m*",
              avg_value_tokens: float = 60.0,
              concurrency: int = 16, batch_size: int = 1,
              shards: int = 1,
              cascade: Optional[Dict[int, float]] = None) -> PlanCost:
    return DEFAULT_MODEL.plan_cost(
        plan, n_rows, tiers=tiers, default_tier=default_tier,
        avg_value_tokens=avg_value_tokens, concurrency=concurrency,
        batch_size=batch_size, shards=shards, cascade=cascade)
