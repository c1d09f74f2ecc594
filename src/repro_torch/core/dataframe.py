"""SemanticDataFrame — the user-facing programmable operator API (paper
Table 1 / Listing 1).

    df = SemanticDataFrame(table)
    df = (df.semantic_map("Extract the genre(s) of each movie.",
                          input_column="Plot", output_column="Genre")
            .semantic_filter("The rating is higher than 8.5.",
                             input_column="IMDB_rating")
            .semantic_reduce("Count the number of movies.",
                             input_column="Title"))
    result = df.execute(backends)        # optimizes, then runs

Operator calls build the logical plan lazily; ``execute`` runs the full
Nirvana pipeline: logical optimization (random-walk agentic rewriter) ->
physical optimization (improvement-score model selection) -> execution,
and returns the result plus the complete cost/latency breakdown per phase
(the Fig. 9 decomposition).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core import backends as bk
from repro_torch.core import executor as ex
from repro_torch.core import logical_optimizer as lopt
from repro_torch.core import physical_optimizer as popt
from repro_torch.core import plan as plan_ir
from repro_torch.core import runtime as rt
from repro_torch.core.table import Table


@dataclasses.dataclass
class QueryReport:
    result: Any
    logical: Optional[lopt.OptResult]
    physical: Optional[popt.PhysicalOptResult]
    execution: ex.ExecutionResult
    plan: plan_ir.LogicalPlan

    @property
    def total_usd(self) -> float:
        usd = self.execution.meter.total.usd
        if self.logical:
            usd += self.logical.meter.total.usd
        if self.physical:
            usd += self.physical.meter.total.usd
        return usd

    @property
    def total_wall_s(self) -> float:
        w = self.execution.wall_s
        if self.logical:
            w += self.logical.opt_wall_s
        if self.physical:
            w += self.physical.opt_wall_s
        return w

    def phase_breakdown(self) -> Dict[str, Dict[str, float]]:
        out = {"execution": {"wall_s": self.execution.wall_s,
                             "usd": self.execution.meter.total.usd}}
        if self.logical:
            out["logical_opt"] = {"wall_s": self.logical.opt_wall_s,
                                  "usd": self.logical.meter.total.usd}
        if self.physical:
            out["physical_opt"] = {"wall_s": self.physical.opt_wall_s,
                                   "usd": self.physical.meter.total.usd}
        return out


class SemanticDataFrame:
    def __init__(self, table: Table, _ops: tuple = ()):
        self.table = table
        self._ops = _ops

    # ------------------------------------------------------------------
    # Table-1 operators
    # ------------------------------------------------------------------
    def semantic_map(self, user_instruction: str, input_column: str,
                     output_column: str) -> "SemanticDataFrame":
        op = plan_ir.Operator(plan_ir.MAP, user_instruction, input_column,
                              output_column)
        return SemanticDataFrame(self.table, self._ops + (op,))

    def semantic_filter(self, user_instruction: str,
                        input_column: str) -> "SemanticDataFrame":
        op = plan_ir.Operator(plan_ir.FILTER, user_instruction, input_column)
        return SemanticDataFrame(self.table, self._ops + (op,))

    def semantic_reduce(self, user_instruction: str,
                        input_column: str) -> "SemanticDataFrame":
        op = plan_ir.Operator(plan_ir.REDUCE, user_instruction, input_column)
        return SemanticDataFrame(self.table, self._ops + (op,))

    def semantic_rank(self, user_instruction: str, input_column: str,
                      output_column: str = "rank") -> "SemanticDataFrame":
        op = plan_ir.Operator(plan_ir.RANK, user_instruction, input_column,
                              output_column)
        return SemanticDataFrame(self.table, self._ops + (op,))

    # ------------------------------------------------------------------
    def plan(self) -> plan_ir.LogicalPlan:
        return plan_ir.LogicalPlan(self._ops, source=self.table.name)

    def execute(self, backends: "Dict[str, bk.Backend] | rt.ExecutionContext",
                *, logical: bool = True, physical: bool = True,
                rewriter=None,
                lcfg: Optional[lopt.LogicalOptConfig] = None,
                pcfg: Optional[popt.PhysicalOptConfig] = None,
                concurrency: int = 16,
                default_tier: str = "m*",
                driver: str = "simulated") -> QueryReport:
        plan = self.plan()
        plan.validate()

        # one ExecutionContext threads the whole pipeline: the logical
        # optimizer's candidate evaluation, the physical optimizer's sample
        # flow, and the final execution (optimizers fork their own meters)
        if isinstance(backends, rt.ExecutionContext):
            ctx = backends
        else:
            ctx = rt.ExecutionContext(backends=backends,
                                      default_tier=default_tier,
                                      concurrency=concurrency,
                                      driver=driver)

        lres = None
        if logical:
            # configs inherit tier/concurrency from the context by default
            lres = lopt.optimize(plan, self.table, ctx, rewriter=rewriter,
                                 cfg=lcfg or lopt.LogicalOptConfig())
            plan = lres.best

        pres = None
        if physical and plan.n_llm_ops:
            pres = popt.optimize(plan, self.table, ctx,
                                 cfg=pcfg or popt.PhysicalOptConfig())
            plan = pres.plan

        run = ex.execute(plan, self.table, ctx)
        return QueryReport(result=run.value(), logical=lres, physical=pres,
                           execution=run, plan=plan)
