"""Logical-plan IR (paper §2.2).

A user query compiles to *data lineage* — a DAG over semantic operators. The
paper's queries (App. F) are operator chains; the IR keeps them as an ordered
tuple with the DAG recovered from column def/use edges, which is what the
transformation rules need for legality checks (an operator may move past
another iff it does not consume its output and no reduce barrier intervenes).

Operators carry:
  kind           map | filter | reduce | rank
  instruction    the natural-language predicate / transformation
  input_column   column(s) read
  output_column  column written (map / rank), None for filter, result for reduce
  udf            python source of a compiled non-LLM implementation
                 (set by the non-LLM-replacement rule); None = LLM-executed
  selectivity    cost-model estimate of |out| / |in|
  fused_from     how many original operators were merged into this one
  tier           physical plan: backend model tier name (None = unassigned)
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

MAP, FILTER, REDUCE, RANK = "map", "filter", "reduce", "rank"
KINDS = (MAP, FILTER, REDUCE, RANK)

# paper defaults: filter 0.5, reduce 0 (many-to-one), map/rank 1
DEFAULT_SELECTIVITY = {MAP: 1.0, FILTER: 0.5, REDUCE: 0.0, RANK: 1.0}


@dataclasses.dataclass(frozen=True)
class Operator:
    kind: str
    instruction: str
    input_column: str
    output_column: Optional[str] = None
    udf: Optional[str] = None
    selectivity: Optional[float] = None
    fused_from: int = 1
    tier: Optional[str] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown operator kind {self.kind!r}")
        if self.kind == MAP and self.output_column is None:
            raise ValueError("map requires output_column")
        if self.selectivity is None:
            sel = DEFAULT_SELECTIVITY[self.kind]
            if self.kind == FILTER and self.fused_from > 1:
                # paper §3.1: merged filter selectivity 0.5 -> 0.25 -> 1/6 ...
                sel = sel / self.fused_from
            object.__setattr__(self, "selectivity", sel)

    # ------------------------------------------------------------------
    @property
    def is_llm(self) -> bool:
        return self.udf is None

    @property
    def reads(self) -> Tuple[str, ...]:
        return tuple(c.strip() for c in self.input_column.split(","))

    @property
    def writes(self) -> Tuple[str, ...]:
        return (self.output_column,) if self.output_column else ()

    def with_(self, **kw) -> "Operator":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        exec_ = f"udf:{self.udf}" if self.udf else (self.tier or "llm")
        out = f" -> {self.output_column}" if self.output_column else ""
        return (f"{self.kind}[{self.input_column}{out}] "
                f"\"{self.instruction}\" ({exec_})")


@dataclasses.dataclass(frozen=True)
class LogicalPlan:
    ops: Tuple[Operator, ...]
    source: str = ""          # dataset / table name

    def __post_init__(self):
        object.__setattr__(self, "ops", tuple(self.ops))

    # ------------------------------------------------------------------
    # DAG structure
    # ------------------------------------------------------------------
    def depends_on(self, i: int, j: int) -> bool:
        """True if op i (later) consumes a column written by op j (earlier),
        or j is a reduce (a pipeline barrier: it collapses the table)."""
        if j >= i:
            return False
        oj, oi = self.ops[j], self.ops[i]
        if oj.kind == REDUCE:
            return True
        return any(w in oi.reads for w in oj.writes)

    def movable_before(self, i: int) -> int:
        """Earliest position op i can legally move to (paper's pushdown
        legality: 'does not rely on results of preceding operators')."""
        pos = i
        for j in range(i - 1, -1, -1):
            if self.depends_on(i, j):
                break
            pos = j
        return pos

    def validate(self) -> None:
        """Check def-before-use for every non-source column."""
        defined = set()
        for k, op in enumerate(self.ops):
            for w in op.writes:
                defined.add(w)
        # source columns are those read but never written before their read
        seen = set()
        for op in self.ops:
            for r in op.reads:
                if r in defined and r not in seen:
                    # must have been written already
                    raise ValueError(
                        f"plan reads {r} before it is produced: {self}")
            seen.update(op.writes)

    # ------------------------------------------------------------------
    # Rewrite helpers (used by transformation rules)
    # ------------------------------------------------------------------
    def replace_op(self, i: int, op: Operator) -> "LogicalPlan":
        ops = list(self.ops)
        ops[i] = op
        return dataclasses.replace(self, ops=tuple(ops))

    def move_op(self, i: int, to: int) -> "LogicalPlan":
        ops = list(self.ops)
        op = ops.pop(i)
        ops.insert(to, op)
        return dataclasses.replace(self, ops=tuple(ops))

    def fuse_ops(self, i: int, j: int, fused: Operator) -> "LogicalPlan":
        assert i < j
        ops = list(self.ops)
        ops[i] = fused
        ops.pop(j)
        return dataclasses.replace(self, ops=tuple(ops))

    def with_tiers(self, tiers) -> "LogicalPlan":
        """Assign a physical plan: tiers is a list (len == n LLM ops consumed
        in order) or a dict {op_index: tier}."""
        ops = list(self.ops)
        if isinstance(tiers, dict):
            for idx, t in tiers.items():
                ops[idx] = ops[idx].with_(tier=t)
        else:
            it = iter(tiers)
            for k, op in enumerate(ops):
                if op.is_llm:
                    ops[k] = op.with_(tier=next(it))
        return dataclasses.replace(self, ops=tuple(ops))

    # ------------------------------------------------------------------
    @property
    def n_llm_ops(self) -> int:
        return sum(1 for o in self.ops if o.is_llm)

    def signature(self) -> tuple:
        """Hashable identity used to dedupe candidate plans in the search."""
        return tuple((o.kind, o.instruction, o.input_column, o.output_column,
                      o.udf, o.fused_from) for o in self.ops)

    def describe(self) -> str:
        return "\n".join(f"  {k}: {op.describe()}"
                         for k, op in enumerate(self.ops))

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "source": self.source,
            "ops": [dataclasses.asdict(o) for o in self.ops],
        }, indent=1)

    @staticmethod
    def from_json(text: str) -> "LogicalPlan":
        d = json.loads(text)
        return LogicalPlan(tuple(Operator(**o) for o in d["ops"]),
                           d.get("source", ""))
