"""Instruction oracle — ground-truth provider for the capability simulator.

Each synthetic dataset registers (pattern, truth_fn) pairs for every
instruction family its workload uses; generated values are authored by the
same module, so truth functions recover the hidden semantics exactly
(e.g. the genre keyword planted in a plot, the PEGI rating inside an image
blob). Instructions the registry does not know fall back to the compiled-UDF
grammar; composite instructions produced by the fusion rule and negations
produced by the corruption harness are decomposed structurally.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, Sequence, Tuple

from repro_torch.core import plan as plan_ir
from repro_torch.core import udf as udf_mod

NEGATION_PREFIX = "It is NOT the case that: "


class InstructionOracle:
    def __init__(self, name: str = ""):
        self.name = name
        self._filters: List[Tuple[re.Pattern, Callable]] = []
        self._maps: List[Tuple[re.Pattern, Callable]] = []
        self._reduces: List[Tuple[re.Pattern, Callable]] = []

    # -- registration ------------------------------------------------------
    def filter(self, pattern: str):
        def deco(fn):
            self._filters.append((re.compile(pattern, re.I), fn))
            return fn
        return deco

    def map(self, pattern: str):
        def deco(fn):
            self._maps.append((re.compile(pattern, re.I), fn))
            return fn
        return deco

    def reduce(self, pattern: str):
        def deco(fn):
            self._reduces.append((re.compile(pattern, re.I), fn))
            return fn
        return deco

    # -- resolution ----------------------------------------------------------
    def _lookup(self, table, instruction: str):
        for pat, fn in table:
            m = pat.search(instruction)
            if m:
                return fn, m
        return None, None

    def answer(self, op: plan_ir.Operator, value: Any) -> Any:
        ins = op.instruction.strip()
        if ins.startswith(NEGATION_PREFIX):
            inner = op.with_(instruction=ins[len(NEGATION_PREFIX):])
            return not self.answer(inner, value)
        # composite predicates from operator fusion decompose FIRST — a
        # single registry pattern matching one conjunct must not swallow
        # the whole conjunction
        if op.kind == plan_ir.FILTER and " and " in ins:
            parts = [p.strip().rstrip(".") for p in ins.split(" and ")]
            try:
                return all(self.answer(op.with_(instruction=p + "."), value)
                           for p in parts)
            except KeyError:
                pass
        table = self._filters if op.kind == plan_ir.FILTER else self._maps
        fn, m = self._lookup(table, ins)
        if fn is not None:
            return fn(value, m)
        compiled = udf_mod.compile_udf(op)
        if compiled is not None:
            return compiled.fn(value)
        raise KeyError(f"[{self.name}] no oracle for {op.kind} instruction "
                       f"{op.instruction!r}")

    def answer_reduce(self, op: plan_ir.Operator, values: Sequence) -> Any:
        fn, m = self._lookup(self._reduces, op.instruction)
        if fn is not None:
            return fn(list(values), m)
        compiled = udf_mod.compile_reduce(op.instruction)
        if compiled is not None:
            return compiled.fn(list(values))
        raise KeyError(f"[{self.name}] no reduce oracle for "
                       f"{op.instruction!r}")
