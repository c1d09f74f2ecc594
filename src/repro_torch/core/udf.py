"""NL -> UDF semantic parser for the *non-LLM replacement* rule (paper §3.2).

The paper's logical optimizer asks an LLM to interpret an operator's natural
language instruction as an equivalent compute function, e.g.

    "Score is higher than 8.5 and lower than 9"  ->  lambda x: 8.5 < x < 9
    "whether the movie has ever won 2 Oscars"    ->
        lambda x: 'Oscar' in x and int(x.split('Oscar')[0].strip()) == 2

This module is the deterministic analogue: a pattern-grammar compiler from
instruction text to python source + callable. It intentionally covers the
same instruction families as the paper's workloads (App. F) — numeric
comparisons, substring/entity predicates, award counts, money extraction,
count/sum/avg/min/max/mode reductions — and *intentionally keeps the paper's
failure mode*: compiled UDFs assume a value format, and rows that deviate
make the UDF wrong (Fig. 12b). That behaviour is exercised by
benchmarks/table5_quality.py.

Compiled sources use only the names in ``_SAFE_GLOBALS`` and are evaluated
with empty builtins, so a UDF can never touch the filesystem or network.
"""
from __future__ import annotations

import dataclasses
import math
import re
import statistics
from typing import Callable, List, Optional

from repro_torch.core import plan as plan_ir

_NUM = r"[-+]?\d+(?:[\.,]\d+)?"


def parse_number(x) -> Optional[float]:
    """First number in a value; handles '8.5', '92%', 'N250m', '430 Million'."""
    if isinstance(x, (int, float)):
        return float(x)
    s = str(x)
    m = re.search(_NUM, s.replace(",", ""))
    if not m:
        return None
    v = float(m.group(0))
    tail = s[m.end():m.end() + 12].lower()
    if re.match(r"\s*(m\b|m[^a-z]|million)", tail):
        v *= 1e6
    elif re.match(r"\s*(b\b|billion)", tail):
        v *= 1e9
    elif re.match(r"\s*(k\b|thousand)", tail):
        v *= 1e3
    return v


def parse_money(x) -> Optional[float]:
    return parse_number(x)


_SAFE_GLOBALS = {
    "__builtins__": {},
    "len": len, "sum": sum, "min": min, "max": max, "abs": abs,
    "float": float, "int": int, "str": str, "round": round,
    "sorted": sorted, "any": any, "all": all,
    "re": re, "math": math, "statistics": statistics,
    "parse_number": parse_number, "parse_money": parse_money,
}


@dataclasses.dataclass
class CompiledUDF:
    source: str              # python lambda source (shown in case studies)
    fn: Callable             # filter/map: per-value; reduce: List -> scalar
    note: str = ""

    def __call__(self, *a):
        return self.fn(*a)


def _make(source: str, note: str = "") -> CompiledUDF:
    fn = eval(source, dict(_SAFE_GLOBALS))  # noqa: S307 — sandboxed globals
    return CompiledUDF(source=source, fn=fn, note=note)


# ---------------------------------------------------------------------------
# Filter predicates
# ---------------------------------------------------------------------------

_RANGE_RE = re.compile(
    r"(?:higher|greater|more|larger)\s+than\s+(" + _NUM + r").*?"
    r"(?:lower|less|smaller)\s+than\s+(" + _NUM + r")", re.I | re.S)
_GT_RE = re.compile(
    r"(?:higher|greater|more|larger)\s+than\s+(" + _NUM + r")", re.I)
_LT_RE = re.compile(
    r"(?:lower|less|smaller|fewer)\s+than\s+(" + _NUM + r")", re.I)
_WON_RE = re.compile(
    r"won\s+(?:more\s+than\s+)?(\d+)\s+Oscars?", re.I)
_EQ_NUM_RE = re.compile(r"(?:is\s+exactly|equals?)\s+(" + _NUM + r")", re.I)
_OR_VALUES_RE = re.compile(r"has\s+(\d+)\s+or\s+(\d+)\s+(\w+)", re.I)
# quoted literal or a capitalized multiword entity after a linking verb
_ENTITY_RE = re.compile(
    r"(?:directed\s+by|located\s+in|belongs?\s+to|is\s+about|stars?|"
    r"support[s]?|published\s+by|is\s+a|there\s+a|is\s+an?|in)\s+"
    r"((?:[A-Z][\w\.\-']*(?:[ ,]\s*)?)+|\"[^\"]+\"|'[^']+')", 0)
_QUOTED_RE = re.compile(r"[\"']([^\"']+)[\"']")


def compile_filter(instruction: str) -> Optional[CompiledUDF]:
    ins = instruction.strip().rstrip(".?")
    m = _RANGE_RE.search(ins)
    if m:
        lo, hi = m.group(1), m.group(2)
        return _make(
            f"lambda x: (parse_number(x) is not None) and "
            f"{lo} < parse_number(x) < {hi}", "numeric range")
    m = _WON_RE.search(ins)
    if m:
        n = int(m.group(1))
        op = ">" if re.search(r"more\s+than", ins, re.I) else "=="
        # the paper's own split-based parse (Fig. 11) — format-fragile on
        # purpose: rows like "Nominated for 2 Oscars" defeat it.
        return _make(
            f"lambda x: ('Oscar' in str(x)) and "
            f"(parse_number(str(x).split('Oscar')[0])) is not None and "
            f"int(parse_number(str(x).split('Oscar')[0])) {op} {n}",
            "award count")
    m = _OR_VALUES_RE.search(ins)
    if m:
        a, b = int(m.group(1)), int(m.group(2))
        return _make(
            f"lambda x: (parse_number(x) is not None) and "
            f"int(parse_number(x)) in ({a}, {b})", "value-set")
    m = _GT_RE.search(ins)
    if m:
        return _make(
            f"lambda x: (parse_number(x) is not None) and "
            f"parse_number(x) > {m.group(1)}", "numeric >")
    m = _LT_RE.search(ins)
    if m:
        return _make(
            f"lambda x: (parse_number(x) is not None) and "
            f"parse_number(x) < {m.group(1)}", "numeric <")
    m = _EQ_NUM_RE.search(ins)
    if m:
        return _make(
            f"lambda x: (parse_number(x) is not None) and "
            f"parse_number(x) == {m.group(1)}", "numeric ==")
    m = _QUOTED_RE.search(ins) or _ENTITY_RE.search(ins)
    if m:
        needle = m.group(1).strip().strip("\"'").strip(" ,")
        # skip degenerate 1-word lowercase captures and modality references
        if (len(needle) >= 3 and needle.lower() not in
                ("the", "it", "is", "an", "a")
                and not _mentions_modality(ins)):
            needle_esc = needle.replace("\\", "\\\\").replace("'", "\\'")
            return _make(
                f"lambda x: '{needle_esc}'.lower() in str(x).lower()",
                "substring/entity")
    return None


def _mentions_modality(ins: str) -> bool:
    """Instructions grounded in images/audio can never be a compute UDF."""
    return bool(re.search(
        r"picture|image|poster|photo|observed|audio|sound|style", ins, re.I))


# ---------------------------------------------------------------------------
# Map transformations
# ---------------------------------------------------------------------------

_EXTRACT_NUM_RE = re.compile(r"extract\s+the\s+[\w\s]*?(price|rating|score|"
                             r"number|count|year)", re.I)
_CONVERT_RE = re.compile(
    r"convert\s+the\s+price\s+in\s+(\w+)\s+into\s+(?:the\s+price\s+in\s+)?(\w+)",
    re.I)

_FX = {("idr", "usd"): 6.5e-5, ("usd", "idr"): 15384.0,
       ("ngn", "usd"): 6.7e-4}


def compile_map(instruction: str) -> Optional[CompiledUDF]:
    ins = instruction.strip().rstrip(".?")
    m = _CONVERT_RE.search(ins)
    if m:
        rate = _FX.get((m.group(1).lower(), m.group(2).lower()))
        if rate:
            return _make(
                f"lambda x: (parse_money(x) * {rate}) "
                f"if parse_money(x) is not None else None", "fx convert")
    if _EXTRACT_NUM_RE.search(ins) and not _mentions_modality(ins):
        return _make(
            "lambda x: parse_money(x)", "numeric extraction")
    return None


# ---------------------------------------------------------------------------
# Reduce aggregations (List -> scalar)
# ---------------------------------------------------------------------------

def compile_reduce(instruction: str) -> Optional[CompiledUDF]:
    ins = instruction.lower()
    if re.search(r"count\s+the\s+number|how\s+many", ins):
        return _make("lambda xs: len(xs)", "count")
    nums = ("lambda xs: [parse_number(x) for x in xs if "
            "parse_number(x) is not None]")
    if re.search(r"average|mean", ins):
        return _make(
            f"lambda xs: (lambda v: sum(v) / len(v) if v else None)"
            f"(({nums})(xs))", "average")
    if re.search(r"total|sum\b", ins):
        return _make(
            f"lambda xs: (lambda v: sum(v) if v else None)(({nums})(xs))",
            "sum")
    if re.search(r"max|highest|largest", ins):
        return _make(
            f"lambda xs: (lambda v: max(v) if v else None)(({nums})(xs))",
            "max")
    if re.search(r"min|lowest|smallest|cheapest", ins):
        return _make(
            f"lambda xs: (lambda v: min(v) if v else None)(({nums})(xs))",
            "min")
    if re.search(r"appears\s+the\s+most|most\s+frequent|most\s+common", ins):
        return _make(
            "lambda xs: (statistics.mode([str(x) for x in xs]) "
            "if xs else None)", "mode")
    return None


def compile_udf(op: plan_ir.Operator) -> Optional[CompiledUDF]:
    """Compile an operator's instruction to a UDF, or None if no pattern of
    the grammar applies (the operator then stays LLM-executed)."""
    if op.kind == plan_ir.FILTER:
        return compile_filter(op.instruction)
    if op.kind == plan_ir.MAP:
        return compile_map(op.instruction)
    if op.kind == plan_ir.REDUCE:
        return compile_reduce(op.instruction)
    if op.kind == plan_ir.RANK:
        ins = op.instruction.lower()
        if re.search(r"(rank|order|sort).*(rating|price|score|number)", ins):
            desc = bool(re.search(r"descend|highest|best", ins))
            return _make(
                f"lambda xs: sorted(range(len(xs)), key=lambda i: "
                f"(parse_number(xs[i]) is None, parse_number(xs[i]) or 0), "
                f"reverse={desc})", "numeric rank")
    return None


def resolve_udf(op: plan_ir.Operator) -> Optional[CompiledUDF]:
    """Re-hydrate the callable for an operator whose ``udf`` source was set
    by the rewriter (sources round-trip through plan JSON)."""
    if op.udf is None:
        return None
    return CompiledUDF(source=op.udf, fn=eval(op.udf, dict(_SAFE_GLOBALS)))  # noqa: S307
