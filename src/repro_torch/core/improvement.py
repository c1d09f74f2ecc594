"""Improvement-score computation (paper §4.2–4.3, Eqs. 2–8).

The improvement score I_{m1->m} = E[m(x) = m*(x), m1(x) != m(x)] measures the
quality gained by upgrading an operator's backend from the baseline m1 to a
stronger model m, with the strongest tier m* as ground-truth proxy.

Four estimators, from most to least expensive, each tracking *exactly* which
model invocations it performs (a UsageMeter per estimator is the data behind
the paper's "4x lower optimization overhead than Smart" claim):

  exact       Eq. 2 verbatim: every tier runs on every sample record.
  pushdown    Eq. 3: factor Pr(m=m*, m1!=m) = Pr(m=m*|m1!=m)Pr(m1!=m) and run
              m* only on records where m1 != m ("evaluation pushdown").
  reuse       Eq. 4: total-probability expansion of I13 reuses I12 and its
              cached comparisons; m* runs only where (m1=m2, m2!=m3) for the
              new term. NOTE: the paper derives Eq. 4 as a pure law-of-
              total-probability identity, but the substitution of its first
              term with I12 additionally requires nested correctness
              (Hypothesis 2) — property-tested in tests/test_improvement.py
              (see the hypothesis-found counterexample there).
  approx      Eqs. 6-8 under the model-capability hypothesis: m*-evaluations
              for I12/I13 are eliminated entirely; I1* needs m* only on the
              (m1=m2=m3) subset.

All estimators share one lazily-memoized output store, so "computation
reuse" is structural: a record evaluated once by a tier is never re-run.
Output equality is semantic equality (binary outputs compare directly;
free-text via the hashing embedder — paper's Sentence-BERT role).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core import backends as bk
from repro_torch.core import plan as plan_ir
from repro_torch.core import runtime as rt
from repro_torch.core import semhash

TIERS4 = ("m1", "m2", "m3", "m*")


class OutputStore:
    """Lazy, memoized per-(tier, record) model outputs + equality cache.

    With a ``dispatcher`` (``runtime.Dispatcher``), each tier sweep's
    per-record calls fan out over the tier's worker pool — under the
    threaded driver the scoring calls of one ``ensure`` genuinely overlap
    (the simulated dispatcher's fanout is None, i.e. inline)."""

    def __init__(self, backends: Dict[str, bk.Backend],
                 op: plan_ir.Operator, values: Sequence,
                 meter: Optional[bk.UsageMeter] = None,
                 dispatcher: Optional["rt.Dispatcher"] = None,
                 batch_size: int = 1):
        self.backends = backends
        self.op = op
        self.values = list(values)
        self.meter = meter if meter is not None else bk.UsageMeter()
        self.dispatcher = dispatcher
        # batch prompting for the scoring sweeps: an operator's evaluation
        # on k records is priced at ceil(k/batch) calls — the same batch
        # size the executor will run at, so scores *and* overhead are
        # measured under execution conditions (batch accuracy penalty
        # included), making tier choice batch-aware
        self.batch_size = max(1, int(batch_size))
        self._out: Dict[str, Dict[int, object]] = {t: {} for t in backends}
        self._eq: Dict[tuple, bool] = {}

    @property
    def n(self) -> int:
        return len(self.values)

    def ensure(self, tier: str, idxs: Sequence[int]) -> None:
        missing = [i for i in idxs if i not in self._out[tier]]
        if not missing:
            return
        backend = self.backends[tier]
        fan = self.dispatcher.fanout(backend.tier.name) \
            if self.dispatcher is not None else None
        outs = rt.run_backend_calls(
            self.op, [self.values[i] for i in missing], backend,
            self.meter, batch_size=self.batch_size, fanout=fan)
        for i, o in zip(missing, outs):
            self._out[tier][i] = o

    def out(self, tier: str, i: int):
        self.ensure(tier, [i])
        return self._out[tier][i]

    def eq(self, a: str, b: str, i: int) -> bool:
        key = (a, b, i) if a <= b else (b, a, i)
        if key not in self._eq:
            va, vb = self.out(a, i), self.out(b, i)
            self._eq[key] = bool(semhash.semantic_equal(va, vb))
        return self._eq[key]

    def eq_frac(self, a: str, b: str, idxs: Sequence[int]) -> float:
        if not idxs:
            return 0.0
        self.ensure(a, idxs)
        self.ensure(b, idxs)
        return sum(self.eq(a, b, i) for i in idxs) / len(idxs)

    def calls(self, tier: str) -> int:
        return self.meter.calls(tier)


@dataclasses.dataclass
class ImprovementResult:
    scores: Dict[str, float]          # tier -> I_{m1->tier}
    meter: bk.UsageMeter              # invocation accounting
    method: str

    def score(self, tier: str) -> float:
        return self.scores[tier]


def _idx(store: OutputStore) -> List[int]:
    return list(range(store.n))


# ---------------------------------------------------------------------------
# Eq. 2 — exact
# ---------------------------------------------------------------------------

def improvement_exact(store: OutputStore) -> ImprovementResult:
    n = store.n
    all_i = _idx(store)
    for t in TIERS4:
        store.ensure(t, all_i)
    i12 = sum(store.eq("m2", "m*", i) and not store.eq("m1", "m2", i)
              for i in all_i) / n
    i13 = sum(store.eq("m3", "m*", i) and not store.eq("m1", "m3", i)
              for i in all_i) / n
    i1s = sum(not store.eq("m1", "m*", i) for i in all_i) / n
    return ImprovementResult({"m2": i12, "m3": i13, "m*": i1s}, store.meter,
                             "exact")


# ---------------------------------------------------------------------------
# Eq. 3 — evaluation pushdown
# ---------------------------------------------------------------------------

def improvement_pushdown(store: OutputStore) -> ImprovementResult:
    n = store.n
    all_i = _idx(store)
    store.ensure("m1", all_i)
    store.ensure("m2", all_i)
    d12 = [i for i in all_i if not store.eq("m1", "m2", i)]
    # m* runs only on the m1 != m2 subset
    i12 = sum(store.eq("m2", "m*", i) for i in d12) / n

    store.ensure("m3", all_i)
    d13 = [i for i in all_i if not store.eq("m1", "m3", i)]
    i13 = sum(store.eq("m3", "m*", i) for i in d13) / n

    # I_{m1->m*} = Pr(m1 != m*) has no pushdown form — full m* sweep
    i1s = sum(not store.eq("m1", "m*", i) for i in all_i) / n
    return ImprovementResult({"m2": i12, "m3": i13, "m*": i1s}, store.meter,
                             "pushdown")


# ---------------------------------------------------------------------------
# Eqs. 4-5 — computation reuse (exact under the binary response model)
# ---------------------------------------------------------------------------

def improvement_reuse(store: OutputStore) -> ImprovementResult:
    n = store.n
    all_i = _idx(store)
    store.ensure("m1", all_i)
    store.ensure("m2", all_i)
    d12 = [i for i in all_i if not store.eq("m1", "m2", i)]
    i12 = sum(store.eq("m2", "m*", i) for i in d12) / n

    # Eq. 4: I13 = I12 + Pr(m3=m*, m2!=m3, m1=m2); the new m* evaluations
    # are confined to records with (m1 = m2) & (m2 != m3); m1=m2 comparisons
    # are reused from the I12 pass.
    store.ensure("m3", all_i)
    t2 = [i for i in all_i
          if store.eq("m1", "m2", i) and not store.eq("m2", "m3", i)]
    i13 = i12 + sum(store.eq("m3", "m*", i) for i in t2) / n

    # Eq. 5: expand Pr(m1 != m*) over the (m1?m2, m2?m3) cells, reusing all
    # cached comparisons. m* evaluation is still needed per cell — the
    # savings relative to `pushdown` come from I13; eliminating the m* sweep
    # entirely requires the capability hypothesis (`approx`).
    i1s = sum(not store.eq("m1", "m*", i) for i in all_i) / n
    return ImprovementResult({"m2": i12, "m3": i13, "m*": i1s}, store.meter,
                             "reuse")


# ---------------------------------------------------------------------------
# Eqs. 6-8 — model-capability-hypothesis approximation
# ---------------------------------------------------------------------------

def improvement_approx(store: OutputStore,
                       max_cond_eval: Optional[int] = None
                       ) -> ImprovementResult:
    """Eqs. 6-8. Conditional terms (Pr(x|y)) are probability *estimates*;
    when ``max_cond_eval`` is set they are computed on a bounded prefix of
    the conditioning subset and multiplied by the exactly-counted base rate
    — this is what caps m3/m* invocations per operator independent of the
    sample size (the overhead profile behind Table 9)."""
    n = store.n
    all_i = _idx(store)
    store.ensure("m1", all_i)
    store.ensure("m2", all_i)

    def sub(idxs):
        if max_cond_eval is None or len(idxs) <= max_cond_eval:
            return idxs
        return idxs[:max_cond_eval]

    # Eq. 6: I12 ~= Pr(m1 != m2)           (observation 1: m1!=m2 => m2=m*)
    p_neq12 = sum(not store.eq("m1", "m2", i) for i in all_i) / n
    i12 = p_neq12

    # Eq. 7: I13 ~= I12 + Pr(m2 != m3 | m1 = m2) Pr(m1 = m2); m3 evaluated
    # only on (a bounded slice of) the m1 = m2 subset.
    a12 = [i for i in all_i if store.eq("m1", "m2", i)]
    a12_s = sub(a12)
    store.ensure("m3", a12_s)
    p_23neq_g_12eq = (sum(not store.eq("m2", "m3", i) for i in a12_s)
                      / len(a12_s)) if a12_s else 0.0
    i13 = i12 + p_23neq_g_12eq * (len(a12) / n)

    # Eq. 8: m* evaluated ONLY on records where m1 = m2 and m2 = m3.
    agree = [i for i in a12_s if store.eq("m2", "m3", i)]
    agree_s = sub(agree)
    if agree_s:
        p_cond = sum(not store.eq("m1", "m*", i)
                     for i in agree_s) / len(agree_s)
    else:
        p_cond = 0.0
    # last term: Pr(m2 = m3 | m1 != m2) Pr(m1 != m2); m3 on the m1!=m2 subset
    d12 = [i for i in all_i if not store.eq("m1", "m2", i)]
    d12_s = sub(d12)
    store.ensure("m3", d12_s)
    p_23eq_g_12neq = (sum(store.eq("m2", "m3", i) for i in d12_s)
                      / len(d12_s)) if d12_s else 0.0
    i1s = p_cond * (1.0 - i13) + (i13 - i12) + p_23eq_g_12neq * p_neq12
    i1s = min(max(i1s, 0.0), 1.0)
    return ImprovementResult({"m2": i12, "m3": i13, "m*": i1s}, store.meter,
                             "approx")


ESTIMATORS = {
    "exact": improvement_exact,
    "pushdown": improvement_pushdown,
    "reuse": improvement_reuse,
    "approx": improvement_approx,
}


# ---------------------------------------------------------------------------
# Tier-0 cascade as a candidate assignment (core.cascade)
# ---------------------------------------------------------------------------

def improvement_cascade(store: OutputStore, proxy: str,
                        decisions: Dict[int, object]) -> Dict[str, float]:
    """Score a tier-0 embedding cascade with the improvement-score metric.

    ``decisions`` maps sample index -> the cascade's on-device resolution
    (bool for SEM_FILTER pass/drop); indices absent from it escalate, i.e.
    the cascade answers them with the ``proxy`` tier's own output. Returns

      agree        fraction of resolved records whose decision matches the
                   proxy tier (the cascade's escalation target — its output
                   is what an un-cascaded plan would produce)
      resolved     fraction answered on device (1 - escalation rate)
      improvement  I_{m1->cascade(proxy)} under Eq. 2 with the cascade as
                   the candidate model: escalated records contribute
                   exactly the proxy tier's improvement term; resolved
                   records contribute when they match the proxy *and*
                   differ from m1.
    """
    n = store.n
    if n == 0:
        return {"agree": 1.0, "resolved": 0.0, "improvement": 0.0}
    all_i = _idx(store)
    store.ensure("m1", all_i)
    store.ensure(proxy, all_i)

    def same(decision, out) -> bool:
        # filter decisions are bools; model outputs may be "yes"/"true"
        # text — compare through the executor's one shared parser
        if isinstance(decision, bool):
            return decision == rt.bool_mask([out])[0]
        return bool(semhash.semantic_equal(decision, out))

    agree = 0
    gain = 0.0
    for i in all_i:
        if i in decisions:
            d = decisions[i]
            ok = same(d, store.out(proxy, i))
            agree += ok
            if ok and not same(d, store.out("m1", i)):
                gain += 1.0
        elif not store.eq("m1", proxy, i):
            gain += 1.0
    nres = len(decisions)
    return {"agree": (agree / nres) if nres else 1.0,
            "resolved": nres / n,
            "improvement": gain / n}


def improvement_scores(backends: Dict[str, bk.Backend],
                       op: plan_ir.Operator, values: Sequence,
                       method: str = "approx",
                       meter: Optional[bk.UsageMeter] = None,
                       max_cond_eval: Optional[int] = None,
                       dispatcher: Optional["rt.Dispatcher"] = None,
                       batch_size: int = 1) -> ImprovementResult:
    store = OutputStore(backends, op, values, meter=meter,
                        dispatcher=dispatcher, batch_size=batch_size)
    if method == "approx":
        return improvement_approx(store, max_cond_eval=max_cond_eval)
    return ESTIMATORS[method](store)
