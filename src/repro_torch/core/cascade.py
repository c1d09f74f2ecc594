"""Embedding tier-0 semantic cascade (the first device-resident tier).

The cheapest tier in ``cost.DEFAULT_TIERS`` still answers one LLM call per
``batch_size`` rows. This module adds a tier *below* m1 — ``tier0-embed`` —
that scores a whole morsel in **one batched pass through the row-wise
cosine kernel** (``kernels.ops.rowwise_cosine``: the Hopper kernel on the
card, its plain PyTorch version on the CPU): every row embedding is
compared against a predicate anchor embedding (the operator instruction),
and the cosine score routes the row through calibrated confidence bands:

    score >= bands.hi   high-confidence PASS   (filter: keep; no LLM call)
    score <= bands.lo   high-confidence DROP   (filter: remove; no LLM call)
    otherwise           ESCALATE               (the uncertain band goes to
                                                the operator's LLM tier
                                                through the normal
                                                coalescer / sharder path)

This is the same shape real semantic-analytics systems converge on (vector
prefilters below LLM invocation; SEMA-style semantic operators, CAESURA's
cheapest-capable-model routing) — here it is a first-class backend:

* :class:`EmbeddingBackend` implements the ``backends.Backend`` protocol.
  Its ``run_values`` returns raw cosine *scores* (it is a scoring tier, not
  an answering tier), bills one ``tier0-embed`` call per invocation with a
  deterministic modeled latency in the per-tier totals and the **measured**
  kernel wall in ``UsageMeter.call_log`` — so the event scheduler places
  the device pass on the simulated timeline and Table-9 accounting sees the
  cascade.
* :class:`CascadeRouter` holds the backend plus per-operator
  :class:`CascadeBands` and emits the per-morsel pass/drop/escalate
  partition the executor folds around ``run_llm_op``.

Determinism: the embedding of a value and the band thresholds are pure
functions of (operator, value) fixed before execution starts, so the
partition — and therefore which rows reach the LLM tiers, in which morsel,
in which order — is identical across drivers (simulated/threads), shard
counts, and admission order. The three executor invariance guarantees hold
with the cascade enabled (test-enforced in ``tests/test_cascade.py``).

Band thresholds come either from the physical optimizer (calibrated
against the capability sample — see ``physical_optimizer`` +
``improvement.improvement_cascade``) or from ``default_bands`` for
serve-style blanket enablement (``launch/serve.py --cascade``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Protocol, Sequence

import numpy as np
import torch

from repro_torch.core import backends as bk
from repro_torch.core import cost as cost_mod
from repro_torch.core import plan as plan_ir
from repro_torch.core import semhash
from repro_torch.kernels import ops as kops

# numeric offsets for resolved RANK rows: pass-band rows sort above every
# escalated row, escalated rows (rescored by the LLM, normalized to (0,1))
# sort above every drop-band row — cosine in [-1, 1] cannot cross an offset
_RANK_PASS_OFFSET = 10.0
_RANK_DROP_OFFSET = -10.0


class Encoder(Protocol):
    """Embedding provider for the cascade: anchor = the predicate,
    values = the rows. Rows must come back L2-normalized."""

    def encode_anchor(self, op: plan_ir.Operator) -> np.ndarray:
        ...

    def encode_values(self, op: plan_ir.Operator,
                      values: Sequence[Any]) -> np.ndarray:
        ...


class HashingEncoder:
    """Default dependency-free encoder: the ``semhash`` n-gram hasher
    (the repo's Sentence-BERT stand-in). Real deployments would swap in a
    learned sentence encoder behind the same protocol."""

    def encode_anchor(self, op: plan_ir.Operator) -> np.ndarray:
        return semhash.embed_one(op.instruction)

    def encode_values(self, op: plan_ir.Operator,
                      values: Sequence[Any]) -> np.ndarray:
        return semhash.embed(list(values))


def _kernel_scores(vals: np.ndarray, anchor: np.ndarray,
                   device) -> np.ndarray:
    """One batched device pass: rowwise cosine of every value embedding
    against the anchor, a (D,) row the kernel reads for every value. The
    embeddings go to ``device`` and the scores come back inside this call,
    so a caller's wall clock covers the whole pass. A failure raises."""
    sims = kops.rowwise_cosine(torch.from_numpy(vals).to(device),
                               torch.from_numpy(anchor).to(device))
    return sims.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class CascadeBands:
    """Calibrated confidence bands. ``lo <= hi``; rows with
    ``lo < score < hi`` escalate. ``lo == hi`` means nothing escalates
    (boundary scores pass); ``lo=-2, hi=2`` escalates everything (the
    cascade becomes a no-op plus one scoring pass per morsel)."""
    lo: float
    hi: float

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"cascade bands lo {self.lo} > hi {self.hi}")


# blanket-enable default (serve --cascade without per-op calibration):
# conservative band — only strongly-anchored rows resolve on-device
DEFAULT_BANDS = CascadeBands(lo=-0.35, hi=0.35)


class EmbeddingBackend:
    """``tier0-embed``: the device-resident scoring backend.

    ``run_values`` returns the rows' cosine scores against the operator's
    anchor (floats — the :class:`CascadeRouter` thresholds them; this
    backend is never assigned as an operator's answering tier). One
    invocation = one batched kernel pass = one metered call:

    * per-tier totals bill a **modeled** latency
      (``EMBED_TIER.latency_call_s + rows * EMBED_ROW_S``) so meter totals
      stay byte-identical across drivers and shard counts;
    * ``call_log`` carries the **measured** kernel wall, so the simulated
      event timeline and threaded pools schedule the real device cost.

    ``device`` is where the scores are computed: the card by default,
    ``"cpu"`` for the kernel's plain version.
    """

    def __init__(self, encoder: Optional[Encoder] = None,
                 tier: Optional[cost_mod.TierSpec] = None, device="cuda"):
        self.encoder = encoder if encoder is not None else HashingEncoder()
        self.tier = tier if tier is not None else cost_mod.EMBED_TIER
        self.device = torch.device(device)
        self._anchors: Dict[tuple, np.ndarray] = {}
        self._alock = threading.Lock()

    def __getstate__(self):
        # not shipped to the procs driver's worker processes: the scoring
        # runs on this process's device
        raise TypeError("EmbeddingBackend scores on its process's device "
                        "and stays there")

    def _anchor(self, op: plan_ir.Operator) -> np.ndarray:
        key = (op.kind, op.instruction, op.input_column)
        with self._alock:
            a = self._anchors.get(key)
        if a is None:
            a = np.asarray(self.encoder.encode_anchor(op), np.float32)
            with self._alock:
                self._anchors[key] = a
        return a

    def scores(self, op: plan_ir.Operator,
               values: Sequence[Any]) -> np.ndarray:
        """Unmetered scoring (calibration-time use)."""
        values = list(values)
        if not values:
            return np.zeros((0,), np.float32)
        vals = np.asarray(self.encoder.encode_values(op, values),
                          np.float32)
        return _kernel_scores(vals, self._anchor(op), self.device)

    def run_values(self, op: plan_ir.Operator, values: Sequence[Any],
                   meter: Optional[bk.UsageMeter] = None,
                   batch_size: int = 1) -> List[Any]:
        values = list(values)
        t0 = time.perf_counter()
        sims = self.scores(op, values)
        measured = time.perf_counter() - t0
        if meter is not None and values:
            tok_in = sum(cost_mod.text_tokens(v) for v in values)
            modeled = (self.tier.latency_call_s
                       + len(values) * cost_mod.EMBED_ROW_S)
            usage = bk.Usage(calls=1, tok_in=tok_in, tok_out=0.0,
                             usd=self.tier.usd(tok_in, 0.0),
                             latency_s=modeled)
            meter.record(self.tier.name, usage,
                         per_call_latency_s=[measured], op_kind=op.kind)
        return [float(s) for s in sims]


class CascadePartition:
    """One morsel's routing decision: ``resolved[i]`` holds the on-device
    answer for pass/drop rows (filter: bool; rank: offset composite score)
    and ``None`` for rows in ``escalate`` (indices into ``values``, in row
    order). ``merge`` folds the escalated rows' LLM outputs back into a
    full per-row output list shaped for ``runtime.apply_outputs``."""

    __slots__ = ("op", "resolved", "escalate", "n_pass", "n_drop", "finish")

    def __init__(self, op: plan_ir.Operator, resolved: List[Any],
                 escalate: List[int], n_pass: int, n_drop: int,
                 finish: float):
        self.op = op
        self.resolved = resolved
        self.escalate = escalate
        self.n_pass = n_pass
        self.n_drop = n_drop
        self.finish = finish

    def merge(self, esc_outs: Sequence[Any]) -> List[Any]:
        if len(esc_outs) != len(self.escalate):
            raise ValueError(
                f"cascade merge: {len(self.escalate)} escalated rows but "
                f"{len(esc_outs)} LLM outputs")
        full = list(self.resolved)
        if self.op.kind == plan_ir.RANK:
            # escalated rows keep their LLM-judged *ordering*, normalized
            # into (0, 1) so the middle block slots between the pass band
            # (offset +10 + cosine) and the drop band (offset -10 + cosine)
            from repro_torch.core import runtime as rt
            sims = rt.rank_scores(list(esc_outs))
            order = sorted(range(len(sims)), key=lambda j: sims[j],
                           reverse=True)          # stable: ties keep row order
            k = len(order)
            for pos, j in enumerate(order):
                full[self.escalate[j]] = 1.0 - (pos + 1) / (k + 1)
            return full
        for j, i in enumerate(self.escalate):
            full[i] = esc_outs[j]
        return full


class CascadeRouter:
    """Routing layer between the executor's morsel stream and the LLM
    dispatch path. Holds one :class:`EmbeddingBackend` plus band
    thresholds: per-operator calibrated bands (``set_bands``; installed by
    the physical optimizer) with an optional ``default_bands`` fallback
    (blanket enablement). An operator cascades iff it is a non-UDF
    SEM_FILTER/RANK predicate and bands are available for it."""

    KINDS = (plan_ir.FILTER, plan_ir.RANK)

    def __init__(self, backend: Optional[EmbeddingBackend] = None,
                 default_bands: Optional[CascadeBands] = None):
        self.backend = backend if backend is not None else EmbeddingBackend()
        self.default_bands = default_bands
        self._bands: Dict[tuple, CascadeBands] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _sig(op: plan_ir.Operator) -> tuple:
        return (op.kind, op.instruction, op.input_column)

    def set_bands(self, op: plan_ir.Operator, bands: CascadeBands) -> None:
        with self._lock:
            self._bands[self._sig(op)] = bands

    def bands_for(self, op: plan_ir.Operator) -> Optional[CascadeBands]:
        with self._lock:
            b = self._bands.get(self._sig(op))
        return b if b is not None else self.default_bands

    def active_for(self, op: plan_ir.Operator) -> bool:
        return (op.udf is None and op.kind in self.KINDS
                and self.bands_for(op) is not None)

    def partition(self, op: plan_ir.Operator, values: Sequence[Any],
                  disp, meter: bk.UsageMeter, *, ready: float = 0.0,
                  shard: int = 0,
                  key: Optional[tuple] = None) -> CascadePartition:
        """Score one morsel's rows (one ``tier0-embed`` call through the
        dispatcher: billed on the morsel's shard, placed on the event
        timeline) and band-route them. Deterministic given (op, values).

        Failure contract: exceptions propagate to the caller — the
        executor's ``cascade_partition`` catches them and *degrades*
        (escalates the whole morsel to the LLM tier, byte-identical to a
        no-cascade run) instead of failing the query; an active
        ``CallPolicy`` additionally retries the embed call below the
        dispatcher before the failure ever surfaces here."""
        bands = self.bands_for(op)
        values = list(values)
        # the device pass rides the dispatcher like any backend call —
        # batch_size=len(values) keeps it one kernel launch per morsel
        sims, finish = disp.run_llm(
            op, values, self.backend, self.backend.tier.name, meter,
            batch_size=max(1, len(values)), cache=None, ready_s=ready,
            shard=shard, key=key)
        resolved: List[Any] = [None] * len(values)
        escalate: List[int] = []
        n_pass = n_drop = 0
        is_rank = op.kind == plan_ir.RANK
        for i, s in enumerate(sims):
            if s >= bands.hi:
                resolved[i] = (_RANK_PASS_OFFSET + s) if is_rank else True
                n_pass += 1
            elif s <= bands.lo:
                resolved[i] = (_RANK_DROP_OFFSET + s) if is_rank else False
                n_drop += 1
            else:
                escalate.append(i)
        return CascadePartition(op, resolved, escalate, n_pass, n_drop,
                                finish)


def calibrate_bands(scores: Sequence[float], ref_outs: Sequence[Any],
                    kind: str, margin: float = 0.02
                    ) -> Optional[CascadeBands]:
    """Derive bands from a capability sample's scores + reference outputs
    (the operator's selected tier — the cascade's escalation target, so
    agreement with it is the right yardstick).

    FILTER: conservative separation — pass only above every sample
    negative, drop only below every sample positive (+/- margin), so the
    cascade disagrees with the reference on zero sample rows; overlapping
    classes widen the escalation band instead of guessing. RANK: the
    middle two quartiles of the score distribution escalate for LLM
    re-ordering; the tails keep their embedding order."""
    scores = [float(s) for s in scores]
    if not scores:
        return None
    if kind == plan_ir.RANK:
        lo = float(np.percentile(scores, 25.0))
        hi = float(np.percentile(scores, 75.0))
        return CascadeBands(lo=min(lo, hi), hi=max(lo, hi))
    from repro_torch.core import runtime as rt
    mask = rt.bool_mask(list(ref_outs))
    pos = [s for s, m in zip(scores, mask) if m]
    neg = [s for s, m in zip(scores, mask) if not m]
    if pos and neg:
        hi = max(neg) + margin
        lo = min(pos) - margin
        if lo > hi:                  # separable sample: nothing uncertain
            mid = 0.5 * (lo + hi)
            lo = hi = mid
    elif neg:
        # no sample positive: never auto-pass; drop at/below the sample
        # negatives' ceiling, escalate anything stronger
        hi = 2.0
        lo = max(neg) + margin
        lo = min(lo, hi)
    elif pos:
        lo = -2.0
        hi = min(pos) - margin
    else:
        return None
    return CascadeBands(lo=lo, hi=hi)
