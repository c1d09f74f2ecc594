"""Per-(op kind, tier) q-error reporting for a calibrated CostModel.

The q-error ``max(pred/meas, meas/pred)`` is cardinality estimation's
standard symmetric error, applied here to per-call latency and output
tokens: 1.0 is perfect, 3.0 means the prediction is off by 3x in either
direction. The rows come from :meth:`CostModel.qerror_report` — EWMA
state the model accumulated at its observe sync points — rendered as an
aligned text table (``launch/serve.py --explain-cost``) or a JSON
document for tooling.
"""
from __future__ import annotations

import json
from typing import List, Optional

_COLUMNS = (
    ("op", "{}", 10),
    ("tier", "{}", 12),
    ("calls", "{:d}", 6),
    ("prior_latency_s", "{:.4f}", 9),
    ("pred_latency_s", "{:.4f}", 9),
    ("meas_latency_s", "{:.4f}", 9),
    ("qerror", "{:.3f}", 7),
    ("prior_qerror", "{:.3f}", 7),
    ("tok_qerror", "{:.3f}", 7),
)
_HEADERS = {"prior_latency_s": "prior", "pred_latency_s": "pred",
            "meas_latency_s": "meas", "prior_qerror": "q-prior",
            "tok_qerror": "q-tok", "qerror": "q-err"}


def report_rows(model) -> List[dict]:
    """The model's calibration table (sorted by (op, tier); empty until
    the model has observed at least one typed call)."""
    return model.qerror_report()


def median_qerror(rows: List[dict], field: str = "qerror"
                  ) -> Optional[float]:
    vals = sorted(r[field] for r in rows)
    if not vals:
        return None
    mid = len(vals) // 2
    if len(vals) % 2:
        return vals[mid]
    return 0.5 * (vals[mid - 1] + vals[mid])


def to_json(model, indent: int = 2) -> str:
    rows = report_rows(model)
    doc = {
        "rows": rows,
        "median_qerror": median_qerror(rows),
        "median_prior_qerror": median_qerror(rows, "prior_qerror"),
        "latency_weight": model.latency_weight,
        "ewma_alpha": model.ewma_alpha,
    }
    adm = model.admission_report()
    if adm["observations"] > 0:
        doc["admission"] = adm
    return json.dumps(doc, indent=indent, sort_keys=True)


def render_text(model) -> str:
    """Aligned per-(op, tier) table plus a median summary line."""
    rows = report_rows(model)
    if not rows:
        return ("cost model: no calibration data "
                "(no typed calls observed yet)")
    header = "  ".join(_HEADERS.get(name, name).rjust(width)
                       if name not in ("op", "tier")
                       else _HEADERS.get(name, name).ljust(width)
                       for name, _, width in _COLUMNS)
    lines = [header, "-" * len(header)]
    for r in rows:
        cells = []
        for name, fmt, width in _COLUMNS:
            s = fmt.format(r[name])
            cells.append(s.ljust(width) if name in ("op", "tier")
                         else s.rjust(width))
        lines.append("  ".join(cells))
    med = median_qerror(rows)
    med_prior = median_qerror(rows, "prior_qerror")
    lines.append(f"median q-error {med:.3f} (uncalibrated prior would be "
                 f"{med_prior:.3f})")
    # admission-gate accuracy: whole-plan makespan predictions the
    # QueryServer's controller fed back via observe_makespan
    adm = model.admission_report()
    if adm["observations"] > 0:
        lines.append(
            f"admission makespan: {adm['observations']} observations, "
            f"q-error ewma {adm['qerr_ewma']:.3f} "
            f"last {adm['qerr_last']:.3f} max {adm['qerr_max']:.3f} "
            f"(correction ratio {adm['ratio']:.4f})")
    return "\n".join(lines)
