"""Recompute the roofline terms of saved dry-run records from the per-op
trace saved beside each one (``launch.dryrun --save-trace``): when the
analysis changes (its constants, the ring factors), nothing is traced
again.

    PYTHONPATH=src python -m repro_torch.analysis.recompute [dir...]
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.configs import SHAPES
from repro_torch.launch.dryrun import analyse, config_of


def recompute_dir(d: str) -> int:
    n = 0
    for jp in sorted(glob.glob(os.path.join(d, "*.json"))):
        if jp.endswith(".trace.json"):
            continue
        with open(jp) as f:
            rec = json.load(f)
        if rec.get("skipped") or not rec.get("ok"):
            continue
        tp = jp[:-len(".json")] + ".trace.json"
        if not os.path.exists(tp):
            continue
        with open(tp) as f:
            entries = json.load(f)
        cfg = config_of(rec["arch"], rec.get("reduced", False))
        rec.update(analyse(cfg, SHAPES[rec["shape"]], rec["chips"], entries))
        with open(jp, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    return n


if __name__ == "__main__":
    dirs = sys.argv[1:] or ["artifacts/dryrun_torch"]
    for d in dirs:
        print(f"{d}: recomputed {recompute_dir(d)} records")
