"""Time ``chip_smoke.py`` of one or more checkouts by phase, in turn, on one
card.

    python3 src/repro_torch/analysis/smoke_phases.py --out DIR ROOT [ROOT...]

Each ROOT is a checkout of this repository (``git archive <commit>``
unpacked into a directory that .gitignore lists, for instance). Its
``chip_smoke.py`` runs from that root; every line it prints is stamped
with the seconds since the run began and kept in ``DIR/<n>.log``
(standard error in ``DIR/<n>.err``). A JSON line with a ``phase`` is
charged the seconds since the JSON line before it, which is the time its
phase took where a phase prints once, at its end. The last line printed
here is a JSON summary: per root, its exit code, its seconds, the seconds
charged to each phase, and each phase's ``new_tok_per_s``,
``device_idle_share`` and ``idle_share_of_median_step`` where it prints
them; and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

KEPT = ("new_tok_per_s", "device_idle_share", "idle_share_of_median_step",
        "median_step_s")


def run(root, out_dir, n, timeout):
    log_path = os.path.join(out_dir, f"{n}.log")
    err_path = os.path.join(out_dir, f"{n}.err")
    phases, numbers = {}, {}
    t0 = last = time.perf_counter()
    with open(log_path, "w") as log, open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=root,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True, bufsize=1)
        try:
            for line in proc.stdout:
                now = time.perf_counter()
                log.write(f"{now - t0:10.2f} {line}")
                log.flush()
                if not line.startswith("{"):
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                name = obj.get("phase") if isinstance(obj, dict) else None
                if name is None:
                    continue
                phases[name] = phases.get(name, 0.0) + (now - last)
                last = now
                kept = {k: obj[k] for k in KEPT if k in obj}
                if kept:
                    numbers.setdefault(name, {}).update(kept)
            rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter()
                                                       - t0)))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"root": root, "rc": rc, "seconds": time.perf_counter() - t0,
            "phase_seconds": phases, "numbers": numbers}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200.0)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs = []
    for n, root in enumerate(args.roots):
        res = run(os.path.abspath(root), args.out, n, args.timeout)
        print(json.dumps({"root": res["root"], "rc": res["rc"],
                          "seconds": res["seconds"]}), flush=True)
        runs.append(res)
    print(json.dumps({"card": smi, "runs": runs}))
    sys.exit(max(abs(r["rc"]) for r in runs))


if __name__ == "__main__":
    main()
