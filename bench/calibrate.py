"""The readings each correctness limit is set from, for one cell, on the
card, in one process::

    python3 bench/calibrate.py --workload codeqwen.serve.ops --seeds 12 \\
        --controls 3 --seconds 8 --out build/cal/ops.jsonl

For each seed, the program's numbers (as a run compares them); for the
first ``--controls`` seeds also the control's (the reference in the
nearest precision below the configuration's, put in the program's place:
TF32 for fp32 serving, fp8 for bf16 training) and each fault's that the
cell can have (``bench/faults.py``): the ``readings`` of the module that
runs the cell's mix. One JSON line a seed. The benchmark's own runs do not
run this.
"""
import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    from bench import spec
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    runner = importlib.import_module(f"bench.{cell['traffic']['kind']}")
    readings = runner.readings(cell, seeds, args.controls, args.seconds,
                               "cuda")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(args.out, "a") as f:
        for line in readings:
            line = dict(line, workload=args.workload,
                        t=time.perf_counter() - t0)
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
