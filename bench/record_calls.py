"""Records the model calls of the system's own semantic queries as a
serving mix's trace, on the CPU (no model runs)::

    python3 bench/record_calls.py --rows 250 \\
        --out bench/traffic/ops_calls.jsonl

Every workload query of the movie, estate and game datasets runs through
the port's executor over each table's first ``--rows`` rows, every tier
answering as the oracle does. Each call is kept as the prompt
``TorchBackend`` renders for it (one input value a prompt; a reduce's
values joined into one) and the tokens a model that answers as the oracle
does would generate: the answer's bytes and the end token, at most the
``max_new_tokens`` that ``TorchBackend`` asks for. One JSON line for each
distinct call, with how often it was made, in the order first made. The
benchmark's runs do not run this; they read the file.
"""
import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]

DATASETS = ("movie", "estate", "game")


def trace(rows: int) -> list:
    """The distinct calls, each {"op", "prompt", "new_tokens", "count"}."""
    from bench import program
    cap = program.max_new_tokens()
    counts = collections.Counter()
    for dataset in DATASETS:
        for op, prompt, answer in program.semantic_calls(dataset, rows):
            new = min(cap, len(str(answer).encode("utf-8")) + 1)
            counts[(op, prompt, new)] += 1
    return [{"op": op, "prompt": prompt, "new_tokens": new, "count": n}
            for (op, prompt, new), n in counts.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=250)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(args.out, "w") as f:
        for line in trace(args.rows):
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
