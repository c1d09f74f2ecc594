"""Runs one cell of ``BENCHMARK.json`` once, on the card::

    python3 bench/run.py --workload codeqwen.serve.ops --seed 7 \\
        --seconds 20 --trace 0

Set-up (the model's weights from the seed, the engine or the training
state, every shape the cell's traffic uses) runs first; then the window
measures for ``--seconds``; then the outputs the window produced are held
against the plain reference. With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics read
from torch.profiler over the window. The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key. Exits 2 without a card
(or with fewer cards than the cell asks for), 3 if JAX or the JAX package
is loaded once the window has closed.
"""
import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the script's own directory would shadow modules by its files' names
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             process_start: float, plant=None, marks=()) -> dict:
    """One run of ``cell`` (``spec.load_cell``) on ``device``: the result's
    keys but "device". The mix's ``kind`` names the module that runs it,
    ``bench/<kind>.py``. ``plant``: a fault under the timed path, for the
    tests (that module's ``run`` takes it); ``marks``: (what set-up
    finished, host clock) before the call."""
    from bench import check, spec
    from bench import tracing as tr
    tracer = tr.Tracer(trace)
    tracer.marks += marks
    runner = importlib.import_module(f"bench.{cell['traffic']['kind']}")
    out = runner.run(cell, seed, seconds, tracer, device, plant)
    out["metrics"]["setup_s"] = out["window_start"] - process_start
    phases, last = {}, process_start
    for name, t in tracer.marks:
        phases[name] = t - last
        last = t
    phases.update({"set-up": out["window_start"] - process_start,
                   "window": out["window_s"],
                   "comparison": time.perf_counter() - out["window_start"]
                   - out["window_s"]})
    result = {"attempted": out["attempted"], "failed": out["failed"],
              "sampled": out.get("sampled"), "phases": phases}
    if trace:
        layer = dict(out["layer"])
        layer["trace"] = tracer.read(set(runner.SPANS))
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.metric_reader(m["name"], cell["root"]).read(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        lo, hi = layer["trace"]["window"]
        result["trace"] = {"busy_s": tr.busy_us(layer["trace"]["device"])
                           / 1e6, "window_s": (hi - lo) / 1e6}
        result["breakdown"] = tr.breakdown(layer["trace"])
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    result["metrics"] = metrics
    result["peak"] = out["peak"]
    correct, checks = check.verdict(out["numbers"], cell["limits"])
    result["correct"] = correct and out["failed"] == 0
    result["checks"] = checks
    result["readings"] = {k: v for k, v in out["numbers"].items()
                          if k not in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    marks = [("torch imported", time.perf_counter())]
    from bench import spec
    cell = spec.load_cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    marks.append(("card found", time.perf_counter()))
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   PROCESS_START, marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["peak"]}
    if args.trace:
        device.update(res["trace"])
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device, "sampled": res["sampled"]}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    # numbers read and not held to a limit (PERF.md says why)
    line["readings"] = res["readings"]
    line["checks"] = res["checks"]
    print("seconds: " + ", ".join(f"{k} {v:.3f}"
                                  for k, v in res["phases"].items()),
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
