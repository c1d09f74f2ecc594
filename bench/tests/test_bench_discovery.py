"""The harness finds a cell, its configuration, its traffic mix, its
limits and a per-layer metric by name, from files alone: a root made in a
temporary directory holds a new cell and a new metric, and nothing of the
harness is edited."""
import json
import time

from bench import spec
from bench.run import run_cell
from bench.tests import tiny

NEW_METRIC = '''"""A metric added as a file: generated tokens a second."""


def read(run):
    if run.get("kind") != "serve":
        return None
    return run["generated_tokens"] / run["window_s"]
'''


def test_new_cell_and_metric_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "bench" / "metrics" / "gen_tok_s.py").write_text(NEW_METRIC)
    mix = dict(tiny.SERVE, callers=2, morsel=1)
    (root / "bench" / "traffic" / "short.json").write_text(json.dumps(mix))
    (root / "bench" / "limits" / "tiny.serve.short.json").write_text(
        json.dumps({"logit_err": 1e-4, "served_gap": 0.1}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.serve.short", "config": "dense",
                               "traffic": "short", "chips": 1, "why": "t"})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_tok_s", "request_p95_s"):
            m["workloads"].append("tiny.serve.short")
    bench["per_layer"].append({"name": "gen_tok_s", "unit": "tokens/s",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "engine scheduler and tick",
                               "moves": "serve_tok_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("tiny.serve.short", root)
    assert cell["traffic"]["callers"] == 2
    assert "gen_tok_s" in {m["name"] for m in cell["per_layer"]}
    assert "gen_tok_s" not in {m["name"] for m in
                               spec.load_cell("tiny.train", root)["per_layer"]}
    res = run_cell(cell, 7, 1.0, False, "cpu", time.perf_counter())
    assert res["correct"] and "serve_tok_s" in res["metrics"]
    reader = spec.metric_reader("gen_tok_s", root)
    assert reader.read({"kind": "serve", "generated_tokens": 50,
                        "window_s": 2.0}) == 25.0


RUNNER = '''"""A runner added as a file: the mix's kind names it."""
SPANS = ()


def run(cell, seed, seconds, tracer, device, plant=None):
    with tracer.window():
        pass
    return {"window_start": 0.0, "window_s": seconds, "attempted": 1,
            "failed": 0, "metrics": {"probe_s": seconds}, "peak": 0,
            "layer": {}, "numbers": {"probe_err": 0.0}}
'''


def test_runner_found_by_the_mix_kind(tmp_path, monkeypatch):
    import importlib.util
    import sys
    path = tmp_path / "probe.py"
    path.write_text(RUNNER)
    mod_spec = importlib.util.spec_from_file_location("bench.probe", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    monkeypatch.setitem(sys.modules, "bench.probe", mod)
    cell = {"traffic": {"kind": "probe"}, "end_to_end": [
        {"name": "probe_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [], "limits": {"probe_err": 0.0}}
    res = run_cell(cell, 1, 2.0, False, "cpu", 0.0)
    assert res["correct"] and res["metrics"]["probe_s"]["value"] == 2.0
