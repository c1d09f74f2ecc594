"""Finds a cell's files by name: ``BENCHMARK.json`` names the cell, its
configuration and traffic; each lives in a file of its own under
``bench/``, so a later change adds a cell, a mix, a metric or the
reference of a new architecture by adding files and entries, never by
editing one."""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


class Config(dict):
    """A configuration file's keys, and ``root``, the root it was read
    from: its reference is found there."""

    def __init__(self, keys: dict, root: Path = ROOT):
        super().__init__(keys)
        self.root = Path(root)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name``: its workload entry, its configuration (the file
    ``BENCHMARK.json`` names, a ``Config`` of this root), its traffic mix
    (``bench/traffic/<traffic>.json``, with the trace of calls it names
    read in), its correctness limits
    (``bench/limits/<cell>.json``), and the end-to-end and per-layer
    metrics it reports."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(it has {sorted(work)})")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    traffic = _json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    if "calls" in traffic:
        with open(root / "bench" / "traffic" / traffic["calls"]) as f:
            traffic["calls"] = [json.loads(line) for line in f]
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"name": name, "root": root, "workload": w,
            "config": Config(_json(root / cfg_entry["file"]), root),
            "traffic": traffic,
            "limits": _json(root / "bench" / "limits" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


@functools.lru_cache(maxsize=None)
def _module(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The module ``bench/metrics/<name>.py``: its ``read(run)`` returns
    the metric's value, or None where the run holds nothing to read."""
    return _module(Path(root) / "bench" / "metrics" / f"{name}.py",
                   "bench_metric_")


def reference(cfg: dict):
    """The plain reference of the configuration's architecture: the module
    ``bench/reference/<cfg["reference"]>.py`` (``model`` where the file
    names none) under the root the configuration was read from
    (``spec.ROOT`` for a plain dict). ``bench/reference/__init__.py``
    states what it exports."""
    path = (Path(getattr(cfg, "root", ROOT)) / "bench" / "reference"
            / f"{cfg.get('reference', 'model')}.py")
    return _module(path, "bench_reference_")
