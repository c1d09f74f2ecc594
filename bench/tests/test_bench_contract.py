"""BENCHMARK.json as the benchmark's contract has it, and each
configuration file as the program runs it: the port's config with every
size the file states, its ``port_fields`` included; a key the port cannot
take is refused; its architecture has its reference."""
import json
import re

import pytest

from bench import program, spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("work", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_its_files_and_metrics(work):
    cell = spec.load_cell(work["name"])
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e
        assert hasattr(spec.metric_reader(m["name"]), "read")
    assert cell["limits"]
    ref = spec.reference(cell["config"])
    assert all(callable(getattr(ref, f, None))
               for f in ("forward", "loss", "counts"))


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_port_config_as_run(entry):
    cfg = spec._json(spec.ROOT / entry["file"])
    assert cfg["source"] == entry["source"]
    run = program.model_config(cfg)
    for key, field in program.FIELDS.items():
        if key in cfg:
            assert getattr(run, field) == cfg[key], key
    for key, field in program.MOE_FIELDS.items():
        if key in cfg:
            assert getattr(run.moe, field) == cfg[key], key
    for key, path in cfg.get("port_fields", {}).items():
        value = run
        for name in path.split("."):
            value = getattr(value, name)
        want = cfg[key]
        assert value == (tuple(want) if isinstance(want, list) else want), key
    assert set(cfg["reduced_from"]) == set(entry["reduced"])
    mapped = {**program.FIELDS, **program.MOE_FIELDS,
              **cfg.get("port_fields", {})}
    for key in cfg["reduced_from"]:
        assert key in mapped and key in cfg


@pytest.mark.parametrize("key", ["state_size", "conv_kernel"])
def test_config_key_the_port_does_not_take_is_refused(key):
    cfg = dict(spec._json(spec.ROOT / BENCH["configs"][0]["file"]))
    cfg[key] = 64
    with pytest.raises(KeyError, match=key):
        program.model_config(cfg)
