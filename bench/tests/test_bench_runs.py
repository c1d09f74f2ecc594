"""Whole runs of tiny cells on the CPU, the harness's look for a card
skipped: a sound run is correct; each fault a cell can have, planted under
the timed path, and the control (the reference in the next lower
precision put in the program's place) make it not correct."""
import time

import pytest

from bench import check, faults, serve, spec, train
from bench.run import run_cell
from bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, name, plant=None, seed=11):
    cell = spec.load_cell(name, root)
    return run_cell(cell, seed, 1.0, False, "cpu", time.perf_counter(),
                    plant)


@pytest.mark.parametrize("name", list(tiny.CELLS))
def test_sound_run_is_correct(root, name):
    res = _run(root, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = spec.load_cell(name, root)
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert set(res["checks"]) == set(cell["limits"])


@pytest.mark.parametrize("name", ["tiny.train", "tiny.moe.train"])
@pytest.mark.parametrize("fault", [faults.unchanged_state, faults.half_batch],
                         ids=["unchanged_state", "half_batch"])
def test_training_fault_is_not_correct(root, name, fault):
    assert not _run(root, name, fault)["correct"]


def test_altered_token_is_not_correct(root):
    res = _run(root, "tiny.serve", lambda server: faults.alter_tokens(
        server.rec))
    assert not res["correct"]
    assert res["checks"]["served_gap"]["value"] > \
        res["checks"]["served_gap"]["limit"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_serve_control_fails_and_program_passes(root, seed):
    cell = spec.load_cell("tiny.serve", root)
    lines = list(serve.readings(cell, [seed], 1, 1.0, "cpu"))
    ok, _ = check.verdict(lines[0]["program"], cell["limits"])
    bad, _ = check.verdict(lines[0]["control"], cell["limits"])
    fault, _ = check.verdict(lines[0]["fault_altered_token"], cell["limits"])
    assert ok and not bad and not fault


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_train_control_fails_and_program_passes(root, seed):
    cell = spec.load_cell("tiny.train", root)
    line = next(train.readings(cell, [seed], 1, 0.0, "cpu"))
    assert check.verdict(line["program"], cell["limits"])[0]
    assert not check.verdict(line["control"], cell["limits"])[0]
    assert not check.verdict(line["fault_half_batch"], cell["limits"])[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["codeqwen.serve.ops", "codeqwen.train.4k",
                                  "granite.train.4k"])
def test_control_fails_at_the_cells_size(card, name):
    """On the card at the cell's own size: the program within its limits,
    the control and each fault outside them, on three seeds."""
    cell = spec.load_cell(name)
    seeds = [2_100_000_001 + 7919 * i for i in range(3)]
    runner = serve if cell["traffic"]["kind"] == "serve" else train
    lines = runner.readings(cell, seeds, 3, 20.0, card)
    for line in lines:
        assert check.verdict(line["program"], cell["limits"])[0], line
        assert not check.verdict(line["control"], cell["limits"])[0], line
        for key in line:
            if key.startswith("fault_"):
                assert not check.verdict(line[key], cell["limits"])[0], line
