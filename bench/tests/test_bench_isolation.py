"""What the benchmark may import: nothing whose top-level name is JAX's,
the JAX package's (``repro``, compared whole: ``repro_torch`` is the
program) or ``benchmarks``; and the reference nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imported(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_nor_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


def test_the_comparison_is_by_whole_names():
    src = "import repro_torch.models\nfrom repro_torch import x\n"
    tmp = BENCH / "tests" / "_probe_unused.py"
    try:
        tmp.write_text(src)
        assert imported(tmp) == {"repro_torch"}
        assert not imported(tmp) & FORBIDDEN
    finally:
        tmp.unlink()


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in imported(path), path
        assert not imported(path) & FORBIDDEN, path


def test_only_the_program_module_imports_the_program():
    """The harness reaches the port through ``bench/program.py`` alone; the
    tests compare against it directly."""
    users = {p.relative_to(BENCH).as_posix() for p in SOURCES
             if "repro_torch" in imported(p)}
    assert {u for u in users if not u.startswith("tests/")} <= {
        "program.py"}, users


def test_run_refuses_when_jax_is_loaded(monkeypatch):
    import sys
    import types
    from bench import run
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "repro_torch_extra",
                        types.ModuleType("z"))
    assert run.forbidden_modules() == ["jax", "repro"]
