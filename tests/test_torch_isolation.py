"""The port stands alone: no file of ``src/repro_torch/`` nor
``chip_smoke.py`` imports JAX, Flax, Optax or the ``repro`` package, and its
entry points run on the card unless the caller asks for the CPU."""
import ast
import inspect
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "repro")


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_nothing_of_jax_or_repro(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.configs import x\n"
                 "import importlib\nimportlib.import_module('repro.models')\n"
                 "from repro_torch import configs\n")
    assert [m for m in imported_modules(f) if m.split(".")[0] in FORBIDDEN] \
        == ["jax.numpy", "repro.configs", "repro.models"]


def test_entry_points_default_to_cuda():
    from repro_torch import convert
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import cascade, semhash
    from repro_torch.engine import GenerationEngine
    from repro_torch.launch import serve
    from repro_torch.models import registry, transformer
    bundle = registry.build(reduced(get_config("qwen2-0.5b")))
    for fn in (transformer.init, transformer.init_cache, bundle.init,
               bundle.init_cache, GenerationEngine.__init__,
               convert.params_from_numpy, cascade.EmbeddingBackend.__init__,
               semhash.semantic_equal_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert serve.build_parser().parse_args([]).device == "cuda"
    assert serve.build_parser().parse_args(
        ["--semantic", "movie", "--serve", "4", "--cascade"]).device == "cuda"
    assert cascade.CascadeRouter().backend.device == torch.device("cuda")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler raises; nothing falls back to the plain path."""
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
