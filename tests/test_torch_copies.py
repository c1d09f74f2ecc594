"""The port's copies of the JAX package's pure-Python modules stay copies.

The port imports nothing of ``repro``, so it keeps its own copy of every
module of the semantic path that imports no JAX: plan IR, tables, UDFs, the
cost model, backends, runtime, optimizers, datasets, workloads, the query
server, the q-error report, the process shard workers and the test
fakes. A copy may differ from its original only in its import prefix
(``repro.`` becomes ``repro_torch.``) and in its docstrings. So after the prefix is renamed and the docstrings
are stripped, both syntax trees must dump alike.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = [
    "core/__init__.py", "core/plan.py", "core/table.py", "core/udf.py",
    "core/cost_model.py", "core/cost.py", "core/backends.py",
    "core/runtime.py", "core/improvement.py",
    "core/judge.py", "core/rules.py", "core/rewriter.py",
    "core/logical_optimizer.py", "core/physical_optimizer.py",
    "core/dataframe.py", "data/__init__.py", "data/oracle.py",
    "data/movie.py", "data/estate.py", "data/game.py", "data/workloads.py",
    "data/tokenizer.py", "data/pipeline.py", "launch/query_server.py", "analysis/qerror.py",
    "configs/qwen2_0_5b.py", "configs/mamba2_1_3b.py",
    "configs/hymba_1_5b.py", "configs/codeqwen1_5_7b.py",
    "configs/granite_moe_1b_a400m.py", "configs/minicpm3_4b.py",
    "configs/internvl2_76b.py", "configs/seamless_m4t_large_v2.py",
    "configs/deepseek_67b.py", "configs/llama4_scout_17b_a16e.py",
    "testing.py",
    "distributed/process_workers.py",
]
# Ported, not copied, so not held to the copy rule:
# * core/semhash.py: semantic_equal_batch runs on an explicit device through
#   the port's kernel and has no numpy fallback;
# * core/cascade.py: EmbeddingBackend takes a device, refuses to pickle
#   (it stays with its device, out of the process workers), and
#   _kernel_scores passes the anchor as one (D,) row with no fallback;
# * core/executor.py: an uncoalesced LLM operator's morsels claim the
#   output cache in morsel order, so the threaded driver bills what the
#   simulated one bills;
# * distributed/morsel_shards.py: a chain task cancelled by a shard's
#   death re-runs at once on a thread of its own, because the executor's
#   morsel-ordered claims can block every chain thread of a survivor;
# * engine/torch_backend.py, launch/serve.py: drive the port's engine;
# * models/encdec.py: a Python loop over the stacked layers replaces
#   lax.scan, and every attention goes through the port's kernels (flash
#   attention for the encoder, the decoder and cross-attention, decode
#   attention over the self and the encoder cache);
# * analysis/roofline.py, analysis/recompute.py, launch/dryrun.py: the
#   reference parses compiled HLO; the port traces one rank's ops over a
#   fake process group (a TorchDispatchMode under DTensor) at the H100's
#   constants.
PORTED = ["core/semhash.py", "core/cascade.py", "core/executor.py",
          "distributed/morsel_shards.py", "models/encdec.py",
          "analysis/roofline.py", "analysis/recompute.py",
          "launch/dryrun.py"]


def _rename(name):
    if name == "repro" or name.startswith("repro."):
        return "repro_torch" + name[len("repro"):]
    return name


def normalized(path, rename):
    """ast.dump of the module without docstrings, its import prefix renamed
    where ``rename``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if rename and isinstance(node, ast.ImportFrom) and node.module:
            node.module = _rename(node.module)
        if rename and isinstance(node, ast.Import):
            for alias in node.names:
                alias.name = _rename(alias.name)
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIES)
def test_port_module_is_a_copy(module):
    original = ROOT / "src" / "repro" / module
    copy = ROOT / "src" / "repro_torch" / module
    assert normalized(copy, rename=False) == normalized(original, rename=True)


@pytest.mark.parametrize("module", PORTED)
def test_ported_module_differs_from_its_original(module):
    """The modules listed as ported really carry port work: were one of
    them a plain copy, it would belong in COPIES."""
    original = ROOT / "src" / "repro" / module
    copy = ROOT / "src" / "repro_torch" / module
    assert normalized(copy, rename=False) != normalized(original, rename=True)


def test_guard_catches_a_changed_copy(tmp_path):
    """A changed statement fails the comparison; a changed docstring and the
    renamed import prefix do not."""
    orig = tmp_path / "a.py"
    orig.write_text('"""Doc."""\nfrom repro.core import plan\nX = 1\n')
    same = tmp_path / "b.py"
    same.write_text('"""Other doc."""\nfrom repro_torch.core import plan\n'
                    'X = 1\n')
    changed = tmp_path / "c.py"
    changed.write_text('from repro_torch.core import plan\nX = 2\n')
    want = normalized(orig, rename=True)
    assert normalized(same, rename=False) == want
    assert normalized(changed, rename=False) != want
