"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` at
the root of the checkout and loaded with ``ctypes``. The library's file name
carries a hash of the source, the ``csrc`` headers it includes and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. A failed build or load raises.

Each launch is a ``torch.library`` op in the ``repro_torch`` namespace
(``torch.ops.repro_torch.*``): its CUDA implementation launches the kernel
and counts the launch, and its fake implementation gives the kernel's
outputs' shapes and dtypes without launching anything, so that a trace over
fake tensors (``launch.dryrun``) reaches the kernels as the card would.
``register_costs`` gives each op its FLOPs (torch's flop counter,
``torch.utils.flop_counter.flop_registry``) and the bytes it moves
(``OP_BYTES``). The op has no CPU implementation: a CPU tensor that reaches
it raises, and so does a fake tensor of an op without a fake one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "similarity", "ssd_scan", "ssd_scan_bwd", "adamw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
            "cannot be built")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: Path, seen=None) -> list:
    """``path`` and every file it includes with ``#include "..."`` from
    ``csrc``, recursively, each once, in the order first reached."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        header = CSRC / inc.decode()
        if header.is_file():
            _sources(header, seen)
    return seen


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu"):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(name: str, out: Path) -> None:
    """One ``nvcc`` run into a temporary file, renamed into place when it
    succeeds. The compiler's output (with ``-Xptxas -v``'s register and
    shared-memory report) goes to a ``.log`` beside the library."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build the named sources that are not up to date, one ``nvcc`` each,
    all started together; every one has ended when this returns. Returns
    {name: library path}."""
    paths = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            for job in [pool.submit(_compile, n, p) for n, p in todo.items()]:
                job.result()
    return paths


_load_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build([name])[name]))


LAUNCH_LOCK = threading.Lock()


def count_launch(stats: dict) -> None:
    """Add one to a wrapper's launch count. The engine's dispatcher threads
    and the cascade's tier-0 workers launch kernels at once, so every count
    changes under one lock."""
    with LAUNCH_LOCK:
        stats["launches"] += 1


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shapes and dtypes, no storage)."""
    return isinstance(t, FakeTensor)


OP_BYTES: dict = {}


def direct(t) -> bool:
    """Whether a kernel op on ``t`` (of a list, its first tensor) may skip
    the dispatcher: ``t`` real and no dispatch mode active, so nothing but
    the card would see the launch (serving's eager calls, which would pay
    the dispatcher's host time on every launch)."""
    if isinstance(t, list):
        t = t[0]
    return _get_current_dispatch_mode() is None and not isinstance(
        t, FakeTensor)


def call(op, impl, *args):
    """One kernel op: its CUDA implementation ``impl`` called directly
    where ``direct(args[0])``, else through the dispatcher (``op``: fake
    tensors, a trace's counter)."""
    if direct(args[0]):
        return impl(*args)
    return op(*args)


def register_costs(op, *, flops, nbytes) -> None:
    """Register the FLOPs and the bytes of one kernel op
    (``torch.ops.repro_torch.<name>``): ``flops(*args, out_val=...)`` with
    torch's flop counter, ``nbytes(*args)`` in ``OP_BYTES``. Both take the
    op's own arguments (tensors, real or fake, and scalars)."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    if op not in flop_registry:
        register_flop_formula(op, get_raw=True)(flops)
    OP_BYTES[op] = nbytes


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a kernel that has no backward: a
    new tensor from such a kernel carries no graph, so a loss through it
    would get no gradient for its inputs and nothing would say so. Inputs
    that need no gradient, or grad mode off (serving), pass."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel: call it under torch.no_grad() "
            f"or on inputs that need no gradient")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Callers on several threads at once (the cascade's tier-0 workers) wait
    for one build."""
    with _load_lock:
        return _load(name)
