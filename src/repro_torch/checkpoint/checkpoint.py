"""Atomic checkpoints of the training state, in the reference's on-disk
layout (``repro.checkpoint.checkpoint``):

    ckpt_dir/
      step_000120.tmp-<nonce>/   # written first
        manifest.json            # leaf paths, shapes, dtypes, SHA-256
        <leaf>.npy               # one file per leaf
      step_000120/               # atomic rename == commit marker

A crash mid-write leaves only a ``.tmp`` directory, which ``latest_step``
skips and the next commit's garbage collection removes; the last
``keep_last`` steps are kept; every leaf's SHA-256 is verified on restore;
``AsyncCheckpointer`` writes on a thread, at most one save in flight.

Leaves are tensors (or numpy arrays) of float32 or int32, which is all the
training state holds: numpy has no bfloat16, so any other dtype is refused
rather than guessed. ``restore`` places the leaves on the device the caller
names, the card by default. The port's params carry no logical axes, so the
manifest's ``axes`` are null, and restoring onto a mesh (``mesh``/
``rules``) waits for the mesh slice.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

DTYPES = ("float32", "int32")


def _flatten(tree) -> Dict[str, Any]:
    out = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], path + [str(k)])
            return
        out["/".join(path)] = node

    rec(tree, [])
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, val in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def _leaf_file(name: str) -> str:
    return name.replace("/", "__") + ".npy"


def _host(name: str, leaf) -> np.ndarray:
    """A leaf as a numpy array on the host; float32 and int32 only."""
    if isinstance(leaf, torch.Tensor):
        if str(leaf.dtype).split(".")[-1] not in DTYPES:
            raise TypeError(f"{name}: {leaf.dtype} cannot be checkpointed "
                            f"(numpy holds {DTYPES} of the training state; "
                            f"no bfloat16)")
        t = leaf.detach()
        # a copy: a CPU tensor's numpy() shares its memory
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    arr = np.asarray(leaf)
    if str(arr.dtype) not in DTYPES:
        raise TypeError(f"{name}: {arr.dtype} cannot be checkpointed "
                        f"(take {DTYPES})")
    return arr


def save(ckpt_dir: str, step: int, state, *, keep_last: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {name: _host(name, leaf) for name, leaf in _flatten(state).items()}
    tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "meta": extra_meta or {}}
    for name, arr in flat.items():
        fn = _leaf_file(name)
        with open(os.path.join(tmp, fn), "wb") as f:
            np.save(f, arr)
        with open(os.path.join(tmp, fn), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["leaves"][name] = {
            "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "axes": None, "sha256": digest,
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # commit
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = committed_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    # drop orphaned tmp dirs (crashed writers)
    for d in os.listdir(ckpt_dir):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def committed_steps(ckpt_dir: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and ".tmp" not in d and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, *, device="cuda",
            mesh=None, rules: Optional[dict] = None,
            verify: bool = True) -> Tuple[int, Any]:
    """Load a checkpoint (the latest committed step by default) as a tree
    of tensors on ``device``."""
    if mesh is not None or rules is not None:
        raise NotImplementedError("restoring onto a mesh waits for the "
                                  "port's mesh slice")
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for name, info in manifest["leaves"].items():
        path = os.path.join(d, info["file"])
        with open(path, "rb") as f:
            raw = f.read()
        if verify:
            digest = hashlib.sha256(raw).hexdigest()
            if digest != info["sha256"]:
                raise IOError(f"checksum mismatch for {name} in {d}")
        flat[name] = torch.from_numpy(np.load(path)).to(device)
    return step, _unflatten(flat)


class AsyncCheckpointer:
    """Writer-thread checkpointer: ``save`` copies the state to the host
    and enqueues it; at most one save is in flight (a second enqueue blocks
    until the writer drains — double buffering)."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, state = item
            try:
                save(self.ckpt_dir, step, state, keep_last=self.keep_last)
            except BaseException as e:   # surfaced on next call / close
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, state) -> None:
        if self._err:
            raise self._err
        host = _unflatten({name: _host(name, leaf)
                           for name, leaf in _flatten(state).items()})
        self._q.put((step, host))   # blocks iff a save is in flight

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)
