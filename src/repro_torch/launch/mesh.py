"""Mesh builders of the port (``repro.launch.mesh``): a ``DeviceMesh`` over
the ranks of the current process group, which the caller initialises
(``torch.distributed.init_process_group``; nothing here reads a cluster's
environment). Functions, not module-level constants, so that importing this
module touches no device and no group."""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _mesh(shape, names, device):
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if n != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the process group has {n}")
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 ("data", "model"), one pod of 256 ranks, or 2x16x16 ("pod",
    "data", "model"), two pods of 512. One machine holds either only over a
    fake process group (``torch.testing._internal.distributed.fake_pg``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def make_host_mesh(model: int = 1, device="cuda"):
    """(world / model, model) ("data", "model") over every rank of the
    process group, on the card unless ``device="cpu"``."""
    n = dist.get_world_size() if dist.is_initialized() else 0
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide the {n} ranks")
    return _mesh((n // model, model), ("data", "model"), device)
