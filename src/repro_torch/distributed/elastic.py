"""Elastic re-meshing of the port (``repro.distributed.elastic``): move a
training state between meshes of different sizes without retraining.

Checkpoints store logical arrays and axis names, never device layouts, so
scaling from N to M ranks is a restore under the new mesh's rules; the rules
fall back to replication where a dim does not divide, so any (data, model)
factoring of the new rank count is a legal target. ``plan_remesh`` picks the
new mesh shape for a rank budget; ``remesh`` moves a live state onto a new
mesh in-process.
"""
from __future__ import annotations

from typing import Optional, Tuple

from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as shd


def plan_remesh(n_chips: int, *, model_parallel: Optional[int] = None,
                prefer_model: int = 16) -> Tuple[int, int]:
    """(data, model) factoring for a chip budget. Keeps the model axis at
    the largest power-of-two divisor <= prefer_model so TP layouts survive
    scale-downs (e.g. 512 -> 256 chips keeps model=16, halves data)."""
    if model_parallel is not None:
        if n_chips % model_parallel:
            raise ValueError(f"{n_chips} chips not divisible by "
                             f"model={model_parallel}")
        return n_chips // model_parallel, model_parallel
    m = 1
    while m * 2 <= prefer_model and n_chips % (m * 2) == 0:
        m *= 2
    return n_chips // m, m


def remesh(state, old_mesh, new_mesh, rules_new: dict, *, axes):
    """``state`` (a tree of DTensors on ``old_mesh``, or whole tensors)
    placed on ``new_mesh`` under ``rules_new`` by its ``axes`` tree: each
    leaf gathered whole (an all-gather over the old mesh where it is
    sharded), then placed by ``spec_for``. Every rank of both meshes calls
    it with the same state."""
    def leaf(t, sharding):
        if isinstance(t, DTensor):
            if t.device_mesh != old_mesh:
                raise ValueError("a leaf of the state is not on old_mesh")
            t = t.full_tensor()
        return sharding.place(t)
    return shd.map_tree(leaf, state,
                    shd.sharding_for_tree(state, axes, rules_new, new_mesh))
