"""Train-step construction (``repro.training.train_loop``): the loss's
gradient by autograd, then AdamW; optional microbatch gradient
accumulation and int8 gradient compression (``training.compression``).

A state placed on a mesh (DTensor leaves, ``sharding.place``) trains on
its DTensors: every layer runs on each rank's blocks (the placements the
leaves, the batch and ``sharding.constrain`` give, the kernels through
``kernels.sharded``), and each gradient is redistributed to its leaf's
placements, so the gradient of a leaf replicated over the data axes comes
out summed over them (an all-reduce; a reduce-scatter where the leaf is
split). AdamW and the global-norm clip run on the DTensors. Where every
mesh has one rank, the step computes on the local tensors, which are the
whole leaves, and places the new state as the old one was (the same
operations, so the same bits, as an unplaced state's step).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed import sharding as shd
from repro_torch.training import compression as comp_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.trace import span


def init_train_state(bundle, generator: Optional[torch.Generator] = None,
                     device="cuda"):
    params = bundle.init(generator=generator, device=device,
                         requires_grad=True)
    return {"params": params, "opt": opt_mod.init_state(params)}


def state_axes(param_axes):
    """The train state's logical axes: the moments' are the params'; the
    step count has none."""
    return {"params": param_axes,
            "opt": {"m": param_axes, "v": param_axes, "step": None}}


def _meshes(state, moe_ctx):
    """The meshes of the state's DTensor leaves and of ``moe_ctx``."""
    meshes = [moe_ctx["mesh"]] if moe_ctx and "mesh" in moe_ctx else []
    _walk(lambda path, t: meshes.append(t.device_mesh)
          if isinstance(t, DTensor) else None, state, "")
    return meshes


def _local(state):
    """(the state's local tensors, a function placing a tree of the same
    keys as the state was placed), for a state whose meshes have one rank
    each."""
    layout = {}

    def unwrap(path, t):
        if not isinstance(t, DTensor):
            return t
        layout[path] = (t.device_mesh, t.placements)
        return t.to_local().detach()

    local = _walk(unwrap, state, "")

    def wrap(tree):
        return _walk(lambda path, t: DTensor.from_local(
            t.detach(), *layout[path], run_check=False)
            if path in layout else t,
            tree, "")
    return local, wrap


def reduce_grads(grads, params):
    """Each gradient redistributed to its leaf's placements: a partial sum
    (over the data axes, where the leaf is replicated) is all-reduced, or
    reduce-scattered onto a split leaf."""
    return opt_mod.tree_map(
        lambda g, p: g.redistribute(p.device_mesh, p.placements)
        if isinstance(g, DTensor) else g, grads, params)


def _walk(fn, tree, path):
    if isinstance(tree, dict):
        return {k: _walk(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def _microbatch(v, i, n):
    """Microbatch ``i`` of ``n`` of a batch leaf: rows [i m, (i + 1) m) of
    its m = B / n, as the reference's reshape takes them. Of a batch split
    over ranks, those rows gathered and placed as the batch was, each rank
    keeping its block; each rank must get the same number of rows, else it
    raises, as the reshape does where n does not divide B."""
    if v.shape[0] % n:
        raise ValueError(f"a batch of {v.shape[0]} rows does not split into "
                         f"{n} microbatches")
    m = v.shape[0] // n
    if not isinstance(v, DTensor):
        return v.reshape((n, m) + tuple(v.shape[1:]))[i]
    mesh = v.device_mesh
    ranks = math.prod(mesh.size(d) for d, p in enumerate(v.placements)
                      if isinstance(p, Shard) and p.dim == 0)
    if m % ranks:
        raise ValueError(f"a microbatch of {m} rows does not split over the "
                         f"{ranks} ranks of its batch")
    return shd.from_whole(v.full_tensor()[i * m:(i + 1) * m], mesh,
                          v.placements)


def grad_tree(loss, params):
    """The gradient of ``loss`` for every leaf of ``params``, as a tree of
    the same keys."""
    it = iter(torch.autograd.grad(loss, opt_mod.leaves(params)))
    return opt_mod.tree_map(lambda _: next(it), params)


def make_train_step(bundle, opt_cfg: opt_mod.AdamWConfig, *,
                    dtype=torch.bfloat16, remat=True, moe_ctx=None,
                    microbatches: int = 1, compress_grads: bool = False):
    """Returns train_step(state, batch) -> (state, metrics). The state's
    params are made to need gradients first (a restored state's do not).
    ``moe_ctx``: the MoE's implementation, passed to the loss
    ({"impl": "shardmap", "mesh", "dp_axes"}: ``ffn.moe_forward_shardmap``
    on the mesh)."""

    def loss_and_grads(params, batch):
        with span("step.loss"):
            loss = bundle.loss_fn(params, batch, dtype=dtype, remat=remat,
                                  moe_ctx=moe_ctx)
        with span("step.grad"):
            return loss.detach(), grad_tree(loss, params)

    def grads_of(params, batch):
        if microbatches <= 1:
            return loss_and_grads(params, batch)
        loss_sum = gsum = None
        for i in range(microbatches):
            loss, acc = loss_and_grads(params, {
                k: _microbatch(v, i, microbatches) for k, v in batch.items()})
            if gsum is None:
                loss_sum = loss.float()
                gsum = opt_mod.tree_map(lambda g: g.float(), acc)
            else:
                loss_sum = loss_sum + loss
                gsum = opt_mod.tree_map(torch.add, gsum, acc)
        inv = 1.0 / microbatches
        return loss_sum * inv, opt_mod.tree_map(lambda g: g * inv, gsum)

    def train_step(state, batch):
        meshes = _meshes(state, moe_ctx)
        sharded = any(m.size() > 1 for m in meshes)
        if sharded:
            return sharded_step(state, batch)
        if meshes:
            state, placed = _local(state)
            batch = _walk(lambda path, t: t.to_local()
                          if isinstance(t, DTensor) else t, batch, "")
        else:
            placed = lambda tree: tree  # noqa: E731
        for p in opt_mod.leaves(state["params"]):
            p.requires_grad_(True)
        with shd.without_activation_sharding():
            loss, grads = grads_of(state["params"], batch)
        if compress_grads:
            grads = comp_mod.compress_decompress(grads)
        params, opt_state, metrics = opt_mod.apply_updates(
            opt_cfg, state["params"], grads, state["opt"])
        metrics["loss"] = loss
        return placed({"params": params, "opt": opt_state}), metrics

    def sharded_step(state, batch):
        if compress_grads:
            raise NotImplementedError("int8 gradient compression of a "
                                      "sharded state")
        params = state["params"]
        for p in opt_mod.leaves(params):
            p.requires_grad_(True)
        with implicit_replication():
            loss, grads = grads_of(params, batch)
            grads = reduce_grads(grads, params)
            params, opt_state, metrics = opt_mod.apply_updates(
                opt_cfg, params, grads, state["opt"])
        metrics["loss"] = loss
        return {"params": params, "opt": opt_state}, metrics

    return train_step
