"""Train-step construction (``repro.training.train_loop``): the loss's
gradient by autograd, then AdamW; optional microbatch gradient
accumulation and int8 gradient compression (``training.compression``).

A state placed on a mesh (DTensor leaves, ``sharding.place``) trains where
every leaf's local shard is the whole leaf and the mesh's data axes hold
one rank: the step computes on the local tensors and places the new state
as the old one was (on a model axis of more ranks, ``moe_ctx``'s shard_map
MoE takes each rank's block of the whole expert stacks and gathers their
gradients whole). A split leaf raises, and so does a data axis of more than
one rank: executing the layers sharded is what the reference leaves to
GSPMD in a compiled step, which the port does not run; nothing computes on
a shard as if it were the whole.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as shd
from repro_torch.training import compression as comp_mod
from repro_torch.training import optimizer as opt_mod


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


def _local(state, moe_ctx):
    """(the state's local tensors, a function placing a tree of the same
    keys as the state was placed). Raises on a split leaf or a data axis of
    more than one rank."""
    meshes = [moe_ctx["mesh"]] if moe_ctx and "mesh" in moe_ctx else []
    layout = {}

    def unwrap(path, t):
        if not isinstance(t, DTensor):
            return t
        local = t.to_local().detach()
        if local.shape != t.shape:
            raise ValueError(
                f"{path}: its local shard {tuple(local.shape)} is not the "
                f"whole leaf {tuple(t.shape)}; the port trains no split "
                f"leaf (sharded dense layers are the compiled step's)")
        layout[path] = (t.device_mesh, t.placements)
        meshes.append(t.device_mesh)
        return local

    local = _walk(unwrap, state, "")
    for mesh in meshes:
        sizes = shd.axis_sizes(mesh)
        if any(sizes.get(a, 1) > 1 for a in shd.dp_axes(mesh)):
            raise ValueError(f"a mesh of {sizes}: data-parallel training "
                             f"would need its dense gradients reduced over "
                             f"the data axes, which the port does not do")

    def wrap(tree):
        return _walk(lambda path, t: DTensor.from_local(
            t.detach(), *layout[path], run_check=False)
            if path in layout else t,
            tree, "")
    return local, wrap


def _walk(fn, tree, path):
    if isinstance(tree, dict):
        return {k: _walk(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


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
        loss = bundle.loss_fn(params, batch, dtype=dtype, remat=remat,
                              moe_ctx=moe_ctx)
        return loss.detach(), grad_tree(loss, params)

    def grads_of(params, batch):
        if microbatches <= 1:
            return loss_and_grads(params, batch)
        mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                            + tuple(v.shape[1:])) for k, v in batch.items()}
        loss_sum = torch.zeros((), device=opt_mod.leaves(params)[0].device)
        gsum = opt_mod.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        for i in range(microbatches):
            loss, acc = loss_and_grads(params,
                                       {k: v[i] for k, v in mbs.items()})
            loss_sum = loss_sum + loss
            gsum = opt_mod.tree_map(torch.add, gsum, acc)
        inv = 1.0 / microbatches
        return loss_sum * inv, opt_mod.tree_map(lambda g: g * inv, gsum)

    def train_step(state, batch):
        state, placed = _local(state, moe_ctx)
        for p in opt_mod.leaves(state["params"]):
            p.requires_grad_(True)
        loss, grads = grads_of(state["params"], batch)
        if compress_grads:
            grads = comp_mod.compress_decompress(grads)
        params, opt_state, metrics = opt_mod.apply_updates(
            opt_cfg, state["params"], grads, state["opt"])
        metrics["loss"] = loss
        return placed({"params": params, "opt": opt_state}), metrics

    return train_step
