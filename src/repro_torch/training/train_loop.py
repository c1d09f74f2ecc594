"""Train-step construction (``repro.training.train_loop``): the loss's
gradient by autograd, then AdamW; optional microbatch gradient
accumulation and int8 gradient compression (``training.compression``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.training import compression as comp_mod
from repro_torch.training import optimizer as opt_mod


def init_train_state(bundle, generator: Optional[torch.Generator] = None,
                     device="cuda"):
    params = bundle.init(generator=generator, device=device,
                         requires_grad=True)
    return {"params": params, "opt": opt_mod.init_state(params)}


def grad_tree(loss, params):
    """The gradient of ``loss`` for every leaf of ``params``, as a tree of
    the same keys."""
    it = iter(torch.autograd.grad(loss, opt_mod.leaves(params)))
    return opt_mod.tree_map(lambda _: next(it), params)


def make_train_step(bundle, opt_cfg: opt_mod.AdamWConfig, *,
                    dtype=torch.bfloat16, remat=True, moe_ctx=None,
                    microbatches: int = 1, compress_grads: bool = False):
    """Returns train_step(state, batch) -> (state, metrics). The state's
    params are made to need gradients first (a restored state's do not)."""

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
        for p in opt_mod.leaves(state["params"]):
            p.requires_grad_(True)
        loss, grads = grads_of(state["params"], batch)
        if compress_grads:
            grads = comp_mod.compress_decompress(grads)
        params, opt_state, metrics = opt_mod.apply_updates(
            opt_cfg, state["params"], grads, state["opt"])
        metrics["loss"] = loss
        return {"params": params, "opt": opt_state}, metrics

    return train_step
