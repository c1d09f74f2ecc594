"""AdamW with global-norm clipping and a cosine schedule, as plain
functions over the param tree (``repro.training.optimizer``).

The order of operations is the reference's: clip by the global norm, the
bias-corrected ``m̂ / (√v̂ + eps)``, decoupled decay ``p − lr (δ + wd p)``;
``torch.optim.AdamW`` orders its step differently. Trees are nested dicts of
tensors; their leaves are visited in sorted key order, as ``jax.tree``
visits a dict. ``apply_updates`` returns new tensors, as the reference
does: the caller drops the old state. On the card (real or fake tensors,
DTensors included: each rank's blocks, ``kernels.sharded``) the norm and
the update are the two passes of ``kernels.adamw``, which take fp32,
contiguous leaves and raise on any others; a CPU tree takes the same step
as a chain of PyTorch ops (``adamw.plain_norm``, ``adamw.plain``), the
version the tests hold against the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import adamw, sharded
from repro_torch.trace import span


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def leaves(tree):
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio lr``;
    an fp32 0-dim tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(params):
    """fp32 zero moments shaped like the params, and the step count."""
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree):
    return adamw.plain_norm(leaves(tree))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, opt_state):
    """Returns (new_params, new_opt_state, metrics). New params keep the
    old ones' ``requires_grad``. A trace records it as ``step.adamw``."""
    with span("step.adamw"):
        step = opt_state["step"] + 1
        lr = schedule(cfg, step)
        ps, gs, ms, vs = (leaves(t) for t in (params, grads, opt_state["m"],
                                              opt_state["v"]))
        chain = ps[0].device.type == "cpu"
        gnorm = adamw.plain_norm(gs) if chain else sharded.adamw_norm(
            gs, fn=adamw.sumsq)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        b1c = 1 - cfg.b1 ** step.to(torch.float32)
        b2c = 1 - cfg.b2 ** step.to(torch.float32)
        kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                  weight_decay=cfg.weight_decay)
        if chain:
            new_p, new_m, new_v = zip(*(
                adamw.plain(*leaf, scale, lr, b1c, b2c, **kw)
                for leaf in zip(ps, gs, ms, vs)))
        else:
            new_p, new_m, new_v = sharded.adamw_update(
                ps, gs, ms, vs, scale, lr, b1c, b2c, fn=adamw.update, **kw)
        for q, p in zip(new_p, ps):
            q.requires_grad_(p.requires_grad)

        def tree(new):
            it = iter(new)
            return tree_map(lambda _: next(it), params)
        new_state = {"m": tree(new_m), "v": tree(new_v), "step": step}
        return tree(new_p), new_state, {"grad_norm": gnorm, "lr": lr}
