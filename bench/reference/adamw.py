"""AdamW as the configuration states it, written out plainly: clip by the
global norm of all gradients, the bias-corrected m̂ / (√v̂ + eps), then
decoupled decay p − lr (δ + wd p); the learning rate warms up linearly,
then follows a cosine down to ``min_lr_ratio`` of its peak."""
from __future__ import annotations

import math

import torch


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (
        1 + math.cos(math.pi * t))
    return opt["lr"] * warm * cos


@torch.no_grad()
def step(opt: dict, params: dict, grads: dict, m: dict, v: dict, n: int):
    """Step ``n`` (1-based) in place on {name: tensor}; returns the
    clipped gradients, as the moments take them."""
    gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                          for g in grads.values()))
    scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
    lr = lr_at(opt, n)
    b1c, b2c = 1 - opt["b1"] ** n, 1 - opt["b2"] ** n
    clipped = {}
    for name, p in params.items():
        g = grads[name] * scale
        clipped[name] = g
        m[name].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
        v[name].mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
        delta = (m[name] / b1c) / (torch.sqrt(v[name] / b2c) + opt["eps"])
        p.sub_(lr * (delta + opt["weight_decay"] * p))
    return clipped
