"""Seeded weights, made by the benchmark and handed alike to the program
and to the reference.

One ``torch.randn`` call on the device fills a flat buffer for every leaf;
each leaf is a view of it, scaled by the rule its configuration file gives
for its name (``init``: a list of [glob pattern, rule], the first match
wins). A rule is ``{"std": s}``, ``{"mean": m, "std": s}`` or
``{"fan_in_dims": [...]}`` (std 1 / sqrt of the product of those dims of
the leaf's shape). The same seed gives the same values on the same device.
"""
from __future__ import annotations

import fnmatch
import math

import torch

WEIGHT_STREAM = 0x5EED


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of the run's
    seed (weights, batches, ...), so that the streams do not overlap."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def rule_for(path: str, rules) -> dict:
    for pattern, rule in rules:
        if fnmatch.fnmatchcase(path, pattern):
            return rule
    raise KeyError(f"no init rule in the configuration matches {path!r}")


def std_of(rule: dict, shape) -> float:
    if "fan_in_dims" in rule:
        dims = rule["fan_in_dims"]
        return 1.0 / math.sqrt(math.prod(shape[d] for d in dims))
    return float(rule["std"])


@torch.no_grad()
def make(shapes: dict, rules, seed: int, device) -> dict:
    """{path: fp32 tensor} for {path: shape}, in sorted path order, from
    one draw of the seed's weight stream."""
    paths = sorted(shapes)
    sizes = [math.prod(shapes[p]) for p in paths]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHT_STREAM,
                                                       device),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for path, n in zip(paths, sizes):
        rule = rule_for(path, rules)
        leaf = flat[off:off + n].view(shapes[path])
        leaf.mul_(std_of(rule, shapes[path]))
        if rule.get("mean"):
            leaf.add_(rule["mean"])
        out[path] = leaf
        off += n
    return out
