"""Helpers shared by the port's parity tests: carry a JAX Param tree and
arrays over to torch through numpy."""
import numpy as np


def flatten_params(tree, prefix=()):
    """repro Param tree -> {"a/b/c": (numpy array, axes)}."""
    from repro.models import common as cm
    if cm.is_param(tree):
        return {"/".join(prefix): (np.asarray(tree.value), tree.axes)}
    flat = {}
    for k, v in tree.items():
        flat.update(flatten_params(v, prefix + (k,)))
    return flat


def to_torch(x, dtype=None):
    import torch
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)
