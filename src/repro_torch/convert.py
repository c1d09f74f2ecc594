"""Carry ``repro`` parameters over to the port.

A ``repro`` Param tree, flattened to ``{"a/b/c": (numpy array, axes)}``
(the path joins the tree's dict keys with "/"; ``axes`` are the Param's
logical axis names), becomes the port's nested dict of tensors with the same
keys and layouts: the stacked ``layer`` axis stays first and dense weights
stay ``(d_in..., d_out...)``, the layout ``models.common.apply_dense``
contracts. Arrays must have a numpy dtype that torch knows (float32 for the
JAX init). ``axes_from_numpy`` keeps the Params' axes as the tree of
axis-name tuples that ``bundle.param_axes()`` builds.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# the subtrees whose leaves stack their layers on a leading ``layer`` axis:
# the decoder-only models' and the encoder-decoder's two stacks
STACKED = ("layers", "enc_layers", "dec_layers")


def params_from_numpy(flat: Dict[str, Tuple[np.ndarray, tuple]], *,
                      device="cuda", requires_grad=False):
    """The nested dict of tensors on ``device``; with ``requires_grad``
    every leaf needs a gradient (training)."""
    tree: dict = {}
    for path, (arr, axes) in flat.items():
        arr = np.asarray(arr)
        if arr.ndim != len(axes):
            raise ValueError(f"{path}: {arr.ndim} dims but axes {axes}")
        keys = path.split("/")
        if keys[0] in STACKED and tuple(axes[:1]) != ("layer",):
            raise ValueError(f"{path}: stacked layer weights must lead with "
                             f"the 'layer' axis, got {axes}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.tensor(arr, device=device,
                                      requires_grad=requires_grad)
    return tree


def axes_from_numpy(flat: Dict[str, Tuple[np.ndarray, tuple]]):
    """The nested dict of the Params' logical axes, tuples at the leaves."""
    tree: dict = {}
    for path, (_, axes) in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = tuple(axes)
    return tree
