"""Logical axes -> placements on a ``DeviceMesh`` (DP / FSDP / TP / EP / SP),
the port of ``repro.distributed.sharding``.

The port's params are tensors with no axes; ``bundle.param_axes()`` and
``bundle.cache_axes()`` give the tree of logical axis names the reference's
``Param.axes`` hold. ``make_rules`` maps those names to mesh axes per
(config, mode), exactly as the reference does, and ``spec_for`` gives the
reference's ``PartitionSpec`` as a tuple, one entry per tensor dim: None,
a mesh axis name, or a tuple of names. A dim whose size does not divide its
mesh axes, or whose mesh axis an earlier dim took, falls back to
replication. ``placements`` turns that spec into DTensor's placements, one
per mesh dim: ``Shard(tensor_dim)`` or ``Replicate()``. A dim sharded over
two mesh axes (the batch over ``("pod", "data")``) is split over them in
mesh order, the earlier axis major, which is the slice JAX gives each
device for ``P(("pod", "data"))``.

The reference's counterparts: ``Mesh`` is a ``DeviceMesh``,
``NamedSharding(mesh, P(...))`` is :class:`Sharding` (the mesh and its
placements), ``jax.device_put(arr, sharding)`` is ``Sharding.place``
(``distribute_tensor``), and ``psum`` over a mesh axis is an all-reduce on
that axis's process group (``all_reduce``, which counts its calls by axis).
``copy_to``, ``reduce_from`` and ``shard_of`` carry those collectives
through autograd for the MoE's shard_map counterpart
(``models.ffn.moe_forward_shardmap``).

Modes:
  train  FSDP (embed dim over `data`) x TP (heads/mlp/vocab/expert over
         `model`); batch over (`pod`, `data`).
  serve  TP only; params replicated over `data`; decode KV cache sharded on
         kv_heads when divisible, else on the sequence dim (SP fallback).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

# ---------------------------------------------------------------------------
# Meshes by axis name
# ---------------------------------------------------------------------------


def axis_names(mesh) -> tuple:
    """A ``DeviceMesh``'s dim names, or the ``axis_names`` of a stand-in
    (the reference tests' ``FakeMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}; a stand-in's ``shape`` is already that dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


# ---------------------------------------------------------------------------
# Rules and specs
# ---------------------------------------------------------------------------

def make_rules(cfg, mesh, mode: str = "train",
               overrides: Optional[dict] = None) -> dict:
    """mode: train | prefill | serve (decode). The reference's rules, branch
    for branch: heads, kv_heads, vocab, mlp and expert over `model` (over
    `data` in the ZeRO-3 prefill of attention-only archs, whose sequence
    then goes over `model`); the embed dim over `data` in training; the
    attention q-chunk over `model` in training where the query heads divide
    it and the KV heads do not; the KV sequence over `model` where the KV
    heads do not divide it (serve), in the ZeRO-3 prefill, and in training
    where neither head count divides it."""
    model_n = axis_sizes(mesh)["model"]
    kv_shardable = cfg.n_kv_heads > 0 and cfg.n_kv_heads % model_n == 0
    heads_shardable = cfg.n_heads > 0 and cfg.n_heads % model_n == 0
    zero3_prefill = (mode == "prefill" and cfg.n_heads > 0
                     and cfg.ssm is None)
    park = "data" if zero3_prefill else "model"
    rules = {
        "layer": None,
        "embed": "data" if mode == "train" else None,
        "embed2": park,
        "vocab": park,
        "heads": park,
        "kv_heads": park,
        "head_dim": None,
        "mlp": park,
        "expert": park,
        "q_lora": None,
        "kv_lora": None,
        "ssm_inner": "model",
        "ssm_conv_ch": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "conv": None,
        "batch": dp_axes(mesh),
        "seq": "model" if zero3_prefill else None,
        "attn_q": ("model" if (zero3_prefill or
                               (mode == "train" and heads_shardable
                                and not kv_shardable)) else None),
        "kv_seq": ("model" if (not kv_shardable and mode == "serve")
                   else ("model" if zero3_prefill else
                         ("model" if (mode == "train" and not kv_shardable
                                      and not heads_shardable) else None))),
        "enc_seq": None,
        "embed_act": None,
    }
    if overrides:
        rules.update(overrides)
    return rules


def spec_for(shape, axes, rules: dict, mesh) -> tuple:
    """The reference's PartitionSpec as a tuple, one entry per dim: a mesh
    axis is used by the first dim that asks for it and divides by it; later
    dims, and dims that do not divide, are replicated (None)."""
    sizes = axis_sizes(mesh)
    used = set()
    parts = []
    for dim, ax in zip(shape, axes):
        assign = rules.get(ax)
        if assign is None:
            parts.append(None)
            continue
        assign_t = assign if isinstance(assign, tuple) else (assign,)
        size = math.prod(sizes[a] for a in assign_t)
        if any(a in used for a in assign_t) or dim % size != 0:
            parts.append(None)
            continue
        used.update(assign_t)
        parts.append(assign_t if len(assign_t) > 1 else assign_t[0])
    return tuple(parts)


def placements(spec, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim ``d``'s
    spec entry names that axis, else ``Replicate()``. A dim over several
    axes must name them in mesh order: DTensor splits it over the mesh dims
    in that order, which is JAX's slice only then."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        entry = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in entry]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}: DTensor would place it "
                             f"otherwise than JAX")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass
class Sharding:
    """The reference's ``NamedSharding(mesh, P(*spec))``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, tensor) -> DTensor:
        """``jax.device_put``: the whole tensor onto the mesh's device, each
        rank keeping its shard. Every rank passes the same tensor."""
        return distribute_tensor(tensor.detach().to(self.mesh.device_type),
                                 self.mesh, self.placements)


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of the same keys."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def sharding_for_tree(tree, axes, rules: dict, mesh):
    """A tree of tensors (or shapes) and its axes tree -> a tree of
    :class:`Sharding`. A leaf whose axes are None (the optimizer's step
    count) is replicated."""
    def leaf(t, ax):
        shape = t.shape if isinstance(t, torch.Tensor) else tuple(t)
        return Sharding(mesh, () if ax is None
                        else spec_for(shape, ax, rules, mesh))
    return map_tree(leaf, tree, axes)


def place(tree, shardings):
    """Each leaf placed by its :class:`Sharding` (a tree of DTensors)."""
    return map_tree(lambda t, s: s.place(t), tree, shardings)


def batch_sharding(specs: dict, rules: dict, mesh) -> dict:
    """Input batch (name -> tensor or shape) -> shardings; dim 0 is the
    batch, the rest replicated."""
    out = {}
    for name, t in specs.items():
        shape = t.shape if isinstance(t, torch.Tensor) else tuple(t)
        axes = ("batch",) + (None,) * (len(shape) - 1)
        out[name] = Sharding(mesh, spec_for(shape, axes, rules, mesh))
    return out


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


# ---------------------------------------------------------------------------
# Activation sharding context: ``constrain(x, axes)`` places a hot
# intermediate by logical axis names inside ``activation_sharding``, and is
# the identity outside it (the CPU tests, the port's eager model).
# ---------------------------------------------------------------------------

_ACT = contextvars.ContextVar("activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict):
    token = _ACT.set((mesh, rules))
    try:
        yield
    finally:
        _ACT.reset(token)


def constrain(x, axes: tuple):
    """The reference's ``with_sharding_constraint`` by logical axis names:
    a DTensor is redistributed to the spec's placements, a whole tensor is
    placed by them; without an active context, ``x`` itself."""
    ctx = _ACT.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    pl = placements(spec_for(x.shape, axes, rules, mesh), mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl)


def constrain_if(x, axes: tuple, key: str):
    """constrain(), but only when rule ``key`` is mapped."""
    ctx = _ACT.get()
    if ctx is None or ctx[1].get(key) is None:
        return x
    return constrain(x, axes)


# ---------------------------------------------------------------------------
# Collectives over mesh axes
# ---------------------------------------------------------------------------

_COUNT_LOCK = threading.Lock()
_COUNTS: dict = {}


def collective_counts() -> dict:
    """All-reduces since the last reset, by mesh axis name."""
    with _COUNT_LOCK:
        return dict(_COUNTS)


def reset_collective_counts() -> None:
    with _COUNT_LOCK:
        _COUNTS.clear()


def all_reduce(t, mesh, axes):
    """``psum`` over each mesh axis of ``axes`` (a name or a tuple), in
    place on ``t``, which is returned; one counted all-reduce per axis,
    whatever its size."""
    for ax in (axes,) if isinstance(axes, str) else axes:
        dist.all_reduce(t, group=mesh.get_group(ax))
        with _COUNT_LOCK:
            _COUNTS[ax] = _COUNTS.get(ax, 0) + 1
    return t


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``axes``: the input
    is replicated over them and each rank's gradient is a partial sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward over ``axes``; identity backward: every rank
    holds the same loss of the sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ShardOf(torch.autograd.Function):
    """This rank's block of ``dim`` along mesh axis ``axis`` (shard_map's
    in_spec on a whole input); the gradient is the block's, zero elsewhere,
    all-reduced over the axis, so every rank gets the whole gradient (the
    blocks are disjoint: each value is one rank's, exactly)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        n = x.shape[dim] // axis_sizes(mesh)[axis]
        lo = mesh.get_local_rank(axis) * n
        ctx.mesh, ctx.axis, ctx.dim, ctx.lo = mesh, axis, dim, lo
        ctx.shape = x.shape
        return x.narrow(dim, lo, n).clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.lo, g.shape[ctx.dim]).copy_(g)
        return all_reduce(full, ctx.mesh, ctx.axis), None, None, None


def copy_to(x, mesh, axes):
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x, mesh, axes):
    return _ReduceFrom.apply(x, mesh, axes)


def shard_of(x, mesh, axis: str, dim: int = 0):
    return _ShardOf.apply(x, mesh, axis, dim)
