"""AdamW: wrappers of the Hopper kernels ``csrc/adamw.cu`` and their plain
PyTorch versions.

No Pallas counterpart: the reference writes AdamW in jnp
(``repro.training.optimizer.apply_updates``) and XLA fuses its elementwise
chain. Eagerly, that chain is about 17 kernels a leaf, each reading and
writing whole fp32 leaves; the kernels make the step two passes over the
tree, each reading its inputs once: ``sumsq`` (the op
``repro_torch::adamw_sumsq``, the gradients' sum of squares, whose root
``global_norm`` takes) and ``update`` (``repro_torch::adamw_update``).
``update`` computes the chain's operations in its order, each rounded to
fp32, so its new params and moments equal the chain's bit for bit given the
same scale, lr and bias corrections; the norm sums in fp64 in a fixed
order, so it differs from the chain's fp32 sum in its last bits and has the
same bits on every run.

``plain`` is one leaf's step as that chain and ``plain_norm`` the norm;
``training.optimizer`` runs them on CPU trees. Card trees, DTensors
included, go to the kernels (through ``kernels.sharded``, which hands them
each rank's blocks); the wrappers raise on leaves the kernels do not take
and never fall back to the chain.
"""
from __future__ import annotations

import ctypes
import functools
import math
import types
from typing import List

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build

stats = {"launches": 0}   # one a pass: the norm and the update
# the leaf types the kernels take: plain tensors, real or fake
PLAIN = (torch.Tensor, FakeTensor)
# operations of one element's update in ``plain``
UPDATE_FLOPS = 17


def plain_norm(grads):
    """The global norm of a list of tensors, as the chain computes it: each
    one's fp32 sum of squares, added in order, then the square root."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def plain(p, g, m, v, scale, lr, b1c, b2c, *, b1, b2, eps, weight_decay):
    """One leaf's AdamW step: (new p, new m, new v). The gradient clipped by
    ``scale``, the moments, the bias-corrected m̂ / (√v̂ + eps), then
    decoupled decay p − lr (δ + wd p), in the reference's order."""
    g = g.float() * scale
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * torch.square(g)
    mhat = m2 / b1c
    vhat = v2 / b2c
    delta = mhat / (torch.sqrt(vhat) + eps)
    return p - lr * (delta + weight_decay * p), m2, v2


def takes(tensors) -> bool:
    """Whether the kernels take these leaves (the wrappers raise on any
    others): every one a plain (not a DTensor or another subclass),
    contiguous float32 tensor on the first one's CUDA device, real or
    fake."""
    dev = tensors[0].device if tensors else None
    return bool(tensors) and dev.type == "cuda" and all(
        type(t) in PLAIN and t.device == dev and t.dtype == torch.float32
        and t.is_contiguous() for t in tensors)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("adamw")
    for name in ("adamw_max_leaves", "adamw_sumsq_blocks"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.adamw_sumsq.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.adamw_sumsq.restype = ctypes.c_int
    lib.adamw_update_leaves.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    lib.adamw_update_leaves.restype = ctypes.c_int
    return types.SimpleNamespace(
        sumsq=lib.adamw_sumsq, update=lib.adamw_update_leaves,
        max_leaves=lib.adamw_max_leaves(), blocks=lib.adamw_sumsq_blocks())


def _check_leaves(**lists):
    """Lists of one length, each leaf a plain, contiguous float32 tensor on
    the first one's CUDA device, the lists' i-th leaves of one shape."""
    first = next(iter(lists.values()))
    if not first:
        raise ValueError("no leaves")
    for name, ts in lists.items():
        if len(ts) != len(first):
            raise ValueError(f"{len(ts)} {name} for {len(first)} leaves")
        if not takes(ts) or ts[0].device != first[0].device:
            raise ValueError(f"{name} must be plain, contiguous float32 "
                             f"tensors on one CUDA device, {name}[0]'s and "
                             f"the first list's")
        for i, (t, ref) in enumerate(zip(ts, first)):
            if t.shape != ref.shape:
                raise ValueError(f"{name}[{i}] is {tuple(t.shape)}, leaf {i} "
                                 f"{tuple(ref.shape)}")


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def sumsq(grads: List[torch.Tensor]) -> torch.Tensor:
    """The sum of the squares of every element of ``grads`` (plain,
    contiguous float32 CUDA tensors on one device) as a new 0-dim float64
    tensor on their device, summed in fp64 in a fixed order. One pass over
    the leaves, no host synchronisation."""
    _check_leaves(grads=grads)
    return _build.call(torch.ops.repro_torch.adamw_sumsq, _sumsq_impl,
                       list(grads))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The global norm of ``grads`` (as ``sumsq`` takes them): the root of
    ``sumsq``, rounded to a 0-dim float32 tensor."""
    return torch.sqrt(sumsq(grads)).float()


def _sumsq_impl(grads: List[torch.Tensor]) -> torch.Tensor:
    lib = _lib()
    out = grads[0].new_empty((), dtype=torch.float64)
    runs = -(-len(grads) // lib.max_leaves)
    partial = torch.empty(runs * lib.blocks, dtype=torch.float64,
                          device=grads[0].device)
    sizes = (ctypes.c_longlong * len(grads))(*(g.numel() for g in grads))
    with torch.cuda.device(grads[0].device):
        stream = torch.cuda.current_stream(grads[0].device).cuda_stream
        err = lib.sumsq(_pointers(grads), sizes, len(grads),
                        partial.data_ptr(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"adamw_sumsq kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(stats)
    return out


_sumsq_op = torch.library.custom_op("repro_torch::adamw_sumsq", _sumsq_impl,
                                    mutates_args=(), device_types="cuda")


@_sumsq_op.register_fake
def _sumsq_fake(grads):
    """The 0-dim float64 sum."""
    return grads[0].new_empty((), dtype=torch.float64)


def update(params, grads, m, v, scale, lr, b1c, b2c, *, b1, b2, eps,
           weight_decay):
    """One AdamW step of every leaf: (new params, new m, new v), lists of
    new tensors. The leaves: plain, contiguous float32 CUDA tensors on one
    device, the i-th of each list of one shape; ``scale`` (the clip), ``lr``,
    ``b1c`` and ``b2c`` (the bias corrections): 0-dim float32 tensors on
    that device, read there. Bit-equal to ``plain`` on each leaf. At most
    one kernel launch a leaf, one for up to 32 leaves; no host
    synchronisation. The new params need no gradient."""
    _check_leaves(params=params, grads=grads, m=m, v=v)
    dev = params[0].device
    for name, t in (("scale", scale), ("lr", lr), ("b1c", b1c), ("b2c", b2c)):
        if not (type(t) in PLAIN and t.device == dev and t.dim() == 0
                and t.dtype == torch.float32):
            raise ValueError(f"{name} must be a 0-dim float32 tensor on {dev}")
    n = len(params)
    out = _build.call(torch.ops.repro_torch.adamw_update, _update_impl,
                      list(params), list(grads), list(m), list(v), scale, lr,
                      b1c, b2c, float(b1), float(b2), float(eps),
                      float(weight_decay))
    return out[:n], out[n:2 * n], out[2 * n:]


def _update_impl(params: List[torch.Tensor], grads: List[torch.Tensor],
                 m: List[torch.Tensor], v: List[torch.Tensor],
                 scale: torch.Tensor, lr: torch.Tensor, b1c: torch.Tensor,
                 b2c: torch.Tensor, b1: float, b2: float, eps: float,
                 weight_decay: float) -> List[torch.Tensor]:
    lib = _lib()
    out = _update_fake(params, grads, m, v, scale, lr, b1c, b2c, b1, b2, eps,
                       weight_decay)
    n = len(params)
    sizes = (ctypes.c_longlong * n)(*(p.numel() for p in params))
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream(params[0].device).cuda_stream
        # the constants go to C floats: rounded as PyTorch rounds a Python
        # float for an fp32 tensor, each difference taken in double first
        err = lib.update(
            _pointers(params), _pointers(grads), _pointers(m), _pointers(v),
            _pointers(out[:n]), _pointers(out[n:2 * n]), _pointers(out[2 * n:]),
            sizes, n, scale.data_ptr(), lr.data_ptr(), b1c.data_ptr(),
            b2c.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, weight_decay, stream)
    if err:
        raise RuntimeError(f"adamw_update kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(stats)
    return out


_update_op = torch.library.custom_op("repro_torch::adamw_update",
                                     _update_impl, mutates_args=(),
                                     device_types="cuda")


@_update_op.register_fake
def _update_fake(params, grads, m, v, scale, lr, b1c, b2c, b1, b2, eps,
                 weight_decay):
    """The new params, m and v, one list: each leaf shaped as its param."""
    return [torch.empty_like(t) for _ in range(3) for t in params]


def _numel(tensors) -> int:
    return sum(math.prod(t.shape) for t in tensors)


def _sumsq_flops(grads, out_val=None):
    """A square and an add an element."""
    return 2 * _numel(grads)


def _sumsq_bytes(grads):
    """Each gradient read once (the partials are a few KB)."""
    return 4 * _numel(grads)


def _update_flops(params, *args, out_val=None):
    return UPDATE_FLOPS * _numel(params)


def _update_bytes(params, *args):
    """p, g, m, v read once and the new p, m, v written once: 28 bytes an
    element; with the norm's 4, the step's 32."""
    return 28 * _numel(params)


_build.register_costs(torch.ops.repro_torch.adamw_sumsq, flops=_sumsq_flops,
                      nbytes=_sumsq_bytes)
_build.register_costs(torch.ops.repro_torch.adamw_update,
                      flops=_update_flops, nbytes=_update_bytes)
