"""Cosine similarity: wrappers of the Hopper kernels ``csrc/similarity.cu``
and their plain PyTorch versions.

``rowwise_cosine`` replaces the Pallas TPU kernel
``repro.kernels.similarity.rowwise_cosine``: the fp32 dot product of each
aligned pair of rows. ``b`` may be one (D,) row, read for every row of ``a``
through a row stride of 0, which is how the embedding cascade scores a
morsel against its predicate's anchor. ``cosine_matrix`` replaces
``repro.kernels.similarity.cosine_matrix``: the fp32 dot product of every
pair of rows, any M, N and D. ``plain`` and ``plain_matrix`` are the same
functions in plain PyTorch (``kernels.ref``); the wrappers never fall back
to them. The launches are the ops ``repro_torch::rowwise_cosine`` and
``repro_torch::cosine_matrix`` (``_build``).

The cascade calls ``rowwise_cosine`` from several tier-0 worker threads at
once; the launch counts change under ``_build.count_launch``'s lock.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import DTYPES

plain = ref.rowwise_cosine_ref
plain_matrix = ref.cosine_matrix_ref
stats = {"launches": 0}          # rowwise_cosine
matrix_stats = {"launches": 0}   # cosine_matrix


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("similarity").rowwise_cosine_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _matrix_fn():
    fn = _build.library("similarity").cosine_matrix_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_pair(a, b):
    """Both CUDA tensors on one device, of one supported dtype, each with a
    contiguous last axis."""
    for name, t in (("a", a), ("b", b)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != a.dtype:
            raise ValueError(f"{name} is {t.dtype}, a is {a.dtype}")
        if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if a.dtype not in DTYPES:
        raise ValueError(f"dtype {a.dtype} not supported; take {list(DTYPES)}")


def rowwise_cosine(a, b):
    """a: (M, D); b: (M, D), or (D,) for one row against every row of a.
    CUDA tensors on one device, of one dtype (float32 or bfloat16), each
    with a contiguous last axis. Returns a new (M,) float32 tensor:
    out[m] = sum_d a[m, d] * b[m, d], summed in fp32. Raises under grad
    (``_build.refuse_grad``)."""
    _build.refuse_grad("rowwise_cosine", a, b)
    _check_pair(a, b)
    if a.dim() != 2 or b.shape not in (a.shape, a.shape[1:]):
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}: "
                         f"take a (M, D) and b (M, D) or (D,)")
    m, d = a.shape
    if m >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"a {tuple(a.shape)} is too large for int32 indexing")
    return _build.call(torch.ops.repro_torch.rowwise_cosine, _rowwise_impl,
                       a, b)


def _rowwise_impl(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m, d = a.shape
    out = _rowwise_fake(a, b)
    if m == 0:
        return out
    sb = b.stride(0) if b.dim() == 2 else 0
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    DTYPES[a.dtype], m, d, a.stride(0), sb, stream)
    if err:
        raise RuntimeError(f"rowwise_cosine kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(stats)
    return out


_rowwise_op = torch.library.custom_op("repro_torch::rowwise_cosine",
                                      _rowwise_impl, mutates_args=(),
                                      device_types="cuda")


@_rowwise_op.register_fake
def _rowwise_fake(a, b):
    """The (M,) fp32 scores."""
    return a.new_empty((a.shape[0],), dtype=torch.float32)


_build.register_costs(
    torch.ops.repro_torch.rowwise_cosine,
    # 2 FLOPs per element pair
    flops=lambda a, b, out_val=None: 2 * a.numel(),
    # a and b read once, the fp32 scores written once
    nbytes=lambda a, b: (a.numel() + b.numel()) * a.element_size()
    + 4 * a.shape[0])


def cosine_matrix(a, b):
    """a: (M, D), b: (N, D) CUDA tensors on one device, of one dtype
    (float32 or bfloat16), each with a contiguous last axis. Returns a new
    (M, N) float32 tensor: out[m, n] = sum_d a[m, d] * b[n, d], summed in
    fp32. Raises under grad (``_build.refuse_grad``)."""
    _build.refuse_grad("cosine_matrix", a, b)
    _check_pair(a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}: "
                         f"take a (M, D) and b (N, D)")
    (m, d), n = a.shape, b.shape[0]
    if max(m, n, d) >= 2 ** 31 or m >= 64 * 65535:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)} are too "
                         f"large for the kernel's grid and int32 indexing")
    return _build.call(torch.ops.repro_torch.cosine_matrix, _matrix_impl,
                       a, b)


def _matrix_impl(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (m, d), n = a.shape, b.shape[0]
    out = _matrix_fake(a, b)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _matrix_fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                           DTYPES[a.dtype], m, n, d, a.stride(0), b.stride(0),
                           stream)
    if err:
        raise RuntimeError(f"cosine_matrix kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(matrix_stats)
    return out


_matrix_op = torch.library.custom_op("repro_torch::cosine_matrix",
                                     _matrix_impl, mutates_args=(),
                                     device_types="cuda")


@_matrix_op.register_fake
def _matrix_fake(a, b):
    """The (M, N) fp32 scores."""
    return a.new_empty((a.shape[0], b.shape[0]), dtype=torch.float32)


_build.register_costs(
    torch.ops.repro_torch.cosine_matrix,
    # 2 D FLOPs per output
    flops=lambda a, b, out_val=None: 2 * a.shape[0] * b.shape[0] * a.shape[1],
    # a and b read once, the (M, N) fp32 output written once
    nbytes=lambda a, b: (a.numel() + b.numel()) * a.element_size()
    + 4 * a.shape[0] * b.shape[0])
