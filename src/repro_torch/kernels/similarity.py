"""Row-wise cosine: wrapper of the Hopper kernel ``csrc/similarity.cu`` and
its plain PyTorch version.

The kernel replaces the Pallas TPU kernel
``repro.kernels.similarity.rowwise_cosine``: the fp32 dot product of each
aligned pair of rows. ``b`` may be one (D,) row, read for every row of ``a``
through a row stride of 0, which is how the embedding cascade scores a
morsel against its predicate's anchor. ``plain`` is the same function in
plain PyTorch (``kernels.ref.rowwise_cosine_ref``); the wrapper never falls
back to it.

The cascade calls the wrapper from several tier-0 worker threads at once,
so the launch count is incremented under a lock.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import DTYPES

plain = ref.rowwise_cosine_ref
stats = {"launches": 0}
_stats_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("similarity").rowwise_cosine_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rowwise_cosine(a, b):
    """a: (M, D); b: (M, D), or (D,) for one row against every row of a.
    CUDA tensors on one device, of one dtype (float32 or bfloat16), each
    with a contiguous last axis. Returns a new (M,) float32 tensor:
    out[m] = sum_d a[m, d] * b[m, d], summed in fp32."""
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
    if a.dim() != 2 or b.shape not in (a.shape, a.shape[1:]):
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}: "
                         f"take a (M, D) and b (M, D) or (D,)")
    m, d = a.shape
    if m >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"a {tuple(a.shape)} is too large for int32 indexing")
    out = torch.empty((m,), dtype=torch.float32, device=a.device)
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
    with _stats_lock:
        stats["launches"] += 1
    return out
