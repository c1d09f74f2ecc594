"""Decode attention: wrapper of the Hopper kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``repro.kernels.decode_attention``
with flash-decoding in one launch: the warps of a block (or of a
thread-block cluster, for long caches) take 32-key tiles and merge their
softmax states on chip, with no scratch in device memory. It reads the
engine's (B, S, Hkv, D) cache slice in place through its strides and
``cache_len`` on the device. A sliding ``window`` (which the TPU kernel
lacks; the JAX model masks it in its einsum decode) starts each sequence's
keys at ``cache_len - window``, so no tile before the window is loaded.
``plain`` is the same function in plain PyTorch
(``kernels.ref.decode_attention_ref``); the wrapper never falls back to
it. The launch is the op ``repro_torch::decode_attention`` (``_build``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import DTYPES

plain = ref.decode_attention_ref
stats = {"launches": 0}
HEAD_DIMS = (16, 64, 128)  # qwen2-0.5b reduced; 64 most archs; codeqwen1.5-7b
MAX_GROUP = 16


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_cache, v_cache, cache_len, window=0):
    """q: (B, 1, Hq, D); caches (B, S, Hkv, D); cache_len: (B,) int32, all
    CUDA tensors (q and the caches of one dtype, float32 or bfloat16).
    ``window > 0`` keeps the last ``window`` valid keys of each sequence
    (keys at positions below cache_len - window are masked). Returns a new
    (B, 1, Hq, D) tensor in q's dtype: the only allocation; one kernel
    launch, no scratch. Raises under grad (``_build.refuse_grad``)."""
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("cache_len", cache_len)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"{name} must be 4-D with a contiguous last axis")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported; take {list(DTYPES)}")
    b, one, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    if one != 1 or k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
                         f"do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; take {HEAD_DIMS}")
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq} query heads over {hkv} KV heads: the group "
                         f"must be an integer up to {MAX_GROUP}")
    if window < 0:
        raise ValueError(f"window {window} < 0 (0 = full attention)")
    if cache_len.dtype != torch.int32 or cache_len.shape != (b,) \
            or not cache_len.is_contiguous():
        raise ValueError(f"cache_len must be a contiguous ({b},) int32 tensor")
    return _build.call(torch.ops.repro_torch.decode_attention, _impl, q,
                       k_cache, v_cache, cache_len, int(window),
                       float(d ** -0.5))


def _impl(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
        cache_len: torch.Tensor, window: int, scale: float) -> torch.Tensor:
    b, _, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    out = _fake(q, k_cache, v_cache, cache_len, window, scale)
    if b == 0 or s == 0:
        return out.zero_()
    fn = _lib()
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], out.stride(0), out.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 cache_len.data_ptr(), out.data_ptr(), DTYPES[q.dtype], b,
                 s, hq, hkv, d, window, strides, scale, stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    _build.count_launch(stats)
    return out


_op = torch.library.custom_op("repro_torch::decode_attention", _impl,
                              mutates_args=(), device_types="cuda")


@_op.register_fake
def _fake(q, k_cache, v_cache, cache_len, window, scale):
    """The (B, 1, Hq, D) output, in q's dtype."""
    return q.new_empty(q.shape)


def attended(k_cache, cache_len, window) -> int:
    """The cache rows the kernel reads over all sequences: each one's
    valid entries, or its window's. A fake ``cache_len`` has no values:
    then every sequence's whole cache (or window) counts."""
    s = k_cache.shape[1]
    if _build.is_fake(cache_len) or cache_len.device.type == "meta":
        return cache_len.shape[0] * (min(s, window) if window else s)
    lens = cache_len.detach().to("cpu", torch.int64).clamp(0, s)
    return int((lens.clamp(max=window) if window else lens).sum())


def _flops(q, k_cache, v_cache, cache_len, window, scale, out_val=None):
    """4 D FLOPs per (query head, attended key) pair."""
    return 4 * q.shape[3] * q.shape[2] * attended(k_cache, cache_len, window)


def _bytes(q, k_cache, v_cache, cache_len, window, scale):
    """q and the attended K/V rows read once, cache_len read, o written."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    return ((2 * b * hq * d + 2 * attended(k_cache, cache_len, window)
             * hkv * d) * q.element_size() + 4 * b)


_build.register_costs(torch.ops.repro_torch.decode_attention, flops=_flops,
                      nbytes=_bytes)
