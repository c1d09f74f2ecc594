"""Flash attention (prefill): wrapper of the Hopper kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``repro.kernels.flash_attention``.
It takes the model layout (B, S, H, D) through strides, so the wrapper makes
no transposed copy; it masks the ragged tile edges itself, so nothing is
padded. Its rows are read as 16-byte vectors: the wrapper raises on a tensor
whose rows do not start 16-byte aligned (the model's tensors and its
layer-stacked cache slices do at head_dim 16, 64 and
128). ``plain`` is the same function in plain PyTorch
(``kernels.ref.attention_ref``); the wrapper never falls back to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

plain = ref.attention_ref
stats = {"launches": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)  # qwen2-0.5b reduced; 64 most archs; codeqwen1.5-7b


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rows_aligned(*tensors) -> bool:
    """Whether every (batch, position, head) row of the tensors starts
    16-byte aligned: their data pointers and their batch, position and head
    strides in bytes are multiples of 16. One OR over all of them, as the
    check runs on every prefill call."""
    bits = 0
    for t in tensors:
        s0, s1, s2 = t.stride()[:3]
        bits |= t.data_ptr() | (s0 | s1 | s2) * t.element_size()
    return bits % 16 == 0


def _check_inputs(q, k, v):
    """Raise on what the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got {tuple(t.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported; take {list(DTYPES)}")
    b, _, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; take {HEAD_DIMS}")
    if not rows_aligned(q, k, v):
        raise ValueError("q, k and v rows must start 16-byte aligned (data "
                         "pointers and strides)")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"{hq} query heads do not group over {k.shape[2]} "
                         f"KV heads")


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    sk_valid=0, scale=None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D), CUDA tensors of one dtype
    (float32 or bfloat16). Query row i sits at absolute position
    i + q_offset; keys at or beyond ``sk_valid`` (0 = all) are masked.
    Returns a new (B, Sq, Hq, D) tensor in q's dtype."""
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    sk_valid = int(sk_valid) or sk
    if not 0 < sk_valid <= sk:
        raise ValueError(f"sk_valid {sk_valid} outside (0, {sk}]")
    scale = float(d ** -0.5 if scale is None else scale)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    DTYPES[q.dtype], b, sq, hq, k.shape[2], d, strides,
                    int(causal), int(window), int(q_offset), sk_valid, scale,
                    stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(stats)
    return out
