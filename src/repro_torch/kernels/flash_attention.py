"""Flash attention (prefill and training): wrappers of the Hopper kernels
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward), the ``torch.autograd.Function`` that joins them, and their
plain PyTorch versions.

The kernel replaces the Pallas TPU kernel ``repro.kernels.flash_attention``.
It takes the model layout (B, S, H, D) through strides, so the wrapper makes
no transposed copy; it masks the ragged tile edges itself, so nothing is
padded. Its rows are read as 16-byte vectors: the wrapper raises on a tensor
whose rows do not start 16-byte aligned (the model's tensors and its
layer-stacked cache slices do at head_dim 16, 32, 64
and 128). ``plain`` is the same function in plain PyTorch
(``kernels.ref.attention_ref``); the wrapper never falls back to it.

For training, ``attention`` runs the forward through ``FlashAttention``:
the forward kernel also writes each row's log-sum-exp, and the backward
kernel computes dQ, dK and dV from it (the JAX model differentiates XLA's
attention; the Pallas kernel has no VJP). ``plain_backward`` is the same
gradient in plain PyTorch, autograd of ``plain``: tests and
``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

plain = ref.attention_ref
plain_lse = ref.attention_lse_ref
stats = {"launches": 0}
bwd_stats = {"launches": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# qwen2-0.5b reduced (16), the rewriter's model (32), most archs (64),
# codeqwen1.5-7b (128; forward only: its training needs more than a card)
HEAD_DIMS = (16, 32, 64, 128)
BWD_HEAD_DIMS = (16, 32, 64)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = _build.library("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
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


def _sk_valid(sk_valid, sk):
    sk_valid = int(sk_valid) or sk
    if not 0 < sk_valid <= sk:
        raise ValueError(f"sk_valid {sk_valid} outside (0, {sk}]")
    return sk_valid


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    sk_valid=0, scale=None, return_lse=False):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D), CUDA tensors of one dtype
    (float32 or bfloat16). Query row i sits at absolute position
    i + q_offset; keys at or beyond ``sk_valid`` (0 = all) are masked.
    Returns a new (B, Sq, Hq, D) tensor in q's dtype; with ``return_lse``
    also each row's fp32 log-sum-exp of the scaled scores, (B, Hq, Sq),
    -inf for a row with no valid key. The result carries no autograd
    graph: ``attention`` is the differentiable entry point."""
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    sk_valid = _sk_valid(sk_valid, sk)
    scale = float(d ** -0.5 if scale is None else scale)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(),
                    DTYPES[q.dtype], b, sq, hq, k.shape[2], d, strides,
                    int(causal), int(window), int(q_offset), sk_valid, scale,
                    stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(stats)
    return (out, lse) if return_lse else out


def flash_attention_backward(q, k, v, out, dout, lse, *, causal=True,
                             window=0, q_offset=0, sk_valid=0, scale=None):
    """dQ, dK and dV of ``flash_attention(q, k, v, ...)`` given its output
    ``out``, the output's gradient ``dout`` and the forward's ``lse``; the
    same masks and scale as the forward. CUDA tensors; q, k, v, out and
    dout of one dtype (float32 or bfloat16), lse fp32 (B, Hq, Sq). Returns
    new tensors in q's dtype, shaped like q, k and v. Head_dim 16, 32 or 64:
    128 (codeqwen1.5-7b) trains only across cards, which the port does not
    yet do. One call counts one launch of three kernels: each row's
    Delta = rowsum(dO out), then dK and dV (summed over each KV head's
    group) on the current stream beside dQ on a second stream that the
    current one waits for; the two on the tensor cores. ``out`` and
    ``dout`` rows that do not start 16-byte aligned are copied first."""
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the backward kernel takes "
                         f"{BWD_HEAD_DIMS}")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous fp32 {(b, hq, sq)} on "
                         f"q's device")
    out, dout = (t if t.stride(3) == 1 and rows_aligned(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (out, dout))
    sk_valid = _sk_valid(sk_valid, sk)
    scale = float(d ** -0.5 if scale is None else scale)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), DTYPES[q.dtype], b, sq, sk, hq,
            hkv, d, strides, int(causal), int(window), int(q_offset),
            sk_valid, scale, stream)
    if err:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err}")
    _build.count_launch(bwd_stats)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel, saving its output and log-sum-exp; the backward
    kernel for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, sk_valid):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  sk_valid=sk_valid)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, lse,
                                              **ctx.kw)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, causal=True, window=0, q_offset=0, sk_valid=0):
    """``flash_attention`` that autograd can differentiate: through
    ``FlashAttention`` where grad is on and an input needs it, else the
    forward kernel alone, exactly as serving launches it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    sk_valid)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, sk_valid=sk_valid)


def plain_backward(q, k, v, dout, **kw):
    """(dQ, dK, dV) of ``plain(q, k, v, **kw)`` against the output gradient
    ``dout``, by autograd, in the inputs' dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = plain(*leaves, **kw)
        return torch.autograd.grad(out, leaves, dout)
