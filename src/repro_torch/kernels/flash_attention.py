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
(``kernels.ref.attention_ref``); the wrapper never falls back to it. The
launches are the ops ``repro_torch::flash_attention_fwd`` and
``repro_torch::flash_attention_bwd`` (``_build``), with their fake
implementations, FLOPs and bytes.

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
# codeqwen1.5-7b, internvl2-76b, deepseek-67b and llama4-scout (128); the
# backward takes them all
HEAD_DIMS = (16, 32, 64, 128)
BWD_HEAD_DIMS = (16, 32, 64, 128)


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
    if not _build.is_fake(q) and not rows_aligned(q, k, v):
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


def attended_pairs(sq, sk, *, causal=True, window=0, q_offset=0,
                   sk_valid=0) -> int:
    """The (query, key) pairs one sequence and query head attends: query
    row i at position i + q_offset against the keys below ``sk_valid``
    (0 = all sk), at or before it where causal, and within ``window`` of it
    (0 = no window). What the kernels compute, tile edges aside."""
    import numpy as np
    skv = int(sk_valid) or sk
    pos = np.arange(sq, dtype=np.int64) + int(q_offset)
    hi = np.minimum(skv - 1, pos) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, pos - int(window) + 1) if window else np.zeros(sq,
                                                                      np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    sk_valid=0, scale=None, return_lse=False):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D), CUDA tensors of one dtype
    (float32 or bfloat16). Query row i sits at absolute position
    i + q_offset; keys at or beyond ``sk_valid`` (0 = all) are masked.
    Returns a new (B, Sq, Hq, D) tensor in q's dtype; with ``return_lse``
    also each row's fp32 log-sum-exp of the scaled scores, (B, Hq, Sq),
    -inf for a row with no valid key. The result carries no autograd
    graph: ``attention`` is the differentiable entry point. One launch of
    ``torch.ops.repro_torch.flash_attention_fwd``."""
    _check_inputs(q, k, v)
    args = (q, k, v, bool(causal), int(window), int(q_offset),
            _sk_valid(sk_valid, k.shape[1]),
            float(q.shape[3] ** -0.5 if scale is None else scale))
    if not return_lse and _build.direct(q):
        return _launch_fwd(*args, None)  # serving: no log-sum-exp buffer
    out, lse = _build.call(torch.ops.repro_torch.flash_attention_fwd,
                           _fwd_impl, *args, bool(return_lse))
    return (out, lse) if return_lse else out


def _launch_fwd(q, k, v, causal, window, q_offset, sk_valid, scale, lse):
    """The forward kernel into a new output; each row's log-sum-exp into
    ``lse`` where one is given."""
    out = q.new_empty(q.shape)
    if out.numel() == 0:
        return out
    b, sq, hq, d = q.shape
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(),
                    DTYPES[q.dtype], b, sq, hq, k.shape[2], d, strides,
                    int(causal), window, q_offset, sk_valid, scale, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(stats)
    return out


def _fwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, q_offset: int, sk_valid: int, scale: float,
            return_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    b, sq, hq, _ = q.shape
    lse = q.new_empty((b, hq, sq) if return_lse else (0,),
                      dtype=torch.float32)
    return _launch_fwd(q, k, v, causal, window, q_offset, sk_valid, scale,
                       lse if return_lse else None), lse


_fwd_op = torch.library.custom_op("repro_torch::flash_attention_fwd",
                                  _fwd_impl, mutates_args=(),
                                  device_types="cuda")


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, window, q_offset, sk_valid, scale,
              return_lse):
    """The outputs the kernel writes: o like q, and the fp32 log-sum-exp
    (B, Hq, Sq) where asked for (else an empty (0,))."""
    b, sq, hq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, hq, sq) if return_lse else (0,),
                        dtype=torch.float32))


def _fwd_flops(q, k, v, causal, window, q_offset, sk_valid, scale,
               return_lse, out_val=None):
    """4 D FLOPs per attended (query, key) pair and query head."""
    b, sq, hq, d = q.shape
    return 4 * d * hq * b * attended_pairs(
        sq, k.shape[1], causal=causal, window=window, q_offset=q_offset,
        sk_valid=sk_valid)


def _fwd_bytes(q, k, v, causal, window, q_offset, sk_valid, scale,
               return_lse):
    """q, k and v read once, o written once, and the log-sum-exp's fp32
    rows where written."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    return (b * (2 * sq * hq * d + 2 * sk * hkv * d) * q.element_size()
            + (4 * b * sq * hq if return_lse else 0))


def flash_attention_backward(q, k, v, out, dout, lse, *, causal=True,
                             window=0, q_offset=0, sk_valid=0, scale=None):
    """dQ, dK and dV of ``flash_attention(q, k, v, ...)`` given its output
    ``out``, the output's gradient ``dout`` and the forward's ``lse``; the
    same masks and scale as the forward. CUDA tensors; q, k, v, out and
    dout of one dtype (float32 or bfloat16), lse fp32 (B, Hq, Sq). Returns
    new tensors in q's dtype, shaped like q, k and v. Head_dim 16, 32, 64 or
    128. One call is one launch of
    ``torch.ops.repro_torch.flash_attention_bwd``, which runs three kernels:
    each row's Delta = rowsum(dO out), then dK and dV (summed over each KV
    head's group) on the current stream beside dQ on a second stream that
    the current one waits for; the two on the tensor cores, but for fp32 at
    head_dim 128 on the CUDA cores. ``out`` and ``dout`` rows that do not
    start 16-byte aligned are copied first."""
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
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
    if not _build.is_fake(out):
        out, dout = (t if t.stride(3) == 1 and rows_aligned(t)
                     else t.clone(memory_format=torch.contiguous_format)
                     for t in (out, dout))
    sk_valid = _sk_valid(sk_valid, k.shape[1])
    scale = float(d ** -0.5 if scale is None else scale)
    return _build.call(
        torch.ops.repro_torch.flash_attention_bwd, _bwd_impl, q, k, v, out,
        dout, lse, bool(causal), int(window), int(q_offset), sk_valid, scale)


def _bwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
            causal: bool, window: int, q_offset: int, sk_valid: int,
            scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dq, dk, dv = _bwd_fake(q, k, v, out, dout, lse, causal, window, q_offset,
                           sk_valid, scale)
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
            hkv, d, strides, int(causal), window, q_offset, sk_valid, scale,
            stream)
    if err:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err}")
    _build.count_launch(bwd_stats)
    return dq, dk, dv


_bwd_op = torch.library.custom_op("repro_torch::flash_attention_bwd",
                                  _bwd_impl, mutates_args=(),
                                  device_types="cuda")


@_bwd_op.register_fake
def _bwd_fake(q, k, v, out, dout, lse, causal, window, q_offset, sk_valid,
              scale):
    """dQ, dK and dV, shaped like q, k and v."""
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _bwd_flops(q, k, v, out, dout, lse, causal, window, q_offset, sk_valid,
               scale, out_val=None):
    """The five products of the backward (S, dP, dV, dQ, dK): 10 D FLOPs
    per attended (query, key) pair and query head."""
    b, sq, hq, d = q.shape
    return 10 * d * hq * b * attended_pairs(
        sq, k.shape[1], causal=causal, window=window, q_offset=q_offset,
        sk_valid=sk_valid)


def _bwd_bytes(q, k, v, out, dout, lse, causal, window, q_offset, sk_valid,
               scale):
    """q, k, v, o, dO and the log-sum-exp read once, dQ, dK and dV written
    once."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    return (b * (4 * sq * hq + 4 * sk * hkv) * d * q.element_size()
            + 4 * b * hq * sq)


_build.register_costs(torch.ops.repro_torch.flash_attention_fwd,
                      flops=_fwd_flops, nbytes=_fwd_bytes)
_build.register_costs(torch.ops.repro_torch.flash_attention_bwd,
                      flops=_bwd_flops, nbytes=_bwd_bytes)


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
