"""Mamba2 SSD chunked scan: wrapper of the Hopper kernel ``csrc/ssd_scan.cu``
and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``repro.kernels.ssd_scan``: the
chunked dual form of the SSD recurrence on the tensor cores, an fp32 state
carried from chunk to chunk, head h reading B/C group h // (H // G); a
block owns 16 columns of P. It takes any S (its own chunk of 64 steps, the
last one ragged) and reads dx, dA, B and C through their strides, so the
model's slices of the conv output need no copy.
``plain`` is the same function in plain PyTorch at a chunk that divides S,
the counterpart of ``repro.models.ssm.ssd_chunked``; the wrapper never falls
back to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

stats = {"launches": 0}
DEFAULT_CHUNK = 256


def model_chunk(s: int, chunk: int = 0) -> int:
    """The chunk the JAX model and ``ops`` give the plain version: ``chunk``
    or min(256, S), halved until it divides S."""
    chunk = chunk or min(DEFAULT_CHUNK, s)
    while s % chunk:
        chunk //= 2
    return chunk


def plain(dx, dA, B, C, initial_state=None, *, chunk):
    """Chunked SSD, all fp32 math on the state path. dx: (B, S, H, P) inputs
    pre-multiplied by dt; dA: (B, S, H) per-step log-decay; B/C:
    (B, S, G, N); S % chunk == 0. Returns (y (B, S, H, P) in dx's dtype,
    final state (B, H, N, P) fp32)."""
    b, s, h, p = dx.shape
    g, n = B.shape[2], B.shape[3]
    if chunk <= 0 or s % chunk:
        raise ValueError(f"chunk {chunk} does not divide S = {s}")
    nc, hg = s // chunk, h // g
    f32 = torch.float32
    dxc = dx.reshape(b, nc, chunk, h, p)
    dAc = dA.reshape(b, nc, chunk, h).to(f32)
    Bc = B.reshape(b, nc, chunk, g, n).to(f32)
    Cc = C.reshape(b, nc, chunk, g, n).to(f32)
    state = (torch.zeros((b, h, n, p), dtype=f32, device=dx.device)
             if initial_state is None else initial_state.to(f32))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=dx.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        dx_i = dxc[:, c].to(f32)
        B_i, C_i = Bc[:, c], Cc[:, c]
        cs = torch.cumsum(dAc[:, c], dim=1)              # (b, L, h) inclusive
        scores = torch.einsum("blgn,bsgn->blsg", C_i, B_i)
        # mask BEFORE exp: the upper triangle's deltas overflow
        delta = cs[:, :, None, :] - cs[:, None, :, :]    # (b, L, L, h)
        decay = torch.exp(torch.where(causal, delta, -1e30))
        m = scores.repeat_interleave(hg, dim=-1) * decay
        y_diag = torch.einsum("blsh,bshp->blhp", m, dx_i)
        C_h = C_i.repeat_interleave(hg, dim=2)           # (b, L, h, n)
        y_off = torch.einsum("blhn,bhnp->blhp",
                             C_h * torch.exp(cs)[..., None], state)
        dec_end = torch.exp(cs[:, -1:, :] - cs)          # (b, L, h)
        B_h = B_i.repeat_interleave(hg, dim=2)
        state_new = torch.einsum("blhn,blhp->bhnp",
                                 B_h * dec_end[..., None], dx_i)
        state = state * torch.exp(cs[:, -1])[:, :, None, None] + state_new
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(dx.dtype), state


def bind(lib):
    """Sets the C signatures of a loaded ``csrc/ssd_scan.cu`` library (the
    shipped build or a timing probe's); returns it."""
    lib.ssd_scan_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.ssd_scan_fwd.restype = ctypes.c_int
    for fn in (lib.ssd_scan_smem_bytes, lib.ssd_scan_max_smem):
        fn.restype = ctypes.c_longlong
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(_build.library("ssd_scan"))


def _check_inputs(dx, dA, B, C, initial_state):
    """Raise on what the kernel does not take."""
    named = (("dx", dx), ("dA", dA), ("B", B), ("C", C))
    if initial_state is not None:
        named += (("initial_state", initial_state),)
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != dx.device:
            raise ValueError(f"{name} is on {t.device}, dx on {dx.device}")
    if dx.dtype not in DTYPES:
        raise ValueError(f"dtype {dx.dtype} not supported; take {list(DTYPES)}")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != dx.dtype:
            raise ValueError(f"{name} is {t.dtype}, dx is {dx.dtype}")
    for name, t in (("dA", dA), ("initial_state", initial_state)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if dx.dim() != 4 or B.dim() != 4:
        raise ValueError(f"dx {tuple(dx.shape)} and B {tuple(B.shape)} must "
                         f"be (B, S, H, P) and (B, S, G, N)")
    b, s, h, p = dx.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(dA.shape) != (b, s, h) or tuple(B.shape[:2]) != (b, s)
            or C.shape != B.shape):
        raise ValueError(f"shapes dx {tuple(dx.shape)}, dA {tuple(dA.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)} do not match")
    if g == 0 or h % g:
        raise ValueError(f"{h} heads do not group over {g} B/C groups")
    if p % 4 or n % 4:
        raise ValueError(f"head_dim {p} and d_state {n} must be multiples of 4")
    for name, t in (("dx", dx), ("B", B), ("C", C)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if initial_state is not None and (
            tuple(initial_state.shape) != (b, h, n, p)
            or not initial_state.is_contiguous()):
        raise ValueError(f"initial_state must be a contiguous {(b, h, n, p)}, "
                         f"got {tuple(initial_state.shape)}")
    lib = _lib()
    need, most = lib.ssd_scan_smem_bytes(n), lib.ssd_scan_max_smem()
    if need > most:
        raise ValueError(f"d_state {n} needs {need} bytes of shared memory, "
                         f"more than a block's {most} (d_state <= 128)")


def ssd_scan(dx, dA, B, C, initial_state=None):
    """dx: (B, S, H, P) and B/C: (B, S, G, N) CUDA tensors of one dtype
    (float32 or bfloat16), each with a contiguous last axis; dA: (B, S, H)
    float32; initial_state: None (zeros) or a contiguous (B, H, N, P)
    float32. Any S. Returns new tensors (y (B, S, H, P) in dx's dtype,
    final state (B, H, N, P) float32). Raises under grad
    (``_build.refuse_grad``): the scan has no backward kernel yet."""
    _build.refuse_grad("ssd_scan", dx, dA, B, C, initial_state)
    _check_inputs(dx, dA, B, C, initial_state)
    b, s, h, p = dx.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, s, h, p), dtype=dx.dtype, device=dx.device)
    fin = torch.empty((b, h, n, p), dtype=torch.float32, device=dx.device)
    if b == 0 or h == 0:
        return y, fin
    strides = (ctypes.c_longlong * 12)(
        *dx.stride()[:3], *dA.stride(), *B.stride()[:3], *C.stride()[:3])
    init = None if initial_state is None else initial_state.data_ptr()
    with torch.cuda.device(dx.device):
        stream = torch.cuda.current_stream(dx.device).cuda_stream
        err = _lib().ssd_scan_fwd(
            dx.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), init,
            y.data_ptr(), fin.data_ptr(), DTYPES[dx.dtype], b, s, h, g, n, p,
            strides, stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    _build.count_launch(stats)
    return y, fin
