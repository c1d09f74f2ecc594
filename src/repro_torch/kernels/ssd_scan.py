"""Mamba2 SSD chunked scan: wrappers of the Hopper kernels ``csrc/ssd_scan.cu``
(forward) and ``csrc/ssd_scan_bwd.cu`` (backward), the
``torch.autograd.Function`` that joins them, and their plain PyTorch
versions.

The forward kernel replaces the Pallas TPU kernel ``repro.kernels.ssd_scan``:
the chunked dual form of the SSD recurrence on the tensor cores, an fp32
state carried from chunk to chunk, head h reading B/C group h // (H // G); a
block owns 16 columns of P. It takes any S (its own chunk of 64 steps, the
last one ragged) and reads dx, dA, B and C through their strides, so the
model's slices of the conv output need no copy.
``plain`` is the same function in plain PyTorch at a chunk that divides S,
the counterpart of ``repro.models.ssm.ssd_chunked``; the wrapper never falls
back to it. The launches are the ops ``repro_torch::ssd_scan_fwd`` and
``repro_torch::ssd_scan_bwd`` (``_build``).

For training, ``scan`` runs the forward through ``SSDScan``, whose backward
is the backward kernel (the Pallas kernel has no VJP: the JAX model
differentiates XLA's ``ssd_chunked``). ``plain_backward`` is the same
gradient written out chunk by chunk in plain PyTorch, not by autograd:
tests hold it against ``jax.vjp`` of the reference, and ``chip_smoke.py``
holds the kernel against it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

stats = {"launches": 0}
bwd_stats = {"launches": 0}
DEFAULT_CHUNK = 256
BWD_CHUNK = 64  # the kernels' chunk: the backward walks the forward's


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
        # mask BEFORE exp: the upper triangle's deltas overflow. In fp64,
        # so that autograd sums the decay's gradient (large terms that
        # mostly cancel) over each chunk's rows and columns in fp64, as the
        # backward kernel does: in fp32 the A_log gradient at mamba2-1.3b's
        # decays misses tests/test_torch_ssd.py's 1e-4 of its scale
        csd = cs.double()
        delta = csd[:, :, None, :] - csd[:, None, :, :]  # (b, L, L, h)
        decay = torch.exp(torch.where(causal, delta, -1e30)).to(f32)
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


def plain_backward(dx, dA, B, C, initial_state, dy, dstate=None):
    """The gradient of ``plain``'s (y, final state) for its inputs, written
    out chunk by chunk (no autograd), the math the backward kernel runs.
    Any S: the kernel's chunks of ``BWD_CHUNK`` steps, the last one ragged (its missing steps
    read as dA = 0, dx = B = C = dy = 0). ``initial_state`` and ``dstate``
    (the final state's gradient) may be None (zeros). The sums run in fp32
    (Z's row and column sums in fp64, as the kernel's), or all in fp64 when
    dx is fp64. Returns (ddx, ddA, dB, dC, the initial
    state's gradient): ddx, dB and dC in dx's dtype, ddA and the state's
    gradient fp32 (fp64 for fp64 inputs).

    Per (batch, head) and chunk, cs the inclusive running sum of dA in the
    chunk, S0 the state entering it, dS1 the gradient of the state leaving
    it, E_ts = exp(cs_t - cs_s) for s <= t (else 0), M = (C B^T) o E,
    G = dy dx^T, w_s = exp(cs_L - cs_s):
      ddx = M^T dy + w o (B dS1)
      dC  = (G o E) B + exp(cs) o (dy S0^T)
      dB  = (G o E)^T C + w o (dx dS1^T)   (summed over a group's heads)
      dS0 = exp(cs_L) dS1 + (C o exp(cs))^T dy   (the previous chunk's dS1)
      dcs = rowsum(Z) - colsum(Z) + rowsum(y_off o dy) - W, Z = G o M,
            y_off = exp(cs) o (C S0), W_s = w_s sum_p ((B dS1) o dx)_sp;
            dcs_L += sum(W) + exp(cs_L) <S0, dS1>
      ddA = the reverse running sum of dcs within the chunk.
    Three passes: the state entering each chunk (forward), the chain of dS
    (reverse; it reads C, dA and dy only), then every chunk's gradients."""
    b, s, h, p = dx.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    acc = torch.promote_types(dx.dtype, torch.float32)
    L = BWD_CHUNK
    nc = -(-s // L)
    pad = nc * L - s

    def chunked(t, tail):  # (b, s, ...) -> (b, nc, L, ...) in acc, padded
        t = torch.nn.functional.pad(t.to(acc), (0, 0) * tail + (0, pad))
        return t.reshape((b, nc, L) + tuple(t.shape[2:]))
    dxc, dyc = chunked(dx, 2), chunked(dy, 2)
    Bh = chunked(B, 2).repeat_interleave(hg, dim=3)       # (b, nc, L, h, n)
    Ch = chunked(C, 2).repeat_interleave(hg, dim=3)
    cs = torch.cumsum(chunked(dA, 1), dim=2)              # (b, nc, L, h)
    last = cs[:, :, -1]                                   # (b, nc, h)
    ecs, w = torch.exp(cs), torch.exp(last[:, :, None] - cs)
    zeros = torch.zeros((b, h, n, p), dtype=acc, device=dx.device)
    # pass 1: the state entering each chunk
    state = zeros if initial_state is None else initial_state.to(acc)
    s0 = []
    for c in range(nc):
        s0.append(state)
        state = (state * torch.exp(last[:, c])[..., None, None]
                 + torch.einsum("blhn,blhp->bhnp",
                                Bh[:, c] * w[:, c, ..., None], dxc[:, c]))
    # pass 2: the gradient of the state leaving each chunk, in reverse
    dstate_c = zeros if dstate is None else dstate.to(acc)
    ds1 = [None] * nc
    for c in reversed(range(nc)):
        ds1[c] = dstate_c
        dstate_c = (dstate_c * torch.exp(last[:, c])[..., None, None]
                    + torch.einsum("blhn,blhp->bhnp",
                                   Ch[:, c] * ecs[:, c, ..., None],
                                   dyc[:, c]))
    # pass 3: each chunk's gradients
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=dx.device))[None, :, :, None]
    outs = {k: [] for k in ("ddx", "dB", "dC", "ddA")}
    for c in range(nc):
        x, y, Bc, Cc = dxc[:, c], dyc[:, c], Bh[:, c], Ch[:, c]
        S0, dS1, cs_c = s0[c], ds1[c], cs[:, c]
        E = torch.exp((cs_c[:, :, None] - cs_c[:, None, :]).masked_fill(
            ~causal, float("-inf")))
        M = torch.einsum("bthn,bshn->btsh", Cc, Bc) * E   # (b, t, s, h)
        G = torch.einsum("bthp,bshp->btsh", y, x)
        GE = G * E
        BdS = torch.einsum("bshn,bhnp->bshp", Bc, dS1)
        wc, ec = w[:, c], ecs[:, c]
        outs["ddx"].append(torch.einsum("btsh,bthp->bshp", M, y)
                           + wc[..., None] * BdS)
        dCh = (torch.einsum("btsh,bshn->bthn", GE, Bc)
               + ec[..., None] * torch.einsum("bthp,bhnp->bthn", y, S0))
        dBh = (torch.einsum("btsh,bthn->bshn", GE, Cc)
               + wc[..., None] * torch.einsum("bshp,bhnp->bshn", x, dS1))
        outs["dC"].append(dCh.reshape(b, L, g, hg, n).sum(3))
        outs["dB"].append(dBh.reshape(b, L, g, hg, n).sum(3))
        # Z's row and column sums are large and mostly cancel: they are
        # summed in fp64, as in the kernel
        # (tests/test_torch_ssd.py::test_gradients_hold_mamba2_decays)
        Z = (G * M).double()
        W = wc * (BdS * x).sum(-1)                        # (b, L, h)
        y_off = ec[..., None] * torch.einsum("bthn,bhnp->bthp", Cc, S0)
        dcs = (Z.sum(2) - Z.sum(1)).to(acc) + (y_off * y).sum(-1) - W
        dcs[:, -1] += W.sum(1) + torch.exp(last[:, c]) * (S0 * dS1).sum(
            (-2, -1))
        outs["ddA"].append(torch.flip(torch.cumsum(torch.flip(dcs, [1]), 1),
                                      [1]))

    def joined(k, dtype=dx.dtype):
        return torch.cat(outs[k], dim=1)[:, :s].to(dtype)
    return (joined("ddx"), joined("ddA", acc), joined("dB"), joined("dC"),
            dstate_c)


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


def bind_backward(lib):
    """Sets the C signatures of a loaded ``csrc/ssd_scan_bwd.cu`` library;
    returns it."""
    lib.ssd_scan_bwd.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.ssd_scan_bwd.restype = ctypes.c_int
    for fn in (lib.ssd_scan_bwd_smem_bytes, lib.ssd_scan_bwd_max_smem,
               lib.ssd_scan_bwd_scratch):
        fn.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.ssd_scan_bwd_scratch.argtypes = [ctypes.c_int] * 6
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(_build.library("ssd_scan"))


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    return bind_backward(_build.library("ssd_scan_bwd"))


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
    if _build.is_fake(dx):
        return
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
    final state (B, H, N, P) float32) that carry no autograd graph:
    ``scan`` is the differentiable entry point."""
    _check_inputs(dx, dA, B, C, initial_state)
    return _build.call(torch.ops.repro_torch.ssd_scan_fwd, _fwd_impl,
                       dx, dA, B, C, initial_state)


def _fwd_impl(dx: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, initial_state: Optional[torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = dx.shape
    g, n = B.shape[2], B.shape[3]
    y, fin = _fwd_fake(dx, dA, B, C, initial_state)
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


_fwd_op = torch.library.custom_op("repro_torch::ssd_scan_fwd", _fwd_impl,
                                  mutates_args=(), device_types="cuda")


@_fwd_op.register_fake
def _fwd_fake(dx, dA, B, C, initial_state):
    """y like dx, and the fp32 final state (B, H, N, P)."""
    b, s, h, p = dx.shape
    return (dx.new_empty(dx.shape),
            dx.new_empty((b, h, B.shape[3], p), dtype=torch.float32))


def _chunked_least(s, per_chunk) -> int:
    """The least over chunk lengths 1..min(S, 256) of the work of S steps
    cut into chunks of that length (the last one ragged), ``per_chunk(l)``
    the work of a chunk of l steps."""
    best = None
    for step in range(1, min(s, 256) + 1):
        total = (s // step) * per_chunk(step)
        if s % step:
            total += per_chunk(s % step)
        best = total if best is None else min(best, total)
    return best or 0


@functools.lru_cache(maxsize=None)
def scan_flops(s, h, p, n, g) -> int:
    """The fewest FLOPs of an exact form of one sequence's scan: the
    chunked dual form at the chunk length that needs least. Per chunk of l
    steps and head, C . state (2 l N P), the B (x) dx state update
    (2 l N P), the causal decayed scores times dx (l (l + 1) P) and the
    state's decay (N P); per chunk and group, the causal scores C . B^T
    (l (l + 1) N), which the group's heads share. Exps and masks are not
    counted."""
    return _chunked_least(s, lambda l: (
        h * (4 * l * n * p + l * (l + 1) * p + n * p) + g * l * (l + 1) * n))


@functools.lru_cache(maxsize=None)
def scan_bwd_flops(s, h, p, n, g) -> int:
    """The fewest FLOPs of one sequence's scan backward in the chunked form
    of ``plain_backward``, at the chunk length that needs least: per chunk
    of l steps and head, five state products (2 l N P each), M^T dy and
    dy dx^T over the causal pairs (l (l + 1) P each), (G o E) B and
    (G o E)^T C (l (l + 1) N each) and two state decays (N P each); per
    chunk and group, the scores C B^T (l (l + 1) N)."""
    return _chunked_least(s, lambda l: (
        h * (10 * l * n * p + 2 * l * (l + 1) * (p + n) + 2 * n * p)
        + g * l * (l + 1) * n))


def _fwd_flops(dx, dA, B, C, initial_state, out_val=None):
    b, s, h, p = dx.shape
    return b * scan_flops(s, h, p, B.shape[3], B.shape[2])


def _fwd_bytes(dx, dA, B, C, initial_state):
    """dx, dA, B, C (and the initial state) read once, y and the final
    state written once."""
    b, s, h, p = dx.shape
    g, n = B.shape[2], B.shape[3]
    return (b * ((2 * s * h * p + 2 * s * g * n) * dx.element_size()
                 + (s * h + h * n * p) * 4)
            + (0 if initial_state is None else 4 * b * h * n * p))


def ssd_scan_backward(dx, dA, B, C, initial_state, dy, dstate=None):
    """The gradient of ``ssd_scan(dx, dA, B, C, initial_state)`` for its
    inputs, given y's gradient ``dy`` (dx's dtype and shape, any strides)
    and the final state's ``dstate`` (a (B, H, N, P) float32, or None:
    zeros). The inputs as the forward takes them. Returns new tensors
    (ddx, ddA, dB, dC, and the initial state's gradient): ddx, dB and dC in
    dx's dtype, ddA and the state's gradient float32, all contiguous. One
    call counts one launch of up to three kernels, every product on the
    tensor cores (bf16 wgmma; fp32 inputs and fp32 intermediates as three
    bf16 parts): the walk (one block per 64 columns of P, head, batch and
    direction) carries the state forward and its gradient back across the
    chunks, each chunk's local term one product, and writes the state
    entering and the gradient leaving each chunk once to fp32 scratch;
    the chunk pass (one block per chunk, run of a group's heads and batch)
    computes every chunk's gradients and sums dB and dC over the run's
    heads in order; where a group's heads take more than one run, a last
    kernel adds the runs' fp32 sums in run order. No atomics, so two calls
    give the same bits."""
    _check_inputs(dx, dA, B, C, initial_state)
    b, s, h, p = dx.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dy.shape) != (b, s, h, p) or dy.dtype != dx.dtype \
            or dy.device != dx.device:
        raise ValueError(f"dy must match dx: {tuple(dy.shape)} {dy.dtype} "
                         f"on {dy.device}")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dstate is not None and (
            tuple(dstate.shape) != (b, h, n, p)
            or dstate.dtype != torch.float32 or dstate.device != dx.device):
        raise ValueError(f"dstate must be a float32 {(b, h, n, p)} on dx's "
                         f"device, got {tuple(dstate.shape)} {dstate.dtype}")
    dstate = None if dstate is None else dstate.contiguous()
    return _build.call(torch.ops.repro_torch.ssd_scan_bwd, _bwd_impl, dx,
                       dA, B, C, initial_state, dy, dstate)


def _bwd_impl(dx: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, initial_state: Optional[torch.Tensor],
            dy: torch.Tensor, dstate: Optional[torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
    b, s, h, p = dx.shape
    g, n = B.shape[2], B.shape[3]
    lib = _bwd_lib()
    need = lib.ssd_scan_bwd_smem_bytes(n)
    if need > lib.ssd_scan_bwd_max_smem():
        raise ValueError(f"d_state {n}: the backward needs {need} bytes of "
                         f"shared memory a block")
    ddx, ddA, dB, dC, dinit = _bwd_fake(dx, dA, B, C, initial_state, dy,
                                        dstate)
    if s == 0:  # the final state is the initial one
        return ddx, ddA, dB, dC, (dinit.zero_() if dstate is None
                                  else dstate.clone())
    dev = dx.device
    # scratch: the state entering and the gradient leaving each chunk, and
    # the runs' dB and dC (the library sizes it: the runs follow the SMs)
    scratch = torch.empty(lib.ssd_scan_bwd_scratch(b, s, h, g, n, p),
                          dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(
        *dx.stride()[:3], *dA.stride(), *B.stride()[:3], *C.stride()[:3],
        *dy.stride()[:3])

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_bwd(
            dx.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            ptr(initial_state), dy.data_ptr(), ptr(dstate), ddx.data_ptr(),
            ddA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dinit.data_ptr(),
            scratch.data_ptr(), DTYPES[dx.dtype], b, s, h, g, n, p, strides,
            stream)
    if err:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    _build.count_launch(bwd_stats)
    return ddx, ddA, dB, dC, dinit


_bwd_op = torch.library.custom_op("repro_torch::ssd_scan_bwd", _bwd_impl,
                                  mutates_args=(), device_types="cuda")


@_bwd_op.register_fake
def _bwd_fake(dx, dA, B, C, initial_state, dy, dstate):
    """ddx, dB and dC in dx's dtype, ddA and the initial state's gradient
    fp32, all contiguous."""
    b, s, h, p = dx.shape
    n = B.shape[3]
    f32 = torch.float32
    return (dx.new_empty(dx.shape), dx.new_empty(dA.shape, dtype=f32),
            dx.new_empty(B.shape), dx.new_empty(C.shape),
            dx.new_empty((b, h, n, p), dtype=f32))


def _bwd_flops(dx, dA, B, C, initial_state, dy, dstate, out_val=None):
    b, s, h, p = dx.shape
    return b * scan_bwd_flops(s, h, p, B.shape[3], B.shape[2])


def _bwd_bytes(dx, dA, B, C, initial_state, dy, dstate):
    """dx, dA, B, C and dy read once, ddx, ddA, dB and dC written once."""
    b, s, h, p = dx.shape
    g, n = B.shape[2], B.shape[3]
    return b * s * ((3 * h * p + 4 * g * n) * dx.element_size() + 2 * h * 4)


_build.register_costs(torch.ops.repro_torch.ssd_scan_fwd, flops=_fwd_flops,
                      nbytes=_fwd_bytes)
_build.register_costs(torch.ops.repro_torch.ssd_scan_bwd, flops=_bwd_flops,
                      nbytes=_bwd_bytes)


class SSDScan(torch.autograd.Function):
    """The forward kernel; the backward kernel for the gradient, which
    recomputes the chunk states from the saved inputs."""

    @staticmethod
    def forward(ctx, dx, dA, B, C, initial_state):
        y, fin = ssd_scan(dx, dA, B, C, initial_state)
        ctx.save_for_backward(dx, dA, B, C, initial_state)
        # an output the loss does not use gets None, not zeros: training
        # drops the final state, and the kernel reads a null dstate as 0
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dstate):
        dx, dA, B, C, initial_state = ctx.saved_tensors
        if dy is None:  # only the final state reaches the loss
            dy = torch.zeros_like(dx)
        ddx, ddA, dB, dC, dinit = ssd_scan_backward(
            dx, dA, B, C, initial_state, dy, dstate)
        return ddx, ddA, dB, dC, (dinit if ctx.needs_input_grad[4] else None)


def scan(dx, dA, B, C, initial_state=None):
    """``ssd_scan`` that autograd can differentiate: through ``SSDScan``
    where grad is on and an input needs it, else the forward kernel alone,
    exactly as serving launches it."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (dx, dA, B, C, initial_state)):
        return SSDScan.apply(dx, dA, B, C, initial_state)
    return ssd_scan(dx, dA, B, C, initial_state)
