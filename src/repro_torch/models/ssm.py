"""Mamba2 SSD (state-space duality) mixer of the port. [arXiv:2405.21060]

Prefill runs the chunked dual form through ``kernels.ops.ssd_scan``: on the
card it launches the Hopper kernel, on the CPU it runs the kernel's plain
version, the counterpart of ``repro.models.ssm.ssd_chunked``. (The JAX model
runs its ``ssd_chunked`` here; the Pallas kernel computes the same function,
which ``tests/test_kernels.py`` holds.) Decode is a single recurrent state
update in plain PyTorch: the reference has no kernel for it.

Weights keep the layouts of ``repro.models.ssm``; init takes an explicit
generator and device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import common as cm


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


def mamba2_init(generator, cfg, *, lead=(), device="cuda",
                dtype=torch.float32):
    """As the JAX init: A_log = log(1..H), D = 1, dt_bias = 0, conv_w
    N(0, 1) * 0.1; dense weights truncated-normal over sqrt(fan_in)."""
    s = cfg.ssm
    d_inner, nh, conv_ch = dims(cfg)
    kw = dict(lead=lead, device=device, dtype=dtype)
    lead = tuple(lead)
    conv_w = torch.randn(lead + (s.conv_width, conv_ch), generator=generator,
                         device=device, dtype=torch.float32) * 0.1
    a_log = torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                   device=device))
    return {
        "z_proj": cm.dense(generator, cfg.d_model, d_inner, **kw),
        "xbc_proj": cm.dense(generator, cfg.d_model, conv_ch, **kw),
        "dt_proj": cm.dense(generator, cfg.d_model, nh, **kw),
        "out_proj": cm.dense(generator, d_inner, cfg.d_model, **kw),
        "conv_w": conv_w.to(dtype),
        "dt_bias": torch.zeros(lead + (nh,), device=device, dtype=dtype),
        "A_log": a_log.expand(lead + (nh,)).to(dtype).clone(),
        "D": torch.ones(lead + (nh,), device=device, dtype=dtype),
        "norm": cm.rmsnorm_init(d_inner, **kw),
    }


def _causal_conv(x, w):
    """Depthwise causal conv. x: (B, S, C); w: (W, C)."""
    wdt = w.to(x.dtype)
    width, seq = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + seq] * wdt[i]
    return out


def _group_to_heads(x, h):
    """(b, g, n) -> (b, h, n) fp32, each group repeated h // g times."""
    return x.float().repeat_interleave(h // x.shape[1], dim=1)


def mamba2_forward(p, x, cfg):
    """x: (B, S, d_model) -> (out (B, S, d_model), (final ssm_state
    (B, H, N, P) fp32, conv_buf (B, W-1, conv_ch): the last W-1 conv
    inputs, front-padded with zeros when S < W-1))."""
    s = cfg.ssm
    d_inner, nh, _ = dims(cfg)
    b, seq, _ = x.shape
    gn = s.n_groups * s.d_state

    z = cm.apply_dense(p["z_proj"], x)                       # (B,S,di)
    xbc = cm.apply_dense(p["xbc_proj"], x)                   # (B,S,cc)
    conv = F.silu(_causal_conv(xbc, p["conv_w"]))
    xin = conv[..., :d_inner]
    Bmat = conv[..., d_inner:d_inner + gn].reshape(b, seq, s.n_groups,
                                                   s.d_state)
    Cmat = conv[..., d_inner + gn:].reshape(b, seq, s.n_groups, s.d_state)

    dt = F.softplus(cm.apply_dense(p["dt_proj"], x).float()
                    + p["dt_bias"].float())                  # (B,S,H)
    A = -torch.exp(p["A_log"].float())                       # (H,)
    dA = dt * A                                              # log decay
    xh = xin.reshape(b, seq, nh, s.head_dim)
    dx = xh * dt[..., None].to(xh.dtype)

    chunk = min(s.chunk_size, seq)
    y, state = ops.ssd_scan(dx, dA, Bmat, Cmat, chunk=chunk)
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(b, seq, d_inner)
    y = cm.rmsnorm(p["norm"], y * F.silu(z), cfg.rms_eps)
    out = cm.apply_dense(p["out_proj"], y)
    width = s.conv_width
    conv_buf = (xbc[:, seq - (width - 1):] if seq >= width - 1
                else F.pad(xbc, (0, 0, width - 1 - seq, 0)))
    return out, (state, conv_buf)


def mamba2_decode(p, x, state, conv_buf, cfg):
    """One-token step. x: (B, 1, d_model); state (B, H, N, P) fp32;
    conv_buf (B, W-1, conv_ch). Returns (y (B, 1, d_model), new state,
    new conv_buf)."""
    s = cfg.ssm
    d_inner, nh, _ = dims(cfg)
    b = x.shape[0]
    gn = s.n_groups * s.d_state

    z = cm.apply_dense(p["z_proj"], x)[:, 0]                 # (B,di)
    xbc = cm.apply_dense(p["xbc_proj"], x)[:, 0]             # (B,cc)
    window = torch.cat([conv_buf.to(xbc.dtype), xbc[:, None]], dim=1)
    conv = F.silu(torch.einsum("bwc,wc->bc", window,
                               p["conv_w"].to(xbc.dtype)))
    new_buf = window[:, 1:]

    xin = conv[:, :d_inner]
    Bmat = conv[:, d_inner:d_inner + gn].reshape(b, s.n_groups, s.d_state)
    Cmat = conv[:, d_inner + gn:].reshape(b, s.n_groups, s.d_state)

    dt = F.softplus(cm.apply_dense(p["dt_proj"], x)[:, 0].float()
                    + p["dt_bias"].float())                  # (B,H)
    A = -torch.exp(p["A_log"].float())
    da = torch.exp(dt * A)                                   # (B,H)
    xh = xin.reshape(b, nh, s.head_dim).float()
    B_h, C_h = _group_to_heads(Bmat, nh), _group_to_heads(Cmat, nh)
    # state <- decay * state + dt * B (x) x
    upd = torch.einsum("bhn,bhp->bhnp", B_h, xh * dt[..., None])
    state = state * da[:, :, None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", C_h, state)            # (B,H,P)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(b, d_inner).to(x.dtype)
    y = cm.rmsnorm(p["norm"], y * F.silu(z), cfg.rms_eps)
    out = cm.apply_dense(p["out_proj"], y)[:, None]          # (B,1,d_model)
    return out, state, new_buf
