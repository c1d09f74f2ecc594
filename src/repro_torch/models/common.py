"""Shared layers of the model zoo: dense, embedding, RMSNorm, RoPE, and
the training loss (softmax cross-entropy).

Parameters are nested dicts of tensors with the same keys and layouts as
``repro``'s Param trees: a dense weight is ``(d_in..., d_out...)`` and
``apply_dense`` contracts the last ``in_dims`` dims of ``x`` with the first
``in_dims`` of ``w``. Weights of the decoder's layers carry a leading
``layer`` axis (``lead=(n_layers,)`` at init); ``layer_params`` takes one
layer's slice as views.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _trunc_normal(shape, scale, generator, device, dtype):
    w = torch.empty(shape, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


def dense(generator: Optional[torch.Generator], d_in, d_out, *, bias=False,
          lead=(), device="cuda", dtype=torch.float32, scale=1.0):
    """Dense layer params. d_in/d_out may be ints or tuples (fused dims);
    ``lead`` prepends stacking dims (the layer axis)."""
    d_in_t = d_in if isinstance(d_in, tuple) else (d_in,)
    d_out_t = d_out if isinstance(d_out, tuple) else (d_out,)
    fan_in = int(np.prod(d_in_t))
    p = {"w": _trunc_normal(tuple(lead) + d_in_t + d_out_t,
                            scale / np.sqrt(fan_in), generator, device, dtype)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + d_out_t, device=device, dtype=dtype)
    return p


def apply_dense(p, x, *, in_dims=1):
    """y = x @ w (+ b), contracting the last ``in_dims`` dims of x with the
    first ``in_dims`` dims of w."""
    y = torch.tensordot(x, p["w"].to(x.dtype), dims=in_dims)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embedding(generator, vocab, d_model, *, device="cuda",
              dtype=torch.float32):
    w = torch.randn((vocab, d_model), generator=generator, device=device,
                    dtype=torch.float32) * 0.02
    return {"embedding": w.to(dtype)}


def rmsnorm_init(d, *, lead=(), device="cuda", dtype=torch.float32):
    return {"scale": torch.ones(tuple(lead) + (d,), device=device, dtype=dtype)}


def rmsnorm(p, x, eps=1e-5):
    """Computed in fp32, then cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layer_params(tree, layer: int):
    """One layer's slice of a stacked (leading ``layer`` axis) param tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, layer) for k, v in tree.items()}
    return tree[layer]


def softmax_cross_entropy(logits, labels, mask=None):
    """logits (..., V); labels int ids; mask optional {0, 1} of labels'
    shape. The mean negative log-likelihood in fp32, over the mask's ones
    where it is given. The reference reads the label's logit with a
    one-hot reduction (it keeps a vocab-sharded reduction sharded under
    GSPMD); a gather gives the same value."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Split-half rotation in fp32. x: (..., S, H, D); positions
    broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)            # (D/2,)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    sin = torch.sin(angles)[..., None, :]                    # (..., S, 1, D/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
