"""GQA attention (covers MHA and MQA) for the port.

Prefill goes through ``kernels.ops.flash_attention`` and decode through
``kernels.ops.decode_attention``: on the card these launch the Hopper
kernels, on the CPU they run the kernels' plain versions. (The JAX model
calls its XLA attention here; the Pallas kernels compute the same function,
which ``tests/test_kernels.py`` holds.)
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common as cm


def gqa_init(generator, cfg, *, lead=(), device="cuda", dtype=torch.float32):
    h, kv, d, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_model, cfg.head_dim
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {
        "q": cm.dense(generator, d, (h, hd), bias=cfg.qkv_bias, **kw),
        "k": cm.dense(generator, d, (kv, hd), bias=cfg.qkv_bias, **kw),
        "v": cm.dense(generator, d, (kv, hd), bias=cfg.qkv_bias, **kw),
        "o": cm.dense(generator, (h, hd), d, **kw),
    }


def gqa_project_qkv(p, x, positions, theta):
    q = cm.apply_dense(p["q"], x)            # (B,S,H,hd)
    k = cm.apply_dense(p["k"], x)            # (B,S,KV,hd)
    v = cm.apply_dense(p["v"], x)
    return cm.apply_rope(q, positions, theta), cm.apply_rope(k, positions, theta), v


def gqa_forward(p, x, cfg, *, positions, window=0, causal=True, kv_out=None):
    """kv_out: optional (k, v) cache slices (B, max_len, Hkv, D) that
    receive the keys and values of the sequence (prefill)."""
    q, k, v = gqa_project_qkv(p, x, positions, cfg.rope_theta)
    if kv_out is not None:
        kv_out[0][:, :k.shape[1]] = k
        kv_out[1][:, :v.shape[1]] = v
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return cm.apply_dense(p["o"], o, in_dims=2)


def write_kv(cache, new, pos):
    """Write one position per sequence of ``new`` (B, 1, ...) into a
    (B, S, ...) cache, in place. pos: 0-dim (one shared position) or (B,)
    (every slot at its own depth). The JAX model blends a one-hot over the
    whole cache and returns a new one; the scatter writes only the new rows.
    Requires 0 <= pos < S."""
    new = new[:, 0].to(cache.dtype)
    if pos.dim() == 0:
        cache[:, pos] = new
    else:
        cache[torch.arange(cache.shape[0], device=cache.device), pos.long()] = new
    return cache


def gqa_decode(p, x, cache_k, cache_v, pos, cfg, *, cache_len, window=0):
    """x: (B,1,d); caches (B,S,KV,hd), written in place; pos: 0-dim or (B,)
    write index; cache_len: the valid entries after the write, ``pos + 1``
    (a caller looping over layers computes it once); ``window > 0`` (a
    sliding layer) attends to the last ``window`` of them only, as the JAX
    model's decode masks them. Returns (out, cache_k, cache_v)."""
    q = cm.apply_dense(p["q"], x)
    k = cm.apply_dense(p["k"], x)
    v = cm.apply_dense(p["v"], x)
    positions = pos.reshape(-1, 1).expand(x.shape[0], 1)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    write_kv(cache_k, k, pos)
    write_kv(cache_v, v, pos)
    o = ops.decode_attention(q, cache_k, cache_v, cache_len, window=window)
    return cm.apply_dense(p["o"], o, in_dims=2), cache_k, cache_v
