"""Attention mixers of the port: GQA (covers MHA and MQA) and MLA
(multi-head latent attention, MiniCPM3).

GQA prefill goes through ``kernels.ops.flash_attention`` and decode through
``kernels.ops.decode_attention`` (with the int8 cache, over its dequantized
copy): on the card these launch the Hopper
kernels, on the CPU they run the kernels' plain versions. (The JAX model
calls its XLA attention here; the Pallas kernels compute the same function,
which ``tests/test_kernels.py`` holds.)

MLA is written out in plain PyTorch, as the reference computes it in jnp
outside any Pallas kernel: prefill expands the latent to per-head keys and
values (qk head ``qk_nope + qk_rope`` against a v head ``v_head_dim``,
which the attention kernels, equal-width, do not take), and decode scores
the cached latent directly with the up-projections absorbed.
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


# ---------------------------------------------------------------------------
# int8 KV cache: int8 values and one bf16 scale per (position, KV head)
# ---------------------------------------------------------------------------

def quant_kv(x):
    """x: (B, 1, KV, D) -> (int8 values, bf16 scales (B, 1, KV)), the
    reference's arithmetic: scale = max|x| / 127 in fp32, values
    round(x / max(scale, 1e-8)) half to even, clipped to +-127; the scale
    is stored rounded to bf16."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / torch.clamp(scale[..., None], min=1e-8))
    return q.clamp(-127, 127).to(torch.int8), scale.to(torch.bfloat16)


def dequant_kv(cache, scale, dtype):
    """(B, S, KV, D) int8 x (B, S, KV) bf16 -> ``dtype``: the values times
    the stored bf16 scale, both cast to ``dtype`` first."""
    return cache.to(dtype) * scale[..., None].to(dtype)


def gqa_decode_q8(p, x, cache_k, cache_v, k_scale, v_scale, pos, cfg, *,
                  cache_len, window=0):
    """``gqa_decode`` against an int8 cache: the post-rope k and v are
    quantized and written with their scales (in place), and the whole cache
    is dequantized to x's dtype for ``ops.decode_attention``, as the
    reference dequantizes before its attention. Returns (out, cache_k,
    cache_v, k_scale, v_scale)."""
    q = cm.apply_dense(p["q"], x)
    k = cm.apply_dense(p["k"], x)
    v = cm.apply_dense(p["v"], x)
    positions = pos.reshape(-1, 1).expand(x.shape[0], 1)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    kq, ks = quant_kv(k)
    vq, vs = quant_kv(v)
    write_kv(cache_k, kq, pos)
    write_kv(cache_v, vq, pos)
    write_kv(k_scale, ks, pos)
    write_kv(v_scale, vs, pos)
    o = ops.decode_attention(q, dequant_kv(cache_k, k_scale, x.dtype),
                             dequant_kv(cache_v, v_scale, x.dtype), cache_len,
                             window=window)
    return (cm.apply_dense(p["o"], o, in_dims=2), cache_k, cache_v, k_scale,
            v_scale)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(generator, cfg, *, lead=(), device="cuda", dtype=torch.float32):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {
        "q_down": cm.dense(generator, d, m.q_lora_rank, **kw),
        "q_up": cm.dense(generator, m.q_lora_rank, (h, qk_head), **kw),
        "kv_down": cm.dense(generator, d, m.kv_lora_rank, **kw),
        "k_rope": cm.dense(generator, d, (1, m.qk_rope_head_dim), **kw),
        "k_up": cm.dense(generator, m.kv_lora_rank, (h, m.qk_nope_head_dim),
                         **kw),
        "v_up": cm.dense(generator, m.kv_lora_rank, (h, m.v_head_dim), **kw),
        "o": cm.dense(generator, (h, m.v_head_dim), d, **kw),
    }


def _mla_scale(m):
    """The score scale of prefill and decode alike: (qk_nope + qk_rope)^-0.5."""
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _mla_query(p, x, positions, cfg):
    """(q_nope (B,S,H,nd), q_rope (B,S,H,rd) rotated)."""
    m = cfg.mla
    q = cm.apply_dense(p["q_up"], cm.apply_dense(p["q_down"], x))
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    return q_nope, cm.apply_rope(q_rope, positions, cfg.rope_theta)


def mla_latent(p, x, positions, cfg):
    """What the MLA cache holds: (c_kv (B,S,r), k_rope (B,S,rd) rotated)."""
    c_kv = cm.apply_dense(p["kv_down"], x)
    k_rope = cm.apply_rope(cm.apply_dense(p["k_rope"], x), positions,
                           cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_forward(p, x, cfg, *, positions, latent_out=None):
    """Prefill: the latent expanded to per-head K/V, causal attention in
    fp32. MLA ignores any window. latent_out: optional (ckv, krope) cache
    slices (B, max_len, r) and (B, max_len, rd) that receive the sequence's
    latent and rotated rope key."""
    m = cfg.mla
    q_nope, q_rope = _mla_query(p, x, positions, cfg)
    c_kv, k_rope = mla_latent(p, x, positions, cfg)
    if latent_out is not None:
        latent_out[0][:, :c_kv.shape[1]] = c_kv
        latent_out[1][:, :k_rope.shape[1]] = k_rope
    k_nope = cm.apply_dense(p["k_up"], c_kv)                       # (B,S,H,nd)
    v = cm.apply_dense(p["v_up"], c_kv)                            # (B,S,H,vd)
    b, s, h, _ = k_nope.shape
    q = torch.cat([q_nope, q_rope], dim=-1).float() * _mla_scale(m)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h,
                                                     m.qk_rope_head_dim)],
                  dim=-1).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(x.dtype)
    return cm.apply_dense(p["o"], o, in_dims=2)


def mla_decode(p, x, cache_ckv, cache_krope, pos, cfg):
    """Absorbed decode. x: (B,1,d); caches (B,S,r) and (B,S,rd), written in
    place at ``pos`` (0-dim or (B,)); keys at positions <= pos are valid.
    score[h, s] = (W_uk[h]^T q_nope[h]) . c_kv[s] + q_rope[h] . k_rope[s];
    the output (probs . c_kv) @ W_uv[h]. Returns the layer's output."""
    m = cfg.mla
    positions = pos.reshape(-1, 1).expand(x.shape[0], 1)
    q_nope, q_rope = _mla_query(p, x, positions, cfg)
    c_kv, k_rope = mla_latent(p, x, positions, cfg)
    write_kv(cache_ckv, c_kv, pos)
    write_kv(cache_krope, k_rope, pos)
    w_uk = p["k_up"]["w"].to(x.dtype)                              # (r,H,nd)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)       # (B,H,r)
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.float(), cache_ckv.float())
              + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                             cache_krope.float())) * _mla_scale(m)
    valid = (torch.arange(cache_ckv.shape[1], device=x.device)[None, :]
             <= pos.reshape(-1, 1))
    probs = torch.softmax(scores.masked_fill(~valid[:, None, :],
                                             float("-inf")), dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", probs.to(cache_ckv.dtype), cache_ckv)
    w_uv = p["v_up"]["w"].to(x.dtype)                              # (r,H,vd)
    o = torch.einsum("bhr,rhd->bhd", ctx.to(x.dtype), w_uv)[:, None]
    return cm.apply_dense(p["o"], o, in_dims=2)
