"""Plain PyTorch versions of the kernels: attention and row-wise cosine.

The attention versions follow the Hopper kernels (and the Pallas kernels
they replace), not ``repro.kernels.ref``, where the two differ:

* a row with no valid key gives 0, where ``repro.kernels.ref`` gives the
  mean of V (the Pallas kernels divide an empty accumulator by 1);
* a non-causal window masks one side only, ``q - k < window``, as the
  Pallas flash kernel does.

The CPU path of ``ops`` and the CPU tests run these; ``chip_smoke.py`` holds
each kernel against them on the card.
"""
from __future__ import annotations

import torch


def _masked_softmax(s, mask):
    """Masked softmax over the last axis; rows with no valid key give 0."""
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.where(l == 0, torch.ones_like(l), l)


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0, sk_valid=0,
                  scale=None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); query head h reads KV head
    h // (Hq // Hkv). Query row i sits at absolute position i + q_offset;
    keys at or beyond ``sk_valid`` (0 = all) are masked. Returns
    (B, Sq, Hq, D) in q's dtype."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = (q.float() * scale).reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = k_pos < (sk_valid or sk)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    p = _masked_softmax(s, mask)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, cache_len, *, window=0):
    """q: (B, 1, Hq, D); caches (B, S, Hkv, D); cache_len: int or (B,)
    count of valid cache entries. ``window > 0`` keeps only the last
    ``window`` of them (the model's sliding layers; the kernel has no
    window). Returns (B, 1, Hq, D) in q's dtype."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = (q.float() * d ** -0.5).reshape(b, hkv, g, d)
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    k_pos = torch.arange(s, device=q.device)[None, :]
    valid = k_pos < lens
    if window > 0:
        valid = valid & (k_pos >= lens - window)
    p = _masked_softmax(sc, valid[:, None, None, :])
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(b, 1, hq, d).to(q.dtype)


def rowwise_cosine_ref(a, b):
    """a: (M, D); b: (M, D), or (D,) for one row against every row of a.
    Returns (M,) float32: the dot product of each aligned pair of rows, in
    fp32 (the rows are L2-normalized, so it is their cosine)."""
    return (a.float() * b.float()).sum(dim=-1)
