"""Plain PyTorch versions of the kernels: attention, the SSD scan's
sequential recurrence and cosine similarity.

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


def _scores(q, k, causal, window, q_offset, sk_valid, scale):
    """fp32 scaled scores (B, Hkv, g, Sq, Sk) and their mask (Sq, Sk)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = (q.float() * scale).reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = k_pos < (sk_valid or sk)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    return s, mask


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0, sk_valid=0,
                  scale=None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); query head h reads KV head
    h // (Hq // Hkv). Query row i sits at absolute position i + q_offset;
    keys at or beyond ``sk_valid`` (0 = all) are masked. Returns
    (B, Sq, Hq, D) in q's dtype."""
    b, sq, hq, d = q.shape
    s, mask = _scores(q, k, causal, window, q_offset, sk_valid, scale)
    p = _masked_softmax(s, mask)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def attention_lse_ref(q, k, *, causal=True, window=0, q_offset=0,
                      sk_valid=0, scale=None):
    """Each query row's log-sum-exp of its visible scaled scores, the
    flash forward's second output: (B, Hq, Sq) fp32, -inf for a row with
    no valid key."""
    b, sq, hq, _ = q.shape
    s, mask = _scores(q, k, causal, window, q_offset, sk_valid, scale)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    return lse.reshape(b, hq, sq)


def decode_attention_ref(q, k_cache, v_cache, cache_len, *, window=0):
    """q: (B, 1, Hq, D); caches (B, S, Hkv, D); cache_len: int or (B,)
    count of valid cache entries. ``window > 0`` keeps only the last
    ``window`` of them (the model's sliding layers). Returns (B, 1, Hq, D)
    in q's dtype."""
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


def ssd_ref(dx, dA, B, C, initial_state=None):
    """Naive sequential SSD recurrence, the test oracle of the chunked scan:
    fp32 state, or fp64 throughout when dx is fp64. dx: (B, S, H, P)
    inputs pre-scaled by dt; dA: (B, S, H) log-decay per step; B/C:
    (B, S, G, N), head h reads group h // (H // G). Returns (y (B, S, H, P)
    in dx's dtype, final state (B, H, N, P) fp32 or fp64)."""
    b, s, h, p = dx.shape
    rep = h // B.shape[2]
    acc = torch.promote_types(dx.dtype, torch.float32)
    Bh = B.to(acc).repeat_interleave(rep, dim=2)            # (B, S, H, N)
    Ch = C.to(acc).repeat_interleave(rep, dim=2)
    dxf, dAf = dx.to(acc), dA.to(acc)
    state = (torch.zeros((b, h, B.shape[3], p), dtype=acc, device=dx.device)
             if initial_state is None else initial_state.to(acc))
    ys = []
    for t in range(s):
        upd = torch.einsum("bhn,bhp->bhnp", Bh[:, t], dxf[:, t])
        state = state * torch.exp(dAf[:, t])[:, :, None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros_like(dxf))
    return y.to(dx.dtype), state


def cosine_matrix_ref(a, b):
    """a: (M, D), b: (N, D), rows L2-normalized. Returns (M, N) float32:
    every pair's dot product, in fp32."""
    return a.float() @ b.float().T
