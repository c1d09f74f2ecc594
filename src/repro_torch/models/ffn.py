"""Feed-forward mixers: SwiGLU and the MoE's gather path.

The MoE is ``repro.models.ffn.moe_forward_gather``: sort-based dispatch of
each token's top-k experts into an (E, C, d) buffer, the experts' SwiGLU as
batched products, and a weighted combine; an optional shared expert adds a
dense SwiGLU. The reference computes it in jnp outside any Pallas kernel,
so the port keeps it in plain PyTorch. Every detail that decides which
assignment is dropped follows the reference: softmax in fp32, top-k,
renormalised weights; a stable sort of the flat expert ids; the capacity
rule; assignments past it go to a dropped column; a zero pad row ``t``. ``moe_forward_shardmap`` (experts sharded over a mesh, one psum) is
not ported: it comes with the mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def swiglu_init(generator, d_model, d_ff, *, lead=(), device="cuda",
                dtype=torch.float32):
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {
        "gate": cm.dense(generator, d_model, d_ff, **kw),
        "up": cm.dense(generator, d_model, d_ff, **kw),
        "down": cm.dense(generator, d_ff, d_model, **kw),
    }


def swiglu(p, x):
    g = cm.apply_dense(p["gate"], x)
    u = cm.apply_dense(p["up"], x)
    return cm.apply_dense(p["down"], F.silu(g) * u)


def moe_init(generator, cfg, *, lead=(), device="cuda", dtype=torch.float32):
    """Router (d, E), the experts' gate, up (E, d, ff) and down (E, ff, d),
    each expert's weights scaled by its fan-in; with ``shared_expert_ff``
    a dense SwiGLU beside them."""
    moe = cfg.moe
    d, ff, e = cfg.d_model, cfg.d_ff, moe.num_experts
    kw = dict(device=device, dtype=dtype)
    experts = tuple(lead) + (e,)
    p = {
        "router": cm.dense(generator, d, e, lead=lead, **kw),
        "gate": cm.dense(generator, d, ff, lead=experts, **kw),
        "up": cm.dense(generator, d, ff, lead=experts, **kw),
        "down": cm.dense(generator, ff, d, lead=experts, **kw),
    }
    if moe.shared_expert_ff:
        p["shared"] = swiglu_init(generator, d, moe.shared_expert_ff,
                                  lead=lead, **kw)
    return p


def route(router_p, x2d, moe):
    """x2d (T, d) -> (weights (T, k) fp32, experts (T, k))."""
    logits = cm.apply_dense(router_p, x2d).float()                 # (T, E)
    weights, experts = torch.topk(torch.softmax(logits, dim=-1), moe.top_k,
                                  dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return weights, experts


def capacity(n_tokens, moe):
    """Slots per expert: top_k / E of the tokens times the capacity factor,
    rounded up to a multiple of 8, at least 8."""
    c = int(n_tokens * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(8, -(-c // 8) * 8)


def dispatch(experts, cap, num_experts, n_tokens):
    """The slots of a dispatch: (slot_tok (E, cap), sorted_e, dest, order).
    Flat assignment ``order[i]`` (token ``order[i] // k``) goes to slot
    ``dest[i]`` of expert ``sorted_e[i]``: its place in its expert's block
    in a stable sort by expert id, so within an expert the lower token
    comes first, and ``cap`` (a column cut off, so dropped) for those past
    the capacity. Empty slots hold the pad row ``n_tokens``."""
    k = experts.shape[1]
    n = n_tokens * k
    flat_e = experts.reshape(n)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # bincount would wait for the device to size its output
    counts = flat_e.new_zeros(num_experts).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=experts.device) - starts[sorted_e]
    keep = pos < cap
    # overflow goes to column ``cap``, which is cut off below
    dest = torch.where(keep, pos, torch.full_like(pos, cap))
    slot_tok = torch.full((num_experts, cap + 1), n_tokens, dtype=torch.long,
                          device=experts.device)
    slot_tok[sorted_e, dest] = order // k
    return slot_tok[:, :cap], sorted_e, dest, order


def dispatch_compute_combine(p, x2d, weights, experts, cap, moe):
    """Sort-based dispatch -> the experts' SwiGLU -> weighted combine.
    x2d (T, d); weights / experts (T, k). Returns (T, d)."""
    t, d = x2d.shape
    e = moe.num_experts
    slot_tok, sorted_e, dest, order = dispatch(experts, cap, e, t)
    slot_w = torch.zeros((e, cap + 1), dtype=weights.dtype,
                         device=weights.device)
    slot_w[sorted_e, dest] = weights.reshape(-1)[order]
    slot_w = slot_w[:, :cap]

    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
    xs = x_pad[slot_tok]                                           # (E, C, d)
    wg, wu, wd = (p[n]["w"].to(xs.dtype) for n in ("gate", "up", "down"))
    h = F.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wu)              # (E, C, ff)
    out = torch.bmm(h, wd) * slot_w[..., None].to(xs.dtype)       # (E, C, d)
    # the pad row t takes the empty slots' (zero) outputs and is dropped
    y = x2d.new_zeros((t + 1, d)).index_add_(0, slot_tok.reshape(-1),
                                             out.reshape(-1, d))
    return y[:t]


def moe_forward_gather(p, x, cfg):
    """x: (B, S, d). Every row of x routes, pads included: they raise the
    token count and so the capacity, and sort after the real tokens of
    their batch row in each expert's block."""
    moe = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    weights, experts = route(p["router"], x2d, moe)
    y = dispatch_compute_combine(p, x2d, weights, experts,
                                 capacity(b * s, moe), moe)
    if "shared" in p:
        y = y + swiglu(p["shared"], x2d)
    return y.reshape(b, s, d)
