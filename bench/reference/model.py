"""A decoder-only LM in plain PyTorch, from the weights by name and the
configuration's dims (the HF keys of ``bench/configs/<config>.json``).

Each layer: RMSNorm, GQA attention (Q/K/V projections with an optional
bias, split-half RoPE, causal softmax attention scaled by head_dim^-0.5,
query head h reading KV head h // (heads / kv_heads), the output
projection), a residual; RMSNorm, a SwiGLU feed-forward or the MoE, a
residual. Then a final RMSNorm and the unembedding (tied: the embedding's
transpose). The MoE routes each token to its top-k experts by softmax
probability, renormalises their weights, and keeps an assignment only where
its place among its expert's assignments, in (token, k) order, is below the
capacity max(8, ceil8(int(T k / E * capacity_factor))); dropped assignments
add nothing.

``counts``: the architecture's counts (``bench/reference/__init__.py``).

Every product runs through ``mm`` in the precision asked for: ``fp32``
(exact fp32 products; TF32 is switched off), or with both operands
rounded first to ``tf32`` or ``fp8`` (one scale per operand:
e4m3, and in the backward the incoming gradient in e5m2, as fp8 training's
hybrid recipe has it): the controls that a lower precision fails the
comparison.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def round_tf32(x):
    """fp32 rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _round_scaled(x, dtype, top):
    x = x.float()
    if not x.numel():
        return x
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


def round_fp8(x):
    """e4m3, one scale for the tensor: the forward operands' fp8."""
    return _round_scaled(x, torch.float8_e4m3fn, 448.0)


def round_fp8_grad(x):
    """e5m2: the gradients' fp8 in the hybrid recipe of fp8 training
    (e4m3 forward, e5m2 for the gradients in the backward)."""
    return _round_scaled(x, torch.float8_e5m2, 57344.0)


ROUND = {"tf32": round_tf32, "fp8": round_fp8}
# the incoming gradient's rounding in the backward, where it differs
ROUND_GRAD = {"fp8": round_fp8_grad}


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        r = ROUND[prec]
        return r(a) @ r(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ROUND[ctx.prec]
        g = ROUND_GRAD.get(ctx.prec, r)(g)
        ga = g @ r(b).transpose(-1, -2)
        gb = r(a).transpose(-1, -2) @ g
        return ga, gb, None


def mm(a, b, prec):
    """a (..., m, k) @ b (..., k, n), batch dims equal."""
    if prec == "fp32":
        return a @ b
    return _RoundedMatmul.apply(a, b, prec)


def linear(x, w, prec, b=None):
    """x (..., d_in) by w (d_in, ...): the output's trailing dims are w's."""
    d_in = w.shape[0]
    y = mm(x.reshape(-1, d_in), w.reshape(d_in, -1), prec)
    y = y.reshape(x.shape[:-1] + w.shape[1:])
    return y if b is None else y + b


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, positions, theta):
    """x (B, S, H, D); split-half rotation."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                         dtype=torch.float32) / d)
    ang = positions[:, None].float() * freqs                   # (S, D/2)
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec, block=1024):
    """Causal attention of q (B, S, H, D) over k, v (B, S, Hkv, D), query
    rows in blocks of ``block``."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    k = k.repeat_interleave(group, dim=2).transpose(1, 2)        # (B,H,S,D)
    v = v.repeat_interleave(group, dim=2).transpose(1, 2)
    q = q.transpose(1, 2) * d ** -0.5
    outs = []
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        scores = mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2), prec)
        mask = (torch.arange(hi, device=q.device)[None, :]
                <= torch.arange(lo, hi, device=q.device)[:, None])
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(mm(p, v[:, :, :hi], prec))
    return torch.cat(outs, dim=2).transpose(1, 2)               # (B,S,H,D)


def swiglu(x, gate, up, down, prec):
    return linear(F.silu(linear(x, gate, prec)) * linear(x, up, prec), down,
                  prec)


def capacity(n_tokens, cfg):
    c = int(n_tokens * cfg["num_experts_per_tok"] / cfg["num_local_experts"]
            * cfg["capacity_factor"])
    return max(8, -(-c // 8) * 8)


def moe(lw, x, cfg, prec):
    """x (B, S, d): every row routes, pads included."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    k, n_exp = cfg["num_experts_per_tok"], cfg["num_local_experts"]
    probs = torch.softmax(linear(x2, lw["ffn/router/w"], prec).float(), -1)
    w, experts = torch.topk(probs, k, dim=-1)
    w = (w / w.sum(-1, keepdim=True).clamp_min(1e-9)).reshape(-1)
    flat = experts.reshape(-1)
    cap = capacity(b * s, cfg)
    y = torch.zeros_like(x2)
    for e in range(n_exp):
        idx = torch.nonzero(flat == e).squeeze(1)[:cap]
        tok = idx // k
        out = swiglu(x2[tok], lw["ffn/gate/w"][e], lw["ffn/up/w"][e],
                     lw["ffn/down/w"][e], prec) * w[idx, None]
        y = y.index_add(0, tok, out)
    return y.reshape(b, s, d)


def block(lw, x, cfg, prec):
    eps = cfg["rms_norm_eps"]
    h = rmsnorm(x, lw["attn_norm/scale"], eps)
    pos = torch.arange(x.shape[1], device=x.device)
    qkv = [linear(h, lw[f"attn/{n}/w"], prec, lw.get(f"attn/{n}/b"))
           for n in "qkv"]
    q = rope(qkv[0], pos, cfg["rope_theta"])
    kk = rope(qkv[1], pos, cfg["rope_theta"])
    a = attention(q, kk, qkv[2], prec)
    x = x + linear(a.reshape(a.shape[:2] + (-1,)),
                   lw["attn/o/w"].reshape(-1, x.shape[-1]), prec)
    h = rmsnorm(x, lw["ffn_norm/scale"], eps)
    if "num_local_experts" in cfg:
        return x + moe(lw, h, cfg, prec)
    return x + swiglu(h, lw["ffn/gate/w"], lw["ffn/up/w"],
                      lw["ffn/down/w"], prec)


def layer_weights(w, i):
    return {p[len("layers/"):]: t[i] for p, t in w.items()
            if p.startswith("layers/")}


def forward(w, cfg, tokens, prec="fp32", remat=False):
    """Logits (B, S, V) fp32 of tokens (B, S)."""
    x = w["embed/embedding"][tokens].float()
    for i in range(cfg["num_hidden_layers"]):
        lw = layer_weights(w, i)
        x = (checkpoint(block, lw, x, cfg, prec, use_reentrant=False)
             if remat else block(lw, x, cfg, prec))
    x = rmsnorm(x, w["final_norm/scale"], cfg["rms_norm_eps"])
    unembed = (w["embed/embedding"].T if cfg["tie_word_embeddings"]
               else w["unembed/w"])
    return linear(x, unembed, prec)


def loss(w, cfg, tokens, prec="fp32", remat=True):
    """Mean next-token cross-entropy over all positions but the last."""
    logits = forward(w, cfg, tokens, prec, remat)[:, :-1]
    labels = tokens[:, 1:]
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None])[..., 0]
    return nll.mean()


def dims(cfg):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return d, h, cfg["num_key_value_heads"], cfg.get("head_dim") or d // h


def layer_matmul_params(cfg) -> int:
    """One layer's parameters that a token meets in products: the
    projections, and the feed-forward (a MoE's router and top-k experts)."""
    d, h, kv, hd = dims(cfg)
    attn = d * hd * (2 * h + 2 * kv)
    if "num_local_experts" in cfg:
        ffn = (d * cfg["num_local_experts"]
               + cfg["num_experts_per_tok"] * 3 * d * cfg["intermediate_size"])
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return attn + ffn


def params(cfg) -> int:
    """The configuration's parameters: the embedding (counted once where
    tied to the unembedding), per layer the projections with their biases,
    the two norms' scales and the feed-forward (a MoE's router and every
    expert), and the final norm's scale."""
    d, h, kv, hd = dims(cfg)
    attn = d * hd * (2 * h + 2 * kv)
    if cfg.get("attention_bias"):
        attn += hd * (h + 2 * kv)
    if "num_local_experts" in cfg:
        e = cfg["num_local_experts"]
        ffn = d * e + e * 3 * d * cfg["intermediate_size"]
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    embed = cfg["vocab_size"] * d * (1 if cfg.get("tie_word_embeddings")
                                     else 2)
    return cfg["num_hidden_layers"] * (attn + ffn + 2 * d) + embed + d


def counts(cfg) -> dict:
    """Every layer is GQA attention and a SwiGLU or MoE feed-forward."""
    _, h, kv, hd = dims(cfg)
    layers = cfg["num_hidden_layers"]
    return {"matmul_params": layers * layer_matmul_params(cfg),
            "params": params(cfg), "attn_layers": layers, "heads": h,
            "kv_heads": kv, "qk_head_dim": hd, "v_head_dim": hd,
            "mixer_flops": 0}
