"""Encoder-decoder LM of the port (the SeamlessM4T backbone). As in the
reference, the audio frontend is a stub: the encoder takes precomputed
frame embeddings (B, S_enc, d_model).

Every attention goes through ``kernels.ops``: the encoder's self-attention
is non-causal flash attention with rope, the decoder's causal; its
cross-attention reads the encoder's keys and values without rope, through
non-causal flash attention in prefill and training (S_dec queries against
S_enc keys) and through ``decode_attention`` over the whole encoder cache
in decode. A Python loop over layers replaces ``lax.scan``; the weights
keep the stacked ``layer`` axis (``enc_layers``, ``dec_layers``) and each
step takes its layer's views. ``remat`` recomputes the decoder's layers
only, as the reference's ``jax.checkpoint`` wraps the decoder's scan body
and not the encoder's.

Public surface (used by registry / launch):
  init(cfg, generator=, device=, requires_grad=)     -> param tree
  encode(params, cfg, enc_embeds)                    -> (B, S_enc, d)
  forward(params, cfg, tokens, enc_embeds, remat=)   -> logits (B, S, V) f32
  loss_fn(params, cfg, batch, remat=)                -> cross-entropy
  init_cache(cfg, batch, max_len, enc_len, dtype)    -> {"k", "v", "ek",
                                                         "ev", "pos"}
  prefill(params, cfg, tokens, enc_embeds, max_len=) -> (logits, cache)
  decode_step(params, cfg, cache, token)             -> (logits, cache
                                                         updated in place)
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ATTN_GQA, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.transformer import embed_inputs, requires_grad_


def check_supported(cfg: ModelConfig) -> None:
    if not (cfg.is_encoder_decoder and cfg.attn_type == ATTN_GQA
            and cfg.moe is None and cfg.ssm is None):
        raise NotImplementedError(
            f"{cfg.name}: models.encdec takes encoder-decoder configs with "
            f"GQA attention and a dense feed-forward")


def init(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
         device="cuda", dtype=torch.float32, requires_grad=False):
    """Seeded random weights, in the reference's layout; with
    ``requires_grad`` every leaf needs a gradient (training)."""
    check_supported(cfg)
    kw = dict(device=device, dtype=dtype)
    d = cfg.d_model

    def ffn(lead):
        return ffn_mod.swiglu_init(generator, d, cfg.d_ff, lead=lead, **kw)

    enc = (cfg.n_encoder_layers,)
    dec = (cfg.n_layers,)
    p = {"embed": cm.embedding(generator, cfg.vocab_size, d, **kw),
         "enc_in_proj": cm.dense(generator, d, d, **kw)}
    p["enc_layers"] = {
        "attn_norm": cm.rmsnorm_init(d, lead=enc, **kw),
        "attn": attn.gqa_init(generator, cfg, lead=enc, **kw),
        "ffn_norm": cm.rmsnorm_init(d, lead=enc, **kw),
        "ffn": ffn(enc)}
    p["enc_norm"] = cm.rmsnorm_init(d, **kw)
    p["dec_layers"] = {
        "self_norm": cm.rmsnorm_init(d, lead=dec, **kw),
        "self_attn": attn.gqa_init(generator, cfg, lead=dec, **kw),
        "cross_norm": cm.rmsnorm_init(d, lead=dec, **kw),
        "cross_attn": attn.gqa_init(generator, cfg, lead=dec, **kw),
        "ffn_norm": cm.rmsnorm_init(d, lead=dec, **kw),
        "ffn": ffn(dec)}
    p["final_norm"] = cm.rmsnorm_init(d, **kw)
    p["unembed"] = cm.dense(generator, d, cfg.vocab_size, **kw)
    return requires_grad_(p) if requires_grad else p


def encode(params, cfg, enc_embeds, *, dtype=torch.bfloat16):
    """enc_embeds (B, S_enc, d_model) -> the encoder's normed output in
    ``dtype``: non-causal self-attention with rope, then SwiGLU, per
    layer."""
    x = cm.apply_dense(params["enc_in_proj"], enc_embeds.to(dtype))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.n_encoder_layers):
        lp = cm.layer_params(params["enc_layers"], i)
        h = cm.rmsnorm(lp["attn_norm"], x, cfg.rms_eps)
        x = x + attn.gqa_forward(lp["attn"], h, cfg, positions=positions,
                                 causal=False)
        h = cm.rmsnorm(lp["ffn_norm"], x, cfg.rms_eps)
        x = x + ffn_mod.swiglu(lp["ffn"], h)
    return cm.rmsnorm(params["enc_norm"], x, cfg.rms_eps)


def _cross_attend(lp, h, enc_k, enc_v):
    """The decoder's queries (no rope on cross-attention) against the
    encoder's keys and values, every one visible."""
    q = cm.apply_dense(lp["q"], h)
    o = ops.flash_attention(q, enc_k, enc_v, causal=False)
    return cm.apply_dense(lp["o"], o, in_dims=2)


def _dec_block(lp, x, enc_out, cfg, positions, cache=None):
    """One decoder layer over the full sequence. ``cache``: this layer's
    slices of the decode cache, which receive its self-attention keys and
    values (``k``, ``v``) and the encoder's projected ones (``ek``,
    ``ev``) (prefill)."""
    h = cm.rmsnorm(lp["self_norm"], x, cfg.rms_eps)
    kv_out = None if cache is None else (cache["k"], cache["v"])
    x = x + attn.gqa_forward(lp["self_attn"], h, cfg, positions=positions,
                             kv_out=kv_out)
    h = cm.rmsnorm(lp["cross_norm"], x, cfg.rms_eps)
    ek = cm.apply_dense(lp["cross_attn"]["k"], enc_out)
    ev = cm.apply_dense(lp["cross_attn"]["v"], enc_out)
    if cache is not None:
        cache["ek"].copy_(ek)
        cache["ev"].copy_(ev)
    x = x + _cross_attend(lp["cross_attn"], h, ek, ev)
    h = cm.rmsnorm(lp["ffn_norm"], x, cfg.rms_eps)
    return x + ffn_mod.swiglu(lp["ffn"], h)


def forward(params, cfg, tokens, enc_embeds, *, dtype=torch.bfloat16,
            remat=False):
    """Training path. tokens: (B, S_dec); enc_embeds: (B, S_enc, d).
    Returns logits (B, S_dec, vocab) f32. ``remat`` recomputes each decoder
    layer in the backward (the encoder keeps its activations)."""
    enc_out = encode(params, cfg, enc_embeds, dtype=dtype)
    x = embed_inputs(params, cfg, tokens, dtype=dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.n_layers):
        args = (cm.layer_params(params["dec_layers"], i), x, enc_out, cfg,
                positions)
        x = (checkpoint(_dec_block, *args, use_reentrant=False) if remat
             else _dec_block(*args))
    x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return cm.apply_dense(params["unembed"], x).float()


def loss_fn(params, cfg, batch, *, dtype=torch.bfloat16, remat=True):
    """batch: {"tokens": (B, S_dec), "enc_embeds": (B, S_enc, d)}.
    Next-token cross-entropy, the last position masked."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens, batch["enc_embeds"], dtype=dtype,
                     remat=remat)
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)],
                     dim=1)
    return cm.softmax_cross_entropy(logits, labels, mask)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, enc_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Zeros: the decoder's self-attention "k", "v" (L, batch, max_len,
    Hkv, D), the encoder's projected "ek", "ev" (L, batch, enc_len, Hkv,
    D), and a 0-dim int32 "pos" (one position for every sequence: the
    reference's enc-dec cache has no per-slot positions)."""
    check_supported(cfg)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    c = {}
    for name, s in (("k", max_len), ("v", max_len), ("ek", enc_len),
                    ("ev", enc_len)):
        c[name] = torch.zeros((L, batch, s, kv, hd), dtype=dtype,
                              device=device)
    c["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return c


def prefill(params, cfg, tokens, enc_embeds, *, max_len=None,
            dtype=torch.bfloat16):
    """Encode, then run the decoder over ``tokens`` capturing the self and
    cross keys and values. Returns (logits of the last position (B, 1, V)
    f32, cache with pos = min(S_dec, max_len))."""
    enc_out = encode(params, cfg, enc_embeds, dtype=dtype)
    x = embed_inputs(params, cfg, tokens, dtype=dtype)
    b, seq = tokens.shape
    max_len = max_len or seq
    cache = init_cache(cfg, b, max_len, enc_out.shape[1], dtype,
                       device=x.device)
    positions = torch.arange(seq, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        x = _dec_block(cm.layer_params(params["dec_layers"], i), x, enc_out,
                       cfg, positions,
                       cache={k: v[i] for k, v in cache.items() if k != "pos"})
    x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    cache["pos"].fill_(min(seq, max_len))
    return cm.apply_dense(params["unembed"], x[:, -1:]).float(), cache


def decode_step(params, cfg, cache, token, *, dtype=torch.bfloat16):
    """token: (B, 1) int. Writes each sequence's new self-attention K/V
    into ``cache`` in place, attends to the whole encoder cache, and
    advances ``cache["pos"]`` by one. Returns (logits (B, 1, V) f32,
    cache)."""
    pos = cache["pos"]
    lens = pos + 1
    b, enc_len = token.shape[0], cache["ek"].shape[2]
    enc_lens = torch.full((b,), enc_len, dtype=torch.int32,
                          device=token.device)
    x = embed_inputs(params, cfg, token, dtype=dtype)
    for i in range(cfg.n_layers):
        lp = cm.layer_params(params["dec_layers"], i)
        h = cm.rmsnorm(lp["self_norm"], x, cfg.rms_eps)
        a, _, _ = attn.gqa_decode(lp["self_attn"], h, cache["k"][i],
                                  cache["v"][i], pos, cfg, cache_len=lens)
        x = x + a
        h = cm.rmsnorm(lp["cross_norm"], x, cfg.rms_eps)
        q = cm.apply_dense(lp["cross_attn"]["q"], h)
        o = ops.decode_attention(q, cache["ek"][i], cache["ev"][i], enc_lens)
        x = x + cm.apply_dense(lp["cross_attn"]["o"], o, in_dims=2)
        h = cm.rmsnorm(lp["ffn_norm"], x, cfg.rms_eps)
        x = x + ffn_mod.swiglu(lp["ffn"], h)
    x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    cache["pos"] = lens
    return cm.apply_dense(params["unembed"], x).float(), cache
