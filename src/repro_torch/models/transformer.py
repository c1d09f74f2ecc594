"""Decoder-only LM of the port: the dense GQA family (at head_dim 64 and
128), the VLM family (dense GQA after a projected prefix of precomputed
patch embeddings), the MoE family (GQA attention, the MoE's gather path),
MLA (MiniCPM3's latent attention), the attention-free SSM family (Mamba2)
and the hybrid family (Hymba: GQA attention and a Mamba2 mixer side by side
in every layer). A GQA cache may be int8 (``init_cache(kv_dtype=
torch.int8)``); MLA and SSM caches ignore ``kv_dtype``, as the reference's
do.

A Python loop over layers replaces ``lax.scan``; weights keep the stacked
``layer`` axis and each step takes its layer's views. Encoder-decoder
models are ``models.encdec``. Still refused (``NotImplementedError``): a
hybrid without attention. ``moe_ctx={"impl": "shardmap", "mesh": mesh,
"dp_axes": ...}`` runs the MoE through ``ffn.moe_forward_shardmap`` on a
``DeviceMesh``, as the reference's does through ``shard_map``; without it
the MoE is the gather path, split over the ranks where the layer runs
split (DTensor activations) or a gather ``moe_ctx`` names a mesh
(``ffn.moe_forward``). ``prefill`` and ``decode_step`` take ``moe_ctx``
too (the reference's serve the gather path alone).

Public surface (used by registry / launch / engine):
  init(cfg, generator=, device=,
       requires_grad=)                    -> param tree
  param_axes(cfg)                         -> its logical axes
  forward(params, cfg, tokens, remat=)    -> logits (B, S, V) fp32
  loss_fn(params, cfg, batch, remat=)     -> next-token cross-entropy
  init_cache(cfg, batch, max_len, dtype)  -> {"k", "v"} (GQA; int8 adds
                                             "k_scale", "v_scale"),
                                             {"ckv", "krope"} (MLA),
                                             {"ssm_state", "conv_buf"} (SSM),
                                             GQA's and SSM's (hybrid), and
                                             "pos"
  cache_axes(cfg, per_slot_pos, kv_dtype) -> the cache's logical axes
  prefill(params, cfg, tokens, max_len=)  -> (last-position logits, cache)
  decode_step(params, cfg, cache, token)  -> (logits, cache updated in place)
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import (ATTN_GQA, ATTN_MLA, ATTN_NONE,
                                 FAMILY_DENSE, FAMILY_HYBRID, FAMILY_MOE,
                                 FAMILY_SSM, FAMILY_VLM, ModelConfig)
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.trace import span


def check_supported(cfg: ModelConfig) -> None:
    attn = cfg.attn_type in (ATTN_GQA, ATTN_MLA) and cfg.ssm is None
    # a VLM is a dense decoder after its projected prefix
    dense = (attn and cfg.family in (FAMILY_DENSE, FAMILY_VLM)
             and cfg.moe is None)
    moe = attn and cfg.family == FAMILY_MOE and cfg.moe is not None
    ssm = (cfg.family == FAMILY_SSM and cfg.attn_type == ATTN_NONE
           and cfg.ssm is not None and cfg.moe is None)
    hybrid = (cfg.family == FAMILY_HYBRID and cfg.attn_type == ATTN_GQA
              and cfg.ssm is not None and cfg.moe is None)
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder config is models.encdec's "
            f"(registry.build routes it there)")
    if (not (dense or moe or ssm or hybrid)
            or (cfg.attn_type == ATTN_MLA) != (cfg.mla is not None)):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense, VLM and MoE families "
            f"with GQA or MLA attention, the SSM (Mamba2) family and the "
            f"GQA + SSM hybrid (Hymba)")


def init(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
         device="cuda", dtype=torch.float32, requires_grad=False):
    """Seeded random weights. With ``requires_grad`` every leaf is a leaf
    tensor that autograd gives a ``.grad`` (training); serving keeps the
    default."""
    check_supported(cfg)
    kw = dict(device=device, dtype=dtype)
    lead = (cfg.n_layers,)
    layers = {}
    if cfg.attn_type == ATTN_GQA:
        layers["attn_norm"] = cm.rmsnorm_init(cfg.d_model, lead=lead, **kw)
        layers["attn"] = attn.gqa_init(generator, cfg, lead=lead, **kw)
    elif cfg.attn_type == ATTN_MLA:
        layers["attn_norm"] = cm.rmsnorm_init(cfg.d_model, lead=lead, **kw)
        layers["attn"] = attn.mla_init(generator, cfg, lead=lead, **kw)
    if cfg.ssm is not None and cfg.family == FAMILY_HYBRID:
        # the SSM reads the attention's normed input; each mixer's output
        # has its own norm before the two are averaged
        layers["ssm"] = ssm_mod.mamba2_init(generator, cfg, lead=lead, **kw)
        layers["attn_out_norm"] = cm.rmsnorm_init(cfg.d_model, lead=lead,
                                                  **kw)
        layers["ssm_out_norm"] = cm.rmsnorm_init(cfg.d_model, lead=lead,
                                                 **kw)
    elif cfg.ssm is not None:
        layers["ssm_norm"] = cm.rmsnorm_init(cfg.d_model, lead=lead, **kw)
        layers["ssm"] = ssm_mod.mamba2_init(generator, cfg, lead=lead, **kw)
    if cfg.d_ff > 0:
        layers["ffn_norm"] = cm.rmsnorm_init(cfg.d_model, lead=lead, **kw)
        layers["ffn"] = (
            ffn_mod.moe_init(generator, cfg, lead=lead, **kw) if cfg.moe
            else ffn_mod.swiglu_init(generator, cfg.d_model, cfg.d_ff,
                                     lead=lead, **kw))
    p = {
        "embed": cm.embedding(generator, cfg.vocab_size, cfg.d_model, **kw),
        "layers": layers,
        "final_norm": cm.rmsnorm_init(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = cm.dense(generator, cfg.d_model, cfg.vocab_size, **kw)
    if cfg.n_prefix_embeds:
        # projection of the precomputed modality embeddings (frontend stub)
        p["prefix_proj"] = cm.dense(generator, cfg.d_model, cfg.d_model, **kw)
    return requires_grad_(p) if requires_grad else p


def param_axes(cfg: ModelConfig):
    """``init``'s tree of logical axes (the reference's ``Param.axes``)."""
    check_supported(cfg)
    layers = {}
    if cfg.attn_type in (ATTN_GQA, ATTN_MLA):
        layers["attn_norm"] = cm.rmsnorm_axes()
        layers["attn"] = (attn.gqa_axes(cfg) if cfg.attn_type == ATTN_GQA
                          else attn.mla_axes(cfg))
    if cfg.ssm is not None and cfg.family == FAMILY_HYBRID:
        layers["ssm"] = ssm_mod.mamba2_axes(cfg)
        layers["attn_out_norm"] = cm.rmsnorm_axes()
        layers["ssm_out_norm"] = cm.rmsnorm_axes()
    elif cfg.ssm is not None:
        layers["ssm_norm"] = cm.rmsnorm_axes()
        layers["ssm"] = ssm_mod.mamba2_axes(cfg)
    if cfg.d_ff > 0:
        layers["ffn_norm"] = cm.rmsnorm_axes()
        layers["ffn"] = (ffn_mod.moe_axes(cfg) if cfg.moe
                         else ffn_mod.swiglu_axes())
    p = {"embed": cm.embedding_axes(), "layers": cm.stack_axes(layers),
         "final_norm": cm.rmsnorm_axes()}
    if not cfg.tie_embeddings:
        p["unembed"] = cm.dense_axes(("embed", "vocab"))
    if cfg.n_prefix_embeds:
        p["prefix_proj"] = cm.dense_axes(("embed", "embed2"))
    return p


def requires_grad_(tree):
    """Mark every leaf of a param tree as needing a gradient, in place."""
    for v in tree.values():
        if isinstance(v, dict):
            requires_grad_(v)
        else:
            v.requires_grad_(True)
    return tree


def layer_windows(cfg: ModelConfig):
    """Per-layer sliding window (0 = full attention), or None."""
    if cfg.sliding_window <= 0:
        return None
    return [0 if i in cfg.full_attn_layers else cfg.sliding_window
            for i in range(cfg.n_layers)]


def _mix(lp, a, s, cfg):
    """The hybrid block's output: the attention's and the SSM's outputs,
    each RMS-normed, averaged."""
    return 0.5 * (cm.rmsnorm(lp["attn_out_norm"], a, cfg.rms_eps)
                  + cm.rmsnorm(lp["ssm_out_norm"], s, cfg.rms_eps))


def _ssm_forward(p, h, cfg, cache):
    """The Mamba2 mixer over the sequence; with ``cache`` its final state
    and conv tail go into the layer's cache slices."""
    s, (state, buf) = ssm_mod.mamba2_forward(p, h, cfg)
    if cache is not None:
        shd.assign(cache["ssm_state"], state)
        shd.assign(cache["conv_buf"], buf)
    return s


def _ffn(lp, h, cfg, moe_ctx=None):
    if cfg.moe is None:
        return ffn_mod.swiglu(lp["ffn"], h)
    return ffn_mod.moe_forward(lp["ffn"], h, cfg, moe_ctx)


def _block_forward(lp, x, cfg, window, positions, cache=None, moe_ctx=None):
    """One layer over the full sequence. ``cache``: this layer's slices of
    the decode cache (``k``/``v`` (B, max_len, Hkv, D) or MLA's ``ckv``/
    ``krope``; ``ssm_state``, ``conv_buf``), which receive its keys and
    values, or its latent, and/or its final SSM state and conv tail
    (prefill). A hybrid layer runs attention and the SSM on the same
    normed input. ``moe_ctx``: the MoE's implementation, as the
    reference's. ``x`` is placed by the reference's constraint first (the
    identity outside ``activation_sharding``)."""
    x = shd.constrain(x, ("batch", "seq", "embed_act"))
    if "attn" in lp:
        with span("model.attn"):
            h = cm.rmsnorm(lp["attn_norm"], x, cfg.rms_eps)
            if cfg.attn_type == ATTN_MLA:
                latent = None if cache is None else (cache["ckv"],
                                                     cache["krope"])
                a = attn.mla_forward(lp["attn"], h, cfg,
                                     positions=positions, latent_out=latent)
            else:
                kv_out = None if cache is None else (cache["k"], cache["v"])
                a = attn.gqa_forward(lp["attn"], h, cfg, positions=positions,
                                     window=window, kv_out=kv_out)
            if "ssm" in lp:
                a = _mix(lp, a, _ssm_forward(lp["ssm"], h, cfg, cache), cfg)
            x = x + a
    elif "ssm" in lp:
        with span("model.ssm"):
            h = cm.rmsnorm(lp["ssm_norm"], x, cfg.rms_eps)
            x = x + _ssm_forward(lp["ssm"], h, cfg, cache)
    if "ffn" in lp:
        with span("model.ffn"):
            h = cm.rmsnorm(lp["ffn_norm"], x, cfg.rms_eps)
            x = x + _ffn(lp, h, cfg, moe_ctx)
    return x


def embed_inputs(params, cfg, tokens, prefix_embeds=None,
                 dtype=torch.bfloat16):
    """The tokens' embedding rows in ``dtype``, after the projected
    ``prefix_embeds`` (B, n_prefix, d_model) where the config has a prefix
    (as in the reference, a config without one ignores them).
    ``F.embedding`` gathers the rows as indexing does; its gradient on the
    card sums repeated tokens' rows in a fixed order (no atomics), which
    restart determinism needs."""
    x = shd.embedding(tokens, params["embed"]["embedding"]).to(dtype)
    # a vocab-split table's rows arrive as pending sums: placed here
    x = shd.constrain(x, ("batch", "seq", "embed_act"))
    if cfg.n_prefix_embeds and prefix_embeds is not None:
        pfx = cm.apply_dense(params["prefix_proj"], prefix_embeds.to(dtype))
        x = torch.cat([pfx, x], dim=1)
    return x


def unembed(params, cfg, x):
    if cfg.tie_embeddings:
        emb = params["embed"]["embedding"].to(x.dtype)
        logits = shd.contract(x, emb.T).float()
    else:
        logits = cm.apply_dense(params["unembed"], x).float()
    return shd.constrain(logits, ("batch", "seq", "vocab"))


def forward(params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
            dtype=torch.bfloat16, remat=False, moe_ctx=None):
    """tokens: (B, S_text) int; prefix_embeds: optional (B, n_prefix,
    d_model). Returns logits (B, S_total, vocab) f32. ``remat``
    recomputes each layer's activations in the backward instead of keeping
    them (the reference's ``jax.checkpoint`` with ``nothing_saveable``):
    autograd keeps each layer's input only, and the backward runs the
    layer's forward once more, attention kernel included (it stops at the
    layer's last saved tensor, so not at the all-reduce that ends a MoE
    on a mesh). ``moe_ctx``: the MoE's path (``ffn.moe_forward``):
    {"impl": "shardmap", "mesh", "dp_axes"} for the shard_map path; the
    gather path otherwise."""
    with span("model.embed"):
        x = embed_inputs(params, cfg, tokens, prefix_embeds, dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    windows = layer_windows(cfg)
    for i in range(cfg.n_layers):
        args = (cm.layer_params(params["layers"], i), x, cfg,
                windows[i] if windows else 0, positions, None, moe_ctx)
        x = (checkpoint(_block_forward, *args, use_reentrant=False,
                        context_fn=shd.checkpoint_contexts) if remat
             else _block_forward(*args))
    with span("model.head"):
        x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
        return unembed(params, cfg, x)


def loss_fn(params, cfg: ModelConfig, batch, *, dtype=torch.bfloat16,
            remat=True, moe_ctx=None):
    """batch: {"tokens": (B, S)} (+ "prefix_embeds"). Next-token
    cross-entropy over the text: the prefix's logits are dropped, the labels
    are the tokens shifted left with a 0 in the last place, which the mask
    leaves out. Other keys (``enc_embeds``) are ignored, as the reference
    ignores them."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens,
                     prefix_embeds=batch.get("prefix_embeds"), dtype=dtype,
                     remat=remat, moe_ctx=moe_ctx)
    npfx = logits.shape[1] - tokens.shape[1]
    if npfx:
        logits = logits[:, npfx:]
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)],
                     dim=1)
    return cm.softmax_cross_entropy(logits, labels, mask)


def cache_axes(cfg: ModelConfig, per_slot_pos: bool = False,
               kv_dtype=None):
    """``init_cache``'s tree of logical axes (the reference's)."""
    check_supported(cfg)
    c = {}
    if cfg.attn_type == ATTN_GQA:
        kv = ("layer", "batch", "kv_seq", "kv_heads", "head_dim")
        c["k"] = c["v"] = kv
        if kv_dtype == torch.int8:
            c["k_scale"] = c["v_scale"] = kv[:-1]
    elif cfg.attn_type == ATTN_MLA:
        c["ckv"] = ("layer", "batch", "kv_seq", "kv_lora")
        c["krope"] = ("layer", "batch", "kv_seq", "head_dim")
    if cfg.ssm is not None:
        c["ssm_state"] = ("layer", "batch", "ssm_heads", "ssm_state",
                          "head_dim")
        c["conv_buf"] = ("layer", "batch", "conv", "ssm_conv_ch")
    c["pos"] = ("batch",) if per_slot_pos else ()
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, per_slot_pos: bool = False,
               kv_dtype=None, device="cuda"):
    """Zeros. GQA: "k", "v" (L, batch, max_len, Hkv, D); with ``kv_dtype=
    torch.int8`` they are int8 and "k_scale", "v_scale" (L, batch, max_len,
    Hkv) bf16 hold each row's scale (any other ``kv_dtype``, and any for
    MLA and SSM caches, is ignored, as in the reference). MLA: "ckv"
    (L, batch, max_len, kv_lora_rank), "krope" (L, batch, max_len,
    qk_rope_head_dim). SSM: "ssm_state"
    (L, batch, H, N, P) fp32 and "conv_buf" (L, batch, W-1, conv_ch) in
    ``dtype``. Hybrid: all four. Dim 1 of every leaf but "pos" is the batch
    (slot) axis.
    "pos": a (batch,) int32 vector with per_slot_pos (every slot at its own
    depth, for continuous batching), else a 0-dim one."""
    check_supported(cfg)
    L = cfg.n_layers
    c = {}
    if cfg.attn_type == ATTN_GQA:
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        kv = torch.int8 if kv_dtype == torch.int8 else dtype
        c["k"] = torch.zeros(shape, dtype=kv, device=device)
        c["v"] = torch.zeros(shape, dtype=kv, device=device)
        if kv_dtype == torch.int8:
            for name in ("k_scale", "v_scale"):
                c[name] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                      device=device)
    elif cfg.attn_type == ATTN_MLA:
        m = cfg.mla
        for name, width in (("ckv", m.kv_lora_rank),
                            ("krope", m.qk_rope_head_dim)):
            c[name] = torch.zeros((L, batch, max_len, width), dtype=dtype,
                                  device=device)
    if cfg.ssm is not None:
        _, nh, conv_ch = ssm_mod.dims(cfg)
        s = cfg.ssm
        c["ssm_state"] = torch.zeros((L, batch, nh, s.d_state, s.head_dim),
                                     dtype=torch.float32, device=device)
        c["conv_buf"] = torch.zeros((L, batch, s.conv_width - 1, conv_ch),
                                    dtype=dtype, device=device)
    pos_shape = (batch,) if per_slot_pos else ()
    c["pos"] = torch.zeros(pos_shape, dtype=torch.int32, device=device)
    return c


def prefill(params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
            max_len: Optional[int] = None, dtype=torch.bfloat16,
            moe_ctx=None):
    """Full-sequence forward that also builds the decode cache. Returns
    (logits of the last position (B, 1, V) f32, cache). With a prefix,
    ``pos`` is min(S_total + n_prefix, max_len), S_total counting the
    prefix already: the reference adds the prefix twice, and the port
    keeps that (decode then writes past zero rows, which it attends). Where
    that reaches max_len, the next ``decode_step`` fails on its write, which
    the reference drops: give max_len >= S_total + n_prefix + new tokens.
    ``moe_ctx``: the MoE's path, as ``forward``'s."""
    with span("model.embed"):
        x = embed_inputs(params, cfg, tokens, prefix_embeds, dtype)
    b, seq = x.shape[0], x.shape[1]
    max_len = max_len or seq
    cache = shd.zeros_tree(init_cache(cfg, b, max_len, dtype,
                                      device="meta"), cache_axes(cfg),
                           x.device)
    positions = torch.arange(seq, device=x.device)[None, :]
    windows = layer_windows(cfg)
    for i in range(cfg.n_layers):
        x = _block_forward(cm.layer_params(params["layers"], i), x, cfg,
                           windows[i] if windows else 0, positions,
                           cache={k: v[i] for k, v in cache.items()
                                  if k != "pos"}, moe_ctx=moe_ctx)
    total = seq + (cfg.n_prefix_embeds if prefix_embeds is not None else 0)
    cache["pos"].fill_(min(total, max_len))
    with span("model.head"):
        x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
        return unembed(params, cfg, x[:, -1:]), cache


def _ssm_decode(p, h, cache, i, cfg):
    """One recurrent step of layer ``i``'s Mamba2 mixer; its new state and
    conv tail are written into the cache."""
    s, state, buf = ssm_mod.mamba2_decode(p, h, cache["ssm_state"][i],
                                          cache["conv_buf"][i], cfg)
    shd.assign(cache["ssm_state"][i], state)
    shd.assign(cache["conv_buf"][i], buf)
    return s


def decode_step(params, cfg: ModelConfig, cache, token, *,
                dtype=torch.bfloat16, moe_ctx=None):
    """token: (B, 1) int. Writes each slot's new K/V (int8 cache: quantized,
    with its scales; MLA: its latent and rope key) and/or its new SSM state
    and conv tail into ``cache`` in place and advances ``cache["pos"]`` by
    one; a sliding layer attends to the last ``window`` entries only.
    ``moe_ctx``: the MoE's path, as ``forward``'s. Returns (logits
    (B,1,V) f32, cache)."""
    pos = cache["pos"]
    lens = pos + 1  # valid entries after this tick's write, for every layer
    with span("model.embed"):
        x = shd.embedding(token, params["embed"]["embedding"]).to(dtype)
    windows = layer_windows(cfg)
    for i in range(cfg.n_layers):
        lp = cm.layer_params(params["layers"], i)
        if "attn" in lp:
            with span("model.attn"):
                h = cm.rmsnorm(lp["attn_norm"], x, cfg.rms_eps)
                window = windows[i] if windows else 0
                if cfg.attn_type == ATTN_MLA:
                    a = attn.mla_decode(lp["attn"], h, cache["ckv"][i],
                                        cache["krope"][i], pos, cfg)
                elif "k_scale" in cache:        # int8-quantized cache
                    a = attn.gqa_decode_q8(
                        lp["attn"], h, cache["k"][i], cache["v"][i],
                        cache["k_scale"][i], cache["v_scale"][i], pos, cfg,
                        window=window, cache_len=lens)[0]
                else:
                    a, _, _ = attn.gqa_decode(lp["attn"], h, cache["k"][i],
                                              cache["v"][i], pos, cfg,
                                              window=window, cache_len=lens)
                if "ssm" in lp:
                    a = _mix(lp, a, _ssm_decode(lp["ssm"], h, cache, i, cfg),
                             cfg)
                x = x + a
        elif "ssm" in lp:
            with span("model.ssm"):
                h = cm.rmsnorm(lp["ssm_norm"], x, cfg.rms_eps)
                x = x + _ssm_decode(lp["ssm"], h, cache, i, cfg)
        if "ffn" in lp:
            with span("model.ffn"):
                h = cm.rmsnorm(lp["ffn_norm"], x, cfg.rms_eps)
                x = x + _ffn(lp, h, cfg, moe_ctx)
    cache["pos"] = lens
    with span("model.head"):
        x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
        return unembed(params, cfg, x), cache
