"""Uniform model interface over the port's zoo.

``build(cfg)`` returns a :class:`ModelBundle` exposing init / loss_fn /
prefill / decode_step / init_cache. Decoder-only configs go to
``models.transformer`` (GQA or MLA attention, dense or MoE feed-forward,
the VLM's prefix, the SSM and hybrid families, the int8 KV cache;
``transformer.check_supported``), encoder-decoder configs to
``models.encdec``. ``param_axes()`` and ``cache_axes(...)`` give the
logical axis names of the params' and the cache's leaves, which the
sharding rules (``distributed.sharding``) read. ``batch_specs(shape)``
gives a cell's inputs as meta tensors (the reference's
``jax.ShapeDtypeStruct``), in the reference's conventions:

  train_4k      tokens (B, S). VLM: S_text = S - n_prefix, and bf16
                prefix_embeds (B, n_prefix, d) fill the rest. Enc-dec:
                S_enc = S_dec = S // 2.
  prefill_32k   decoder prefill of length S (enc-dec: ENC_CTX_SERVE encoder
                frames).
  decode_*      one token (B, 1) against a cache of length S.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import FAMILY_VLM, InputShape, ModelConfig
from repro_torch.models import encdec, transformer

ENC_CTX_SERVE = 4096  # encoder context frames for enc-dec serve shapes


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable             # (generator=None, device="cuda", dtype,
                               #  requires_grad=False) -> params
    loss_fn: Callable          # (params, batch, *, dtype, remat,
                               #  moe_ctx) -> scalar
    prefill: Callable          # (params, batch, max_len, **kw) -> (logits, cache)
    decode_step: Callable      # (params, cache, token, **kw) -> (logits, cache)
    init_cache: Callable       # (batch, max_len, dtype, ...) -> cache
    param_axes: Callable       # () -> the params' tree of axis names
    cache_axes: Callable       # (batch, max_len, ...) -> the cache's
    batch_specs: Callable      # (InputShape) -> {name: meta tensor}


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def build(cfg: ModelConfig) -> ModelBundle:
    if cfg.is_encoder_decoder:
        return _build_encdec(cfg)
    return _build_decoder(cfg)


def _build_decoder(cfg: ModelConfig) -> ModelBundle:
    transformer.check_supported(cfg)

    def init_fn(generator=None, device="cuda", dtype=torch.float32,
                requires_grad=False):
        return transformer.init(cfg, generator=generator, device=device,
                                dtype=dtype, requires_grad=requires_grad)

    def loss_fn(params, batch, *, dtype=torch.bfloat16, remat=True,
                moe_ctx=None):
        return transformer.loss_fn(params, cfg, batch, dtype=dtype,
                                   remat=remat, moe_ctx=moe_ctx)

    def prefill_fn(params, batch, max_len=None, *, dtype=torch.bfloat16,
                   moe_ctx=None):
        return transformer.prefill(params, cfg, batch["tokens"],
                                   prefix_embeds=batch.get("prefix_embeds"),
                                   max_len=max_len, dtype=dtype,
                                   moe_ctx=moe_ctx)

    def decode_fn(params, cache, token, *, dtype=torch.bfloat16,
                  moe_ctx=None):
        return transformer.decode_step(params, cfg, cache, token, dtype=dtype,
                                       moe_ctx=moe_ctx)

    def init_cache(batch, max_len, dtype=torch.bfloat16, per_slot_pos=False,
                   kv_dtype=None, device="cuda"):
        return transformer.init_cache(cfg, batch, max_len, dtype,
                                      per_slot_pos=per_slot_pos,
                                      kv_dtype=kv_dtype, device=device)

    def cache_axes(batch, max_len, kv_dtype=None, per_slot_pos=False):
        return transformer.cache_axes(cfg, per_slot_pos=per_slot_pos,
                                      kv_dtype=kv_dtype)

    def batch_specs(shape: InputShape):
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"token": _spec((b, 1), torch.int32)}
        specs = {}
        s_text = s
        if cfg.family == FAMILY_VLM:
            s_text = s - cfg.n_prefix_embeds
            specs["prefix_embeds"] = _spec(
                (b, cfg.n_prefix_embeds, cfg.d_model), torch.bfloat16)
        specs["tokens"] = _spec((b, s_text), torch.int32)
        return specs

    return ModelBundle(cfg, init_fn, loss_fn, prefill_fn, decode_fn,
                       init_cache, lambda: transformer.param_axes(cfg),
                       cache_axes, batch_specs)


def _build_encdec(cfg: ModelConfig) -> ModelBundle:
    encdec.check_supported(cfg)

    def init_fn(generator=None, device="cuda", dtype=torch.float32,
                requires_grad=False):
        return encdec.init(cfg, generator=generator, device=device,
                           dtype=dtype, requires_grad=requires_grad)

    def loss_fn(params, batch, *, dtype=torch.bfloat16, remat=True,
                moe_ctx=None):
        return encdec.loss_fn(params, cfg, batch, dtype=dtype, remat=remat)

    def prefill_fn(params, batch, max_len=None, *, dtype=torch.bfloat16):
        return encdec.prefill(params, cfg, batch["tokens"],
                              batch["enc_embeds"], max_len=max_len,
                              dtype=dtype)

    def decode_fn(params, cache, token, *, dtype=torch.bfloat16):
        return encdec.decode_step(params, cfg, cache, token, dtype=dtype)

    def init_cache(batch, max_len, dtype=torch.bfloat16,
                   enc_len=ENC_CTX_SERVE, device="cuda"):
        return encdec.init_cache(cfg, batch, max_len, enc_len, dtype,
                                 device=device)

    def cache_axes(batch, max_len, enc_len=ENC_CTX_SERVE):
        return encdec.cache_axes(cfg)

    def batch_specs(shape: InputShape):
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"token": _spec((b, 1), torch.int32)}
        if shape.kind == "train":
            s_enc = s_dec = s // 2
        else:  # prefill
            s_enc, s_dec = ENC_CTX_SERVE, s
        return {"tokens": _spec((b, s_dec), torch.int32),
                "enc_embeds": _spec((b, s_enc, cfg.d_model), torch.bfloat16)}

    return ModelBundle(cfg, init_fn, loss_fn, prefill_fn, decode_fn,
                       init_cache, lambda: encdec.param_axes(cfg),
                       cache_axes, batch_specs)
