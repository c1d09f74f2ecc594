"""Uniform model interface over the port's zoo.

``build(cfg)`` returns a :class:`ModelBundle` exposing init / loss_fn /
prefill / decode_step / init_cache. Decoder-only configs go to
``models.transformer`` (GQA or MLA attention, dense or MoE feed-forward,
the VLM's prefix, the SSM and hybrid families, the int8 KV cache;
``transformer.check_supported``), encoder-decoder configs to
``models.encdec``. The MoE through shard_map raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import encdec, transformer

ENC_CTX_SERVE = 4096  # encoder context frames for enc-dec serve shapes


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable             # (generator=None, device="cuda", dtype,
                               #  requires_grad=False) -> params
    loss_fn: Callable          # (params, batch, *, dtype, remat) -> scalar
    prefill: Callable          # (params, batch, max_len, **kw) -> (logits, cache)
    decode_step: Callable      # (params, cache, token, **kw) -> (logits, cache)
    init_cache: Callable       # (batch, max_len, dtype, ...) -> cache


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

    def prefill_fn(params, batch, max_len=None, *, dtype=torch.bfloat16):
        return transformer.prefill(params, cfg, batch["tokens"],
                                   prefix_embeds=batch.get("prefix_embeds"),
                                   max_len=max_len, dtype=dtype)

    def decode_fn(params, cache, token, *, dtype=torch.bfloat16):
        return transformer.decode_step(params, cfg, cache, token, dtype=dtype)

    def init_cache(batch, max_len, dtype=torch.bfloat16, per_slot_pos=False,
                   kv_dtype=None, device="cuda"):
        return transformer.init_cache(cfg, batch, max_len, dtype,
                                      per_slot_pos=per_slot_pos,
                                      kv_dtype=kv_dtype, device=device)

    return ModelBundle(cfg, init_fn, loss_fn, prefill_fn, decode_fn,
                       init_cache)


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

    return ModelBundle(cfg, init_fn, loss_fn, prefill_fn, decode_fn,
                       init_cache)
