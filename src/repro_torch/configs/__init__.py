"""Model configurations (a copy of ``repro.configs`` for the port).

Every architecture the port serves is a module
``repro_torch.configs.<arch_id>`` exporting ``CONFIG`` (the published dims)
built on :class:`ModelConfig`. ``get_config(arch_id)`` resolves ids (dashes
or underscores accepted); ``reduced(cfg)`` shrinks a config to a
CPU-testable size of the same family. Architectures join ``ARCH_IDS`` as
their model families are ported.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional

ATTN_GQA = "gqa"        # grouped-query attention (covers MHA when kv == heads)
ATTN_MLA = "mla"        # multi-head latent attention (DeepSeek-V2 / MiniCPM3)
ATTN_NONE = "none"      # attention-free (pure SSM)

FAMILY_DENSE = "dense"
FAMILY_MOE = "moe"
FAMILY_VLM = "vlm"
FAMILY_AUDIO = "audio"  # encoder-decoder with audio-frame frontend stub
FAMILY_HYBRID = "hybrid"
FAMILY_SSM = "ssm"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    shared_expert_ff: int = 0  # width of optional always-on shared expert


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    conv_width: int = 4
    n_groups: int = 1  # B/C shared across heads (GQA-analogue in SSD duality)


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    attn_type: str = ATTN_GQA
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0          # 0 = full attention
    # hybrid archs: explicit ids of the layers that use full attention
    full_attn_layers: tuple = ()
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    # enc-dec
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # vlm / audio frontend stubs
    n_prefix_embeds: int = 0         # patch/frame embeddings prepended to text
    citation: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings included)."""
        c = self
        emb = c.vocab_size * c.d_model * (1 if c.tie_embeddings else 2)
        total = emb + c.n_layers * self._params_per_layer()
        if c.is_encoder_decoder:
            enc_layer = self._attn_params() + 3 * c.d_model * c.d_ff + 2 * c.d_model
            total += c.n_encoder_layers * enc_layer
            total += c.n_layers * self._attn_params()  # cross attention
        return total

    def _attn_params(self) -> int:
        c = self
        if c.attn_type == ATTN_NONE:
            return self._ssm_params()
        if c.attn_type == ATTN_MLA:
            m = c.mla
            qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = c.d_model * m.q_lora_rank + m.q_lora_rank * c.n_heads * qk_head
            p += c.d_model * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * c.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += c.n_heads * m.v_head_dim * c.d_model
            return p
        qkv = c.d_model * (c.n_heads + 2 * c.n_kv_heads) * c.head_dim
        p = qkv + c.n_heads * c.head_dim * c.d_model
        if c.family == FAMILY_HYBRID and c.ssm is not None:
            p += self._ssm_params()
        return p

    def _ssm_params(self) -> int:
        s = self.ssm
        d_inner = s.expand * self.d_model
        n_heads = d_inner // s.head_dim
        p = self.d_model * 2 * d_inner                  # in_proj (x, z)
        p += self.d_model * 2 * s.n_groups * s.d_state  # B, C projections
        p += self.d_model * n_heads                     # dt proj
        p += n_heads + n_heads                          # A_log, D
        p += (d_inner + 2 * s.n_groups * s.d_state) * s.conv_width
        p += d_inner * self.d_model                     # out proj
        return p

    def _params_per_layer(self) -> int:
        c = self
        if c.moe is not None:
            ffn = c.moe.num_experts * 3 * c.d_model * c.d_ff
            ffn += c.d_model * c.moe.num_experts
            ffn += 3 * c.d_model * c.moe.shared_expert_ff
        elif c.family == FAMILY_SSM:
            ffn = 0
        else:
            ffn = 3 * c.d_model * c.d_ff
        return self._attn_params() + ffn + 2 * c.d_model


ARCH_IDS = ("qwen2-0.5b", "mamba2-1.3b", "hymba-1.5b", "codeqwen1.5-7b",
            "granite-moe-1b-a400m", "minicpm3-4b", "internvl2-76b",
            "seamless-m4t-large-v2", "deepseek-67b", "llama4-scout-17b-a16e")


def _mod_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("_", "-")
    for a in ARCH_IDS:
        if a == arch_id or _mod_name(a) == _mod_name(arch_id):
            return importlib.import_module(
                f"repro_torch.configs.{_mod_name(a)}").CONFIG
    raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 64,
            vocab: int = 512) -> ModelConfig:
    """Shrink a config to a tiny same-family variant runnable on CPU."""
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    kv = 0
    if cfg.n_kv_heads:
        kv = max(1, min(cfg.n_kv_heads, n_heads))
        # preserve GQA-ness when the full config has it
        if cfg.n_heads and cfg.n_kv_heads < cfg.n_heads:
            kv = max(1, n_heads // 2)
    head_dim = d_model // n_heads if n_heads else 0
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=kv,
        d_ff=d_model * 2 if cfg.d_ff else 0,
        vocab_size=vocab,
        head_dim=head_dim,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        full_attn_layers=tuple(i for i in cfg.full_attn_layers if i < n_layers),
        n_encoder_layers=min(cfg.n_encoder_layers, n_layers),
        n_prefix_embeds=min(cfg.n_prefix_embeds, 8),
    )
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
                            capacity_factor=8.0,
                            shared_expert_ff=(d_model if cfg.moe.shared_expert_ff else 0))
        kw["d_ff"] = d_model
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk_size=32)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=head_dim, qk_rope_head_dim=head_dim // 2,
                              v_head_dim=head_dim)
    return replace(cfg, **kw)
