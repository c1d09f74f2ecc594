"""Qwen2-0.5B — GQA with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs import ModelConfig, FAMILY_DENSE

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family=FAMILY_DENSE,
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    citation="arXiv:2407.10671",
)
