"""Hymba-1.5B — hybrid: parallel attention + mamba heads in every layer;
sliding-window attention except 3 full-attention layers. [arXiv:2411.13676; hf]"""
from repro_torch.configs import ModelConfig, SSMConfig, FAMILY_HYBRID

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family=FAMILY_HYBRID,
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    sliding_window=1024,
    full_attn_layers=(0, 15, 31),   # first/middle/last use global attention
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, chunk_size=256),
    citation="arXiv:2411.13676",
)
