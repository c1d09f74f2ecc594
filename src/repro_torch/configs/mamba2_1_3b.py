"""Mamba2-1.3B — attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs import ModelConfig, SSMConfig, FAMILY_SSM, ATTN_NONE

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family=FAMILY_SSM,
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                  # attn-free; no separate FFN (Mamba block is the mixer)
    vocab_size=50280,
    attn_type=ATTN_NONE,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=256),
    citation="arXiv:2405.21060",
)
