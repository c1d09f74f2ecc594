"""Granite-3.0-1B-A400M — MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs import ModelConfig, MoEConfig, FAMILY_MOE

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family=FAMILY_MOE,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                # per-expert width
    vocab_size=49155,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8),
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
