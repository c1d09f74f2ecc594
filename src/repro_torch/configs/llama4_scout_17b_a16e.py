"""Llama-4-Scout-17B-16E — MoE 16 experts top-1, shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs import ModelConfig, MoEConfig, FAMILY_MOE

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family=FAMILY_MOE,
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,               # per-expert width
    vocab_size=202048,
    rope_theta=500000.0,
    moe=MoEConfig(num_experts=16, top_k=1, shared_expert_ff=8192),
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
