"""InternVL2-76B backbone (InternViT frontend is a STUB: input_specs() provides
precomputed patch embeddings). LLM backbone dims. [arXiv:2404.16821; unverified]"""
from repro_torch.configs import ModelConfig, FAMILY_VLM

CONFIG = ModelConfig(
    name="internvl2-76b",
    family=FAMILY_VLM,
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    n_prefix_embeds=256,     # precomputed ViT patch embeddings per example
    citation="arXiv:2404.16821",
)
