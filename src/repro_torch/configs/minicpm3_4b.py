"""MiniCPM3-4B — MLA (multi-head latent attention). [hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.configs import ModelConfig, MLAConfig, FAMILY_DENSE, ATTN_MLA

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family=FAMILY_DENSE,
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_type=ATTN_MLA,
    head_dim=96,  # qk_nope(64) + qk_rope(32)
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    citation="hf:openbmb/MiniCPM3-4B",
)
