"""CodeQwen1.5-7B — Qwen1.5 architecture. [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs import ModelConfig, FAMILY_DENSE

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family=FAMILY_DENSE,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,           # GQA kv=32 (full MHA-style KV)
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,           # Qwen1.5 uses QKV bias
    rope_theta=1_000_000.0,
    citation="hf:Qwen/CodeQwen1.5-7B",
)
