"""DeepSeek-67B — llama-arch dense, GQA kv=8. [arXiv:2401.02954; hf]"""
from repro_torch.configs import ModelConfig, FAMILY_DENSE

CONFIG = ModelConfig(
    name="deepseek-67b",
    family=FAMILY_DENSE,
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
    citation="arXiv:2401.02954",
)
