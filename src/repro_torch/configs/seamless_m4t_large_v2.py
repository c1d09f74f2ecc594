"""SeamlessM4T-large-v2 — encoder-decoder, multimodal (audio frontend is a
STUB: input_specs() provides precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from repro_torch.configs import ModelConfig, FAMILY_AUDIO

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family=FAMILY_AUDIO,
    n_layers=24,             # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    is_encoder_decoder=True,
    n_encoder_layers=24,
    citation="arXiv:2308.11596",
)
