"""Gemma-7B [arXiv:2403.08295; hf] — GeGLU, head_dim=256, scaled embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24_576, vocab_size=256_000,
    act="gelu", tie_embeddings=True, scale_embeddings=True, use_plus_one_norm=True,
)
