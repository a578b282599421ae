"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

The EnCodec codec is a stub per the assignment: input_specs provides precomputed
frame embeddings (width 128, EnCodec's latent dim) that are added to the code-token
embeddings; the backbone predicts the next code (vocab 2048 per codebook).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    act="gelu", tie_embeddings=False,
    frontend_tokens=0, frontend_dim=128,
)
