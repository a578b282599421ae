"""Mamba2-130M [arXiv:2405.21060] — SSD (state-space duality), attention-free.

Sub-quadratic: runs the long_500k decode shape with O(1) per-token state.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50_280,
    tie_embeddings=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=64,
)
