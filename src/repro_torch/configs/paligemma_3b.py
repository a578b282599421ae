"""PaliGemma-3B [arXiv:2407.07726; hf] — SigLIP stub prefix + gemma-2b decoder (MQA).

The SigLIP tower is a stub per the assignment: input_specs provides 256 precomputed
patch embeddings of width 1152; the backbone sees a learned projection of them as a
bidirectional prefix (prefix-LM masking).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16_384, vocab_size=257_216,
    act="gelu", tie_embeddings=True, scale_embeddings=True, use_plus_one_norm=True,
    frontend_tokens=256, frontend_dim=1152,
)
