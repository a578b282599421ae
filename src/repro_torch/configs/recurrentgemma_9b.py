"""RecurrentGemma-9B [arXiv:2402.19427] — RG-LRU + local attention, 1:2 pattern.

38 layers tile the (rglru, rglru, local-attn) Griffin pattern: 12 full groups + a
2-layer recurrent tail. Sub-quadratic: runs the long_500k decode shape (local
attention is ring-buffered at window=2048; recurrences are O(1) state).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12_288, vocab_size=256_000,
    act="gelu", tie_embeddings=True, scale_embeddings=True, use_plus_one_norm=True,
    block_pattern=("rglru", "rglru", "local"), lru_width=4096, local_window=2048,
)
