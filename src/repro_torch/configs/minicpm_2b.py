"""MiniCPM-2B [arXiv:2404.06395; hf] — llama-like dense, MHA, WSD schedule."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36, head_dim=64,
    d_ff=5760, vocab_size=122_753,
    act="silu", tie_embeddings=True,
)
# MiniCPM trains with the WSD (warmup-stable-decay) schedule:
TRAIN_SCHEDULE = "wsd"
