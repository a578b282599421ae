"""Granite-MoE 3B-A800M [hf:ibm-granite] — 40 experts top-8, immune-balanced router."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49_155,
    act="silu", tie_embeddings=True,
    num_experts=40, experts_per_token=8, capacity_factor=1.25,
    router_mode="immune",
)
