"""Kimi K2 1T-A32B [arXiv:2501.kimi2; paper-table, unverified] — 384 experts top-8.

Assignment specifies GQA kv=8 (the production model uses MLA; the paper-table entry
pins GQA, which we follow). The trillion parameters live in the 61x384 expert FFNs;
expert-parallel sharding over the 'model' axis is mandatory (dist/sharding.py).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163_840,
    act="silu", tie_embeddings=True,
    num_experts=384, experts_per_token=8, capacity_factor=1.25,
    router_mode="immune",
)
