"""rwkv6-1.6b [ssm]: 24L d2048 (attention-free, head_size 64) cmix ff7168
vocab 65536 — Finch data-dependent decay [arXiv:2404.05892]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65_536, ffn="gelu", norm="layernorm",
    layer_pattern=("rwkv",), rwkv_head_size=64,
    tie_embeddings=False,
)
