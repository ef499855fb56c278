"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1, head_dim 256)
ff7680 GeGLU vocab 256000 — RG-LRU + local attention (2048), pattern
(rec, rec, attn) [arXiv:2402.19427]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256_000, ffn="geglu",
    layer_pattern=("rec", "rec", "local"), attn_window=2048,
    lru_width=2560, conv1d_width=4,
    rope_theta=10_000.0, tie_embeddings=True, embed_scale=True,
)
