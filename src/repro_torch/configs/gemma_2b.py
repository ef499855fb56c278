"""gemma-2b [dense]: 18L d2048 8H (MQA kv=1, head_dim 256) ff16384 GeGLU
vocab 256000 [arXiv:2403.08295]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256_000, ffn="geglu",
    rope_theta=10_000.0, tie_embeddings=True, embed_scale=True,
)
