"""musicgen-large [audio]: 48L d2048 32H ff8192 vocab 2048 — decoder-only
over EnCodec tokens [arXiv:2306.05284].  The EnCodec frontend is a stub:
precomputed frame embeddings [B, T, D] stand in for tokens."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, ffn="gelu", norm="layernorm",
    rope_theta=10_000.0, tie_embeddings=False, embed_inputs=False,
)
