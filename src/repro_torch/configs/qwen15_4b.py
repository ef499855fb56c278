"""qwen1.5-4b [dense]: 40L d2560 20H (MHA kv=20) ff6912 vocab 151936,
QKV bias [hf:Qwen/Qwen1.5-4B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab=151_936, ffn="swiglu", qkv_bias=True,
    rope_theta=10_000.0, tie_embeddings=False,
)
