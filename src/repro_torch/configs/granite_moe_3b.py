"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) per-expert ff512
vocab 49155, 40 experts top-8 [hf:ibm-granite]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49_155, ffn="swiglu",
    n_experts=40, top_k=8,
    rope_theta=10_000.0, tie_embeddings=True,
)
