"""qwen2-vl-2b [vlm]: 28L d1536 12H (GQA kv=2) ff8960 vocab 151936, M-RoPE
(t/h/w sections 16/24/24 of head_dim/2=64) [arXiv:2409.12191].  The ViT
frontend is a stub: merged patch/text embeddings plus [3, B, T] M-RoPE
position ids stand in for tokens."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151_936, ffn="swiglu", qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0, tie_embeddings=True, embed_inputs=False,
)
