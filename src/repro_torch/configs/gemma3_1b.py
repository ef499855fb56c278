"""gemma3-1b [dense]: 26L d1152 4H (MQA kv=1, head_dim 256) ff6912 GeGLU
vocab 262144, 5:1 local(512):global [hf:google/gemma-3-1b-pt]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262_144, ffn="geglu",
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    attn_window=512,
    rope_theta=1_000_000.0, tie_embeddings=True, embed_scale=True,
)
