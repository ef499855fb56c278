"""Architecture registry: --arch <id> resolution for every launcher."""
from . import (gemma_2b, gemma3_1b, granite_moe_1b, granite_moe_3b,
               llama3_405b, musicgen_large, qwen15_4b, qwen2_vl_2b,
               recurrentgemma_2b, rwkv6_16b)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in (
    gemma_2b, llama3_405b, gemma3_1b, qwen15_4b, musicgen_large,
    qwen2_vl_2b, granite_moe_3b, granite_moe_1b, rwkv6_16b,
    recurrentgemma_2b)}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
