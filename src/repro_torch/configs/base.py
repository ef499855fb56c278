"""Model/config schema shared by every assigned architecture.

Counterpart of `repro.configs.base` with torch dtypes.  The JAX package's
dry-run helpers (`input_specs`, `SHAPES`) and its scan and sharding knobs
are not carried over: the port runs eagerly on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# Layer kinds appearing in `layer_pattern` (the mixer of each layer):
#   attn    full causal attention
#   local   sliding-window causal attention (cfg.attn_window)
#   rec     RG-LRU recurrent block (RecurrentGemma)
#   rwkv    RWKV6 time-mix + channel-mix (replaces attn+ffn)
MIXERS = ("attn", "local", "rec", "rwkv")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    ffn: str = "swiglu"              # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: tuple | None = None   # qwen2-vl M-RoPE (t, h, w) halves
    attn_window: int | None = None        # window for 'local' layers
    layer_pattern: tuple = ("attn",)      # tiled over n_layers
    # MoE (applies to the FFN of every attn/local layer when n_experts > 0)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # RWKV
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    # embeddings / head
    tie_embeddings: bool = True
    embed_inputs: bool = True        # False: frontend stub feeds embeddings
    embed_scale: bool = False        # gemma-style sqrt(d_model) scaling
    norm: str = "rmsnorm"
    # numerics
    param_dtype: Any = torch.float32
    act_dtype: Any = torch.bfloat16
    # paper technique: None | "logq6" (base-√2 6-bit log-quantized weights)
    quant: str | None = None
    # attention dispatch (`kernels/ops.attention`): cuda | blockwise | ref |
    # auto ("cuda" on the card, "blockwise" on the CPU, as `log_matmul`
    # resolves); the blockwise version's kv chunk and math knobs
    attn_impl: str = "auto"
    attn_block_k: int = 1024
    gqa_broadcast: bool = False      # einsum-broadcast GQA (no kv repeat)
    attn_acc_dtype: Any = torch.float32  # blockwise attention math dtype
    # hybrid (griffin) recurrence width
    lru_width: int | None = None
    conv1d_width: int = 4

    # ---------------- derived ----------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def segments(self) -> tuple:
        """[(unit, n_rep), ...] — groups of repeated units covering
        n_layers.  The pattern is tiled; a remainder becomes its own
        single-rep unit.  Parameters and caches are stacked per group with
        a leading ``n_rep`` dimension, as in the JAX package."""
        pat = tuple(self.layer_pattern)
        n_rep, rem = divmod(self.n_layers, len(pat))
        segs = []
        if n_rep:
            segs.append((pat, n_rep))
        if rem:
            segs.append((pat[:rem], 1))
        return tuple(segs)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        n = V * D  # embed
        if not self.tie_embeddings:
            n += V * D
        for unit, rep in self.segments:
            for kind in unit:
                if kind == "rwkv":
                    n += rep * (5 * D * D +                  # wr,wk,wv,wg,wo
                                2 * self.rwkv_decay_lora * D +   # decay LoRA
                                2 * D * F + D * D)           # cmix ck,cv,cr
                    continue
                if kind == "rec":
                    W = self.lru_width or D
                    n += rep * (2 * D * W + W * D + 3 * W * W +
                                self.conv1d_width * W)
                else:  # attn / local
                    n += rep * (D * self.q_dim + 2 * D * self.kv_dim +
                                self.q_dim * D)
                # FFN
                fmul = 2 if self.ffn in ("swiglu", "geglu") else 1
                if self.is_moe and kind in ("attn", "local"):
                    n += rep * (D * self.n_experts +
                                self.n_experts * (fmul * D * F + F * D))
                else:
                    n += rep * (fmul * D * F + F * D)
        return n

    def reduced(self, **over) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 * len(self.layer_pattern)),
            d_model=64,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=1 if self.n_kv_heads < self.n_heads else 2,
            head_dim=16,
            d_ff=128 if not self.is_moe else 32,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            # capacity ≥ tokens in smoke tests → decode ≡ full forward exactly
            capacity_factor=max(self.capacity_factor, 8.0),
            attn_window=min(self.attn_window, 32) if self.attn_window else None,
            lru_width=64 if self.lru_width else None,
            rwkv_head_size=16,
            rwkv_decay_lora=8,
            attn_block_k=32,
            act_dtype=torch.float32,
        )
        if kw["n_kv_heads"] > kw["n_heads"]:
            kw["n_kv_heads"] = kw["n_heads"]
        if self.n_kv_heads == self.n_heads:   # MHA stays MHA
            kw["n_kv_heads"] = kw["n_heads"]
        if self.mrope_sections is not None:   # rescale to the reduced head
            half = kw["head_dim"] // 2
            t = max(1, half // 4)
            h = (half - t) // 2
            kw["mrope_sections"] = (t, h, half - t - h)
        kw.update(over)
        return dataclasses.replace(self, **kw)
