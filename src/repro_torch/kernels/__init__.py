"""Hand-written Hopper kernels plus their plain PyTorch versions.

log_conv2d       NHWC conv against packed log codes: the CUDA kernel
                 (`csrc/log_conv2d.cu`, wrapper `log_conv2d_fused`) and the
                 plain `log_conv2d_blockwise` / `log_conv2d_ref`
log_matmul       matmul against packed log codes: the CUDA kernel
                 (`csrc/log_matmul.cu`, wrapper `log_matmul_cuda`)
flash_attention  GQA online-softmax attention: the CUDA kernel
                 (`csrc/flash_attention.cu`, wrapper `flash_attention_cuda`)
wkv6             the RWKV6 recurrence: the CUDA kernel (`csrc/wkv6.cu`,
                 wrapper `wkv6_cuda`) and the chunked plain `wkv6_chunked`
ref              the oracles `ref_log_matmul`, `ref_attention`, `ref_wkv6`
ops              the dispatch layer: ``impl="cuda|blockwise|ref|auto"``
"""
from . import ops, ref
# `ops.log_matmul` is not re-exported: the name is the kernel's module.
# `ops.wkv6` is, as in the JAX package: after this line the package
# attribute `wkv6` is the op, and the kernel's module is reached with
# ``from repro_torch.kernels.wkv6 import ...``
from .ops import (AttentionConfig, ConvConfig, WkvConfig, attention, conv2d,
                  resolve_impl, wkv6)
