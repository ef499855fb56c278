"""Hand-written Hopper kernels plus their plain PyTorch versions.

log_conv2d       NHWC conv against packed log codes: the CUDA kernel
                 (`csrc/log_conv2d.cu`, wrapper `log_conv2d_fused`) and the
                 plain `log_conv2d_blockwise` / `log_conv2d_ref`
log_matmul       matmul against packed log codes: the CUDA kernel
                 (`csrc/log_matmul.cu`, wrapper `log_matmul_cuda`)
flash_attention  GQA online-softmax attention: the CUDA kernel
                 (`csrc/flash_attention.cu`, wrapper `flash_attention_cuda`)
ref              the oracles `ref_log_matmul` and `ref_attention`
ops              the dispatch layer: ``impl="cuda|blockwise|ref|auto"``
"""
from . import ops, ref
# `ops.log_matmul` is not re-exported: the name is the kernel's module
from .ops import AttentionConfig, ConvConfig, attention, conv2d, resolve_impl
