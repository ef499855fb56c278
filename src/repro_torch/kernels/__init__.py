"""Hand-written Hopper kernels plus their plain PyTorch versions.

log_conv2d  NHWC conv against packed log codes: the CUDA kernel
            (`csrc/log_conv2d.cu`, wrapper `log_conv2d_fused`) and the
            plain `log_conv2d_blockwise` / `log_conv2d_ref`
ref         `ref_log_matmul`, the decode-then-matmul oracle
ops         the dispatch layer: ``impl="cuda|blockwise|ref|auto"``
"""
from . import ops, ref
from .ops import ConvConfig, conv2d, resolve_impl
