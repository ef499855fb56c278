"""repro_torch: the NeuroMAX reproduction in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100.

A port of the JAX package `repro`, held against it by the tests.  It
imports neither `jax` nor `repro`.

Subpackages:
  core      log quantization and the packed-code container
  kernels   the CUDA log-domain conv kernel, its plain versions, `ops`
  models    the paper's four CNNs
  serving   load-time packing of CNN weights
"""
__version__ = "0.1.0"
