"""repro_torch: the NeuroMAX reproduction in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100.

A port of the JAX package `repro`, held against it by the tests.  It
imports neither `jax` nor `repro`.

Subpackages:
  configs   the LM architectures (`get_config`), as data
  core      log quantization and the packed-code container
  kernels   the CUDA kernels (log-domain conv, log-domain matmul, GQA
            attention), their plain versions, `ops`
  launch    `python -m repro_torch.launch.serve`, the LM serving CLI
  models    the paper's four CNNs; the transformer (attention archs)
  obs       span tracer and metrics registry
  serving   load-time weight packing, the continuous-batching engine
"""
__version__ = "0.1.0"
