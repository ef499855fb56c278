"""NeuroMAX core: log quantization, log-PE math, PE-grid + dataflow models."""

from .logquant import (LogQuantConfig, QuantizedTensor, fake_log_quant,
                       linear_quantize, log_dequantize, log_quantize,
                       quantize_tensor)
from .logmath import LogPEThread, log_product_fixed, make_frac_lut
from .dataflow import (CLOCK_HZ, PEAK_GOPS_PAPER, LayerSpec, LayerPerf,
                       NetworkPerf, analyze_layer, analyze_network)
from .pe_grid import PEGrid, GridStats, TOTAL_THREADS
from . import accelerator, cost_model
