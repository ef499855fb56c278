"""Log quantization (NeuroMAX §3) and the packed-code container."""

from .logquant import (LogQuantConfig, QuantizedTensor, fake_log_quant,
                       linear_quantize, log_dequantize, log_quantize,
                       quantize_tensor)
