"""Base-√2 logarithmic quantization (NeuroMAX §3, eqs. 1-4), in PyTorch.

Counterpart of `repro.core.logquant`: the same ⟨m, n, b⟩ quantizer, the
same packed int8 storage layout and the same per-channel scales, so codes
made here equal the JAX package's byte for byte (up to a one-ulp `log2`
difference exactly on a half-step boundary).

Storage layout (the paper's w'[6]-is-sign convention):
    packed int8 = (sign << bits) | biased_code,   biased_code ∈ [0, 2^bits)
with a per-channel (or per-tensor) fp scale so the largest magnitude maps to
the top code.  Biased code 0 is reserved for exact zero (eq. 4's x = 0 case).

Also holds the linear Qm.n quantizer (eqs. 1-2) and a straight-through
fake-quant for training.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "LogQuantConfig",
    "log_quantize",
    "unpack",
    "log_dequantize",
    "fake_log_quant",
    "linear_quantize",
    "quantize_tensor",
    "dequantize_tensor",
    "quantization_snr_db",
    "QuantizedTensor",
]


@dataclasses.dataclass(frozen=True)
class LogQuantConfig:
    """⟨m, n, b⟩ of the paper, expressed in bits.

    bits:       exponent-code width (excludes the sign bit); the paper uses 6.
    frac_bits:  n, fractional bits of the log2 exponent. n=1 → base √2.
    per_channel: one scale per trailing channel instead of per tensor.
    """

    bits: int = 6
    frac_bits: int = 1
    per_channel: bool = True

    @property
    def steps(self) -> int:  # steps per octave
        return 1 << self.frac_bits

    @property
    def base(self) -> float:
        return float(2.0 ** (1.0 / self.steps))

    @property
    def code_min(self) -> int:
        # biased 0 is the zero code; magnitudes occupy [1, 2^bits - 1]
        return -((1 << self.bits) - 2)

    @property
    def code_max(self) -> int:
        return 0  # after max-abs normalisation, log2(|x|/scale) ≤ 0

    @property
    def zero_code(self) -> int:
        return 0  # biased

    @property
    def bias(self) -> int:
        return (1 << self.bits) - 1

    @property
    def storage_bits(self) -> int:
        return self.bits + 1  # + sign

    @property
    def bytes_per_weight(self) -> float:
        return self.storage_bits / 8.0


DEFAULT = LogQuantConfig()


def _scale_for(x: torch.Tensor, cfg: LogQuantConfig, axis=None):
    a = x.abs()
    s = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    # avoid log(0); an all-zero tensor/channel quantizes to all-zero codes
    return torch.where(s > 0, s, torch.ones_like(s))


def log_quantize(x: torch.Tensor, cfg: LogQuantConfig = DEFAULT, scale=None):
    """x → (packed int8 codes, scale).  packed = (sign << bits) | biased_code."""
    if scale is None:
        axis = (tuple(range(x.ndim - 1))
                if (cfg.per_channel and x.ndim >= 2) else None)
        scale = _scale_for(x, cfg, axis)
    mag = x.abs() / scale
    # log2 with frac_bits of precision; round half to even, as jnp.round
    code = torch.round(torch.log2(torch.clamp(mag, min=1e-38)) * cfg.steps)
    code = torch.clamp(code, cfg.code_min, cfg.code_max)
    biased = code.to(torch.int32) + cfg.bias
    biased = torch.where(x == 0, cfg.zero_code, biased)
    sign = (x < 0).to(torch.int32)
    packed = (sign << cfg.bits) | biased
    return packed.to(torch.int8), scale


def unpack(packed: torch.Tensor, cfg: LogQuantConfig = DEFAULT):
    """packed int8 → (unbiased code int32, sign ±1, nonzero mask)."""
    p = packed.to(torch.int32)
    biased = p & ((1 << cfg.bits) - 1)
    sign = 1 - 2 * ((p >> cfg.bits) & 1)
    nonzero = biased != cfg.zero_code
    code = biased - cfg.bias
    return code, sign, nonzero


def log_dequantize(packed: torch.Tensor, scale, cfg: LogQuantConfig = DEFAULT,
                   dtype=torch.float32):
    """Vectorised eq. (8): sign · 2^(code/steps) · scale."""
    code, sign, nonzero = unpack(packed, cfg)
    mag = torch.exp2(code.to(dtype) / cfg.steps)
    out = sign.to(dtype) * torch.where(nonzero, mag, torch.zeros_like(mag))
    return (out * scale).to(dtype)


class _FakeLogQuant(torch.autograd.Function):
    """Quantize-dequantize forward, straight-through backward."""

    @staticmethod
    def forward(ctx, x, cfg):
        packed, scale = log_quantize(x, cfg)
        return log_dequantize(packed, scale, cfg, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_log_quant(x: torch.Tensor, cfg: LogQuantConfig = DEFAULT):
    """Quantize-dequantize with straight-through gradients (for QAT)."""
    return _FakeLogQuant.apply(x, cfg)


def linear_quantize(x: torch.Tensor, int_bits: int, frac_bits: int):
    """Linear Qm.n quantizer, eqs. (1)-(2), for the Fig-1 comparison."""
    eps = 2.0 ** (-frac_bits)
    lo, hi = -(2.0 ** (int_bits - 1)), 2.0 ** (int_bits - 1) - eps
    return torch.clamp(torch.round(x / eps) * eps, lo, hi)


class QuantizedTensor:
    """A log-quantized tensor: int8 packed codes + fp scale (+ static cfg).

    ``layout`` is a storage hint: ``None`` means ``packed`` has the natural
    layout of ``shape``; ``"conv_taps"`` means a conv kernel pre-reshaped to
    tap-major ``[K*K, Cin_g, Cout]``; ``"lane_packed"`` means a grouped-conv
    kernel arranged into superblocks ``[n_sb, K*K, G_b*cin_lane,
    Cout//groups]`` with ``layout_meta = (G_b, cin_lane, groups)`` (see
    `kernels/log_conv2d.lane_pack_codes`).  `kernels.ops.conv2d` accepts
    all three.
    """

    def __init__(self, packed, scale, cfg: LogQuantConfig = DEFAULT,
                 shape=None, layout: str | None = None,
                 layout_meta: tuple | None = None):
        self.packed = packed
        self.scale = scale
        self.cfg = cfg
        self.shape = tuple(shape) if shape is not None else tuple(packed.shape)
        self.layout = layout
        self.layout_meta = layout_meta

    def dequantize(self, dtype=torch.bfloat16):
        if self.layout == "lane_packed":
            # layout transforms live with the kernels; import lazily so core
            # stays import-light (kernels import core at module scope)
            from repro_torch.kernels.log_conv2d import lane_unpack_codes
            g_b, cin_lane, groups = self.layout_meta
            codes = lane_unpack_codes(self.packed, self.shape, groups,
                                      g_b, cin_lane)
            return log_dequantize(codes, self.scale, self.cfg, dtype=dtype)
        out = log_dequantize(self.packed, self.scale, self.cfg, dtype=dtype)
        return out.reshape(self.shape) if self.layout == "conv_taps" else out

    def __repr__(self):
        lay = f", layout={self.layout!r}" if self.layout else ""
        return f"QuantizedTensor(shape={self.shape}, cfg={self.cfg}{lay})"


def quantize_tensor(x: torch.Tensor,
                    cfg: LogQuantConfig = DEFAULT) -> QuantizedTensor:
    packed, scale = log_quantize(x, cfg)
    return QuantizedTensor(packed, scale, cfg, x.shape)


def dequantize_tensor(q: QuantizedTensor, dtype=torch.bfloat16):
    return q.dequantize(dtype)


def quantization_snr_db(x, xq):
    """Signal-to-quantization-noise ratio in dB (used by the Fig-1 bench)."""
    x = np.asarray(torch.as_tensor(x).detach().cpu(), np.float64)
    xq = np.asarray(torch.as_tensor(xq).detach().cpu(), np.float64)
    num = np.sum(x * x)
    den = np.sum((x - xq) ** 2) + 1e-30
    return float(10.0 * np.log10(num / den + 1e-30))
