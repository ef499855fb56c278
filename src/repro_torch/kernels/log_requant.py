"""Log requantization of an activation map: `relu_q`'s work, and with
``relu=False`` that of `log_q` on a signed map.

``log_requant_cuda`` is the wrapper of the hand-written CUDA kernel
`csrc/log_requant.cu`, two launches a call: a per-channel max of the
ReLU'd map (of |x| when signed), then one pass that quantizes each element
against its channel's scale and writes the dequantized value, with x's
sign when signed (and, if asked, the packed int8 codes).  It computes
`ref_log_requant` (ReLU unless signed, then `log_quantize` and
`log_dequantize`) operation for operation, so on the card the two agree
bit for bit.  Its grid comes from the plain `log_requant_geometry`, which
the CPU tests reach.  For a CPU tensor the wrapper runs `ref_log_requant`;
for a CUDA tensor it launches the kernel or raises.  `kernel_takes` says
which inputs the kernel computes; `models.cnn.relu_q` and `log_q` take the
kernel for those and the plain ops (with their straight-through backward)
for every other.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.logquant import (DEFAULT, LogQuantConfig,
                                       log_dequantize, log_quantize)
from . import _build
from .log_conv2d import sm_count

NT = 256              # threads a block (csrc/log_requant.cu: NT)
BLOCKS_PER_SM = 4     # resident at once (csrc/log_requant.cu: MIN_BLOCKS)
MAX_CHANNELS = 12288  # the max pass keeps 4 bytes a channel in 48 KB


def log_requant_geometry(rows: int, C: int, aligned: bool,
                         n_sm: int = 132) -> dict:
    """The launch shape of both passes over an ``[rows, C]`` map on a card
    of ``n_sm`` SMs: ``vec`` channels a load (4 where ``C % 4 == 0`` and the
    map is 16-byte ``aligned``, else 1) and ``blocks`` of ``NT`` threads,
    one thread a vector up to ``BLOCKS_PER_SM`` blocks an SM, and never
    fewer than one row's vectors need (the kernel's walk steps by whole
    rows)."""
    if rows < 1 or not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"no launch for a [{rows}, {C}] map")
    vec = 4 if C % 4 == 0 and aligned else 1
    vectors = C // vec
    blocks = min(-(-rows * vectors // NT), n_sm * BLOCKS_PER_SM)
    return {"vec": vec, "blocks": max(blocks, -(-vectors // NT))}


def kernel_takes(x: torch.Tensor, cfg: LogQuantConfig = DEFAULT) -> bool:
    """Whether `log_requant_cuda` computes ``relu_q(x)`` and ``log_q(x)``
    for this input (the ReLU and the signed kernels take the same ones): a
    contiguous non-empty float32 map on the card with 1 to
    ``MAX_CHANNELS`` channels last, a per-channel config the kernel
    decodes, and no gradient wanted through it."""
    return (x.device.type == "cuda" and x.dtype == torch.float32
            and x.ndim >= 2 and x.is_contiguous() and x.numel() > 0
            and x.shape[-1] <= MAX_CHANNELS and cfg.per_channel
            and 1 <= cfg.bits <= 7 and 0 <= cfg.frac_bits <= 4
            and not (torch.is_grad_enabled() and x.requires_grad))


def ref_log_requant(x: torch.Tensor, cfg: LogQuantConfig = DEFAULT,
                    codes: bool = False, relu: bool = True):
    """The plain version: ReLU (unless ``relu`` is false), then quantize and
    dequantize with a scale a channel → the map (and its packed int8 codes
    with ``codes``)."""
    packed, scale = log_quantize(torch.relu(x) if relu else x, cfg)
    y = log_dequantize(packed, scale, cfg, dtype=x.dtype)
    return (y, packed) if codes else y


# per device: the kernel's int32 workspace, a ticket and MAX_CHANNELS
# maxima, zeroed once here and left zero by every launch, so that calls on
# one device run one after another on one stream, as the port's callers do
_WORK: dict[int, torch.Tensor] = {}


def _workspace(device: torch.device) -> torch.Tensor:
    buf = _WORK.get(device.index)
    if buf is None:
        buf = torch.zeros(1 + MAX_CHANNELS, dtype=torch.int32, device=device)
        _WORK[device.index] = buf
    return buf


def _kernel_fn():
    fn = _build.load("log_requant").log_requant_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def log_requant_cuda(x: torch.Tensor, cfg: LogQuantConfig = DEFAULT,
                     codes: bool = False, relu: bool = True):
    """``relu(x)`` (``x`` itself, signed, with ``relu=False``)
    log-requantized with one scale a channel (the last axis) → a new
    float32 map of x's shape (and the packed int8 codes of the same shape
    with ``codes``).

    x: contiguous float32, at least 2-d, 1 to ``MAX_CHANNELS`` channels.
    A CUDA tensor launches the two kernels (adding two to
    ``log_requant_cuda.launches``) or raises; a CPU tensor runs the plain
    `ref_log_requant`.  Grad guard: with grad mode on, an input that
    requires grad raises on every device (`_build.refuse_grad`)."""
    _build.refuse_grad("log_requant_cuda", x)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.ndim < 2:
        raise ValueError(f"log_requant_cuda takes a contiguous float32 map "
                         f"of 2 or more axes, got {x.dtype} "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    if not cfg.per_channel or not 1 <= cfg.bits <= 7 or \
            not 0 <= cfg.frac_bits <= 4:
        raise ValueError(f"the kernel quantizes per channel with bits ≤ 7 "
                         f"and frac_bits ≤ 4, got {cfg}")
    if x.device.type == "cpu":
        return ref_log_requant(x, cfg, codes, relu)
    if x.device.type != "cuda":
        raise ValueError(f"log_requant_cuda runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    C = x.shape[-1]
    rows = x.numel() // C if C else 0
    geo = log_requant_geometry(rows, C, x.data_ptr() % 16 == 0,
                               sm_count(x.device.index))
    y = torch.empty_like(x)
    packed = (torch.empty(x.shape, dtype=torch.int8, device=x.device)
              if codes else None)
    work = _workspace(x.device)
    err = _kernel_fn()(
        x.data_ptr(), y.data_ptr(),
        packed.data_ptr() if packed is not None else None, work.data_ptr(),
        rows, C, cfg.bits, cfg.frac_bits, geo["vec"], geo["blocks"],
        int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        work.zero_()   # a refused second launch leaves maxima behind
        raise RuntimeError(f"log_requant CUDA launch failed: cudaError {err}")
    log_requant_cuda.launches += 2
    return (y, packed) if codes else y


log_requant_cuda.launches = 0  # kernel launches; chip_smoke.py resets it
