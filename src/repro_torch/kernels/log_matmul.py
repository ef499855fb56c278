"""Matmul against packed 6-bit(+sign) log-quantized weights.

Counterpart of `repro.kernels.log_matmul`.  ``log_matmul_cuda`` is the
wrapper of the hand-written CUDA kernel `csrc/log_matmul.cu`, which
replaces the TPU kernel `log_matmul_pallas`: it reads the int8 codes as
stored, decodes eq. (8) from a table next to the multiply-adds, sums in
fp32 and applies the per-column scale in the epilogue.  Its launch shape
(rows and columns per block, shares of K) comes from the plain function
`log_matmul_geometry`, and the rows of each launch (one launch, or
chunks of whole row tiles at an im2col conv's M) from
`log_matmul_row_chunks`: both are plain functions, which the CPU tests
reach.  Its plain version is
`ref.ref_log_matmul` (decode, then an fp32 `torch.matmul`), which the
wrapper runs for a CPU tensor; for a CUDA tensor it launches the kernel or
raises.  `kernels/ops.log_matmul` dispatches between the two.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.logquant import LogQuantConfig
from . import _build
from .log_conv2d import DEFAULT_CFG, _scale_vector, sm_count, split_tickets
from .ref import ref_log_matmul

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_I32_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65535
# the kernel's tile: BN columns per block; K is walked in stages of
# STAGE_ROWS[bm] rows (csrc/log_matmul.cu: BN, stage_rows)
BN = 128
STAGE_ROWS = {4: 128, 8: 64}


def log_matmul_geometry(M: int, K: int, N: int, n_sm: int = 132) -> dict:
    """The launch shape of the CUDA kernel for an ``[M, K] @ [K, N]``
    product on a card of ``n_sm`` SMs.

    A block owns ``bm`` rows (4, or 8 when M > 4), ``BN`` columns and one
    share of ``k_per_split`` rows of K (a multiple of ``STAGE_ROWS[bm]``).  The
    number of shares is the one that brings the launch nearest to two
    blocks per SM, and at most one share per stage of K: ``splits`` shares
    of ``k_per_split`` rows cover K exactly and none is empty.  → dict with
    ``bm``, ``bn``, ``m_tiles``, ``n_tiles``, ``splits``, ``k_per_split``
    and ``blocks``."""
    if min(M, K, N) < 1:
        raise ValueError(f"empty product: M={M}, K={K}, N={N}")
    bm = 4 if M <= 4 else 8
    m_tiles, n_tiles = -(-M // bm), -(-N // BN)
    stages = -(-K // STAGE_ROWS[bm])
    splits = min(stages, max(1, round(2 * n_sm / (m_tiles * n_tiles))))
    k_per_split = -(-stages // splits) * STAGE_ROWS[bm]
    splits = -(-K // k_per_split)
    return {"bm": bm, "bn": BN, "m_tiles": m_tiles, "n_tiles": n_tiles,
            "splits": splits, "k_per_split": k_per_split,
            "blocks": m_tiles * n_tiles * splits}


def log_matmul_row_chunks(M: int, K: int, N: int,
                          n_sm: int = 132) -> list[tuple[int, int]]:
    """The rows ``[r0, r1)`` of each launch of an ``[M, K] @ [K, N]``
    product.  The kernel's grid holds its row tiles on grid y, at most
    ``_GRID_YZ_MAX`` of them, so a product of more rows (an im2col conv:
    M = B·Ho·Wo, above 524,280 rows at 8 rows a tile) is cut into the
    fewest launches of near-equal whole row tiles; below that it is one
    launch.  Each chunk keeps ``bm`` = 8 and, at such M, one share of K."""
    bm = log_matmul_geometry(M, K, N, n_sm)["bm"]
    tiles = -(-M // bm)
    per = -(-tiles // -(-tiles // _GRID_YZ_MAX)) * bm
    return [(r0, min(M, r0 + per)) for r0 in range(0, M, per)]


def _kernel_fn():
    fn = _build.load("log_matmul").log_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def log_matmul_cuda(x, packed, scale, cfg: LogQuantConfig = DEFAULT_CFG,
                    out_dtype=None):
    """``(x [M, K] @ dec(packed [K, N])) · scale`` → ``[M, N]`` in
    ``out_dtype`` (default ``x.dtype``) on the CUDA kernel.

    x: contiguous fp32 or bf16.  packed: contiguous int8 codes; a slice
    ``codes[r]`` of a contiguous stacked ``[n_rep, K, N]`` leaf is
    contiguous and is read in place, never copied.  scale: scalar or
    per-column (``[1, N]`` or ``[N]``).

    Any M up to 2^31 - 1: the LM layers' decode rows (M ≤ 16) and the
    im2col conv's patch rows (M = B·Ho·Wo, 401,408 for VGG-16's first
    convs at batch 8 and 224 px) alike.  Above ``_GRID_YZ_MAX`` row tiles
    the rows are cut into chunks (`log_matmul_row_chunks`), one launch
    each, each counted.

    A CUDA tensor launches the kernel (and adds one to
    ``log_matmul_cuda.launches`` a launch) or raises; a CPU tensor runs
    the plain `ref_log_matmul`.  Grad guard: with grad mode on, an input
    that requires grad raises on every device (`_build.refuse_grad`),
    since the kernel's output has no backward."""
    _build.refuse_grad("log_matmul_cuda", x, scale)
    if x.ndim != 2 or packed.ndim != 2 or x.shape[1] != packed.shape[0]:
        raise ValueError(f"log_matmul_cuda takes x [M, K] and codes [K, N], "
                         f"got {tuple(x.shape)} and {tuple(packed.shape)}")
    if packed.dtype != torch.int8 or not packed.is_contiguous():
        raise ValueError(f"log_matmul_cuda takes contiguous int8 codes, got "
                         f"{packed.dtype} contiguous={packed.is_contiguous()}")
    if x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"log_matmul_cuda takes contiguous fp32 or bf16 "
                         f"activations, got {x.dtype} "
                         f"contiguous={x.is_contiguous()}")
    if packed.device != x.device:
        raise ValueError(f"x on {x.device} but codes on {packed.device}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"output dtype {out_dtype} for {x.dtype} "
                         f"activations: the kernel writes x.dtype or fp32")
    (M, K), N = x.shape, packed.shape[1]
    scale = _scale_vector(scale, N, x.device)

    if x.device.type == "cpu":
        return ref_log_matmul(x, packed, scale.reshape(1, N), cfg,
                              out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"log_matmul_cuda runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if cfg.frac_bits not in (0, 1) or not 1 <= cfg.bits <= 7:
        raise ValueError(f"the CUDA kernel decodes bits ≤ 7 and frac_bits "
                         f"∈ {{0, 1}}, got {cfg}")
    if min(M, K, N) < 1:
        raise ValueError(f"empty product: x {tuple(x.shape)}, codes "
                         f"{tuple(packed.shape)}")
    if max(M, N) > _I32_MAX or K > _I32_MAX - 4 * STAGE_ROWS[4]:
        raise ValueError("shape too large for the kernel's indices")
    n_sm = sm_count(x.device.index)
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for r0, r1 in log_matmul_row_chunks(M, K, N, n_sm):
        geo = log_matmul_geometry(r1 - r0, K, N, n_sm)
        part = tickets = None
        if geo["splits"] > 1:
            part = torch.empty((geo["splits"], r1 - r0, N),
                               dtype=torch.float32, device=x.device)
            tickets = split_tickets(x.device,
                                    geo["m_tiles"] * geo["n_tiles"])
        err = _kernel_fn()(
            x[r0:r1].data_ptr(), packed.data_ptr(), scale.data_ptr(),
            y[r0:r1].data_ptr(),
            part.data_ptr() if part is not None else None,
            tickets.data_ptr() if tickets is not None else None,
            r1 - r0, K, N, cfg.bits, cfg.frac_bits, _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[out_dtype], geo["bm"], geo["k_per_split"],
            geo["splits"], stream)
        if err != 0:
            raise RuntimeError(f"log_matmul CUDA launch failed: cudaError "
                               f"{err}")
        log_matmul_cuda.launches += 1
    return y


log_matmul_cuda.launches = 0  # kernel launches; chip_smoke.py resets it
