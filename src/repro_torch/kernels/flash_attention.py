"""GQA-native online-softmax attention.

Counterpart of `repro.kernels.flash_attention`.  ``flash_attention_cuda``
is the wrapper of the hand-written CUDA kernel `csrc/flash_attention.cu`,
which replaces the TPU kernel `flash_attention_pallas`: the rep = H / Hkv
query heads of each kv group are folded into the row axis so one K/V tile
serves the whole group, masks are causal, windowed, padded-kv and
``kpos < 0``, and the offsets are per batch row.  Its plain version is
`ref.ref_attention`, which the wrapper runs for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.  `kernels/ops.attention`
dispatches between it, `ops._blockwise_attention` and `ref_attention`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ref_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q, BLOCK_K, MAX_HEAD_DIM = 16, 32, 256  # the kernel's tiles (csrc)


def _kernel_fn():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _row_offsets(off, B: int, device) -> torch.Tensor:
    """An int, or an int tensor with one value or one per batch row →
    int32 ``[B]`` on ``device`` (an int is filled on the device: no copy
    from the host, no synchronisation)."""
    if isinstance(off, torch.Tensor):
        off = off.to(device=device, dtype=torch.int32).reshape(-1)
        if off.numel() == 1:
            return off.expand(B)
        if off.numel() != B:
            raise ValueError(f"an offset tensor has one value or one per "
                             f"batch row ({B}), got {off.numel()}")
        return off
    return torch.full((B,), int(off), dtype=torch.int32, device=device)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None,
                         scale=None, q_offset=0, k_offset=0):
    """q: [B, Tq, H, D]; k, v: [B, Tk, Hkv, D] with H a multiple of Hkv and
    D ≤ 256 → o [B, Tq, H, D] in q's dtype, on the CUDA kernel.

    q, k and v are fp32 or bf16, each read in its own dtype (the engine's
    decode has a bf16 q and an fp32 cache) with unit stride along D.
    `q_offset` / `k_offset` are the absolute positions of q[:, 0] and
    k[:, 0]: an int, or an int tensor ``[B]`` with one per batch row.

    A CUDA tensor launches the kernel (and adds one to
    ``flash_attention_cuda.launches``) or raises; a CPU tensor runs the
    plain `ref_attention`."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"inconsistent attention operands: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"GQA requires query heads divisible by kv heads; "
                         f"got H={H} query heads vs Hkv={Hkv} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset,
                             k_offset=k_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE \
            or v.dtype != k.dtype:
        raise ValueError(f"the kernel takes fp32 or bf16 q and k = v dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} outside the kernel's 1..256")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need unit stride along head_dim")
    if min(B, Tq, Tk) < 1 or B > 65535 or Hkv > 65535:
        raise ValueError(f"shape outside the kernel's launch grid: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    offs = torch.stack([_row_offsets(q_offset, B, q.device),
                        _row_offsets(k_offset, B, q.device)], 1).contiguous()
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    scale = scale if scale is not None else 1.0 / D ** 0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       offs.data_ptr(), B, Tq, Tk, H, Hkv, D, int(causal),
                       0 if window is None else int(window), float(scale),
                       *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention CUDA launch failed: cudaError "
                           f"{err}")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0  # kernel launches; chip_smoke.py resets it


# ---------------------------------------------------------------------------
# analytic device-memory traffic
# ---------------------------------------------------------------------------


def attention_traffic_bytes(impl: str, B: int, Tq: int, Tk: int, H: int,
                            Hkv: int, D: int, *, block_q: int = BLOCK_Q,
                            block_k: int = BLOCK_K, itemsize: int = 4) -> dict:
    """Bytes moved between device memory and the chip for one attention
    call, per implementation (the model of `repro.kernels.flash_attention.
    attention_traffic_bytes`, with ``"cuda"`` for the GQA-native kernel).

    Counts every block fetch: K/V tiles are re-read once per q block, q and
    out move once, plus any materialisation the path needs.  ``"repeat"``
    models a dispatch that expands K/V to H heads before a per-head kernel.
    The defaults are the CUDA kernel's tiles.  Returns ``{"q", "kv", "out",
    "total"}``."""
    rep = H // Hkv
    q_b = B * Tq * H * D * itemsize
    out_b = q_b
    kv_arr = 2 * B * Tk * Hkv * D * itemsize         # K and V as stored
    if impl == "cuda":                                # native GQA kernel
        n_qb = -(-rep * Tq // block_q)                # folded-row q blocks
        kv = kv_arr * n_qb
    elif impl == "repeat":                            # expand-then-stream
        n_qb = -(-Tq // block_q)                      # per-head q blocks
        kv = kv_arr * rep + kv_arr * rep * n_qb       # materialise + stream
    elif impl == "blockwise":
        kv = kv_arr                                   # K/V once
    elif impl == "ref":
        # full score matrix written and read, K/V rep-expanded
        kv = kv_arr * rep + 2 * B * H * Tq * Tk * itemsize
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return {"q": int(q_b), "kv": int(kv), "out": int(out_b),
            "total": int(q_b + kv + out_b)}
