"""RWKV6 (Finch) WKV with data-dependent decay.

Counterpart of `repro.kernels.wkv6`.  ``wkv6_cuda`` is the wrapper of the
hand-written CUDA kernel `csrc/wkv6.cu`, which replaces the TPU kernel
`wkv6_pallas`.  It computes

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    o_t = r_t (S_{t-1} + diag(u) k_t v_tᵀ)

in one launch of one of two variants, which ``wkv6_geometry`` picks with
the column tile of a block: for T ≤ ``DECODE_MAX_T`` several threads a
column run the recurrence; for longer T an exact chunked form walks chunks
of ``CHUNK`` tokens in sub-chunks of ``SUB_CHUNK``, with every decay factor
an exponential of a non-positive number, so it is finite for every
``logw ≤ 0`` and takes any T, T = 1 included, with no padding.  Its plain
version is `ref.ref_wkv6`, which the wrapper runs for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.

``wkv6_chunked`` is the JAX package's chunked closed form
(`wkv6_chunked_jnp` over `_chunk_math`), kept with the same math so that
the CPU tests compare like with like.  Its exp factorisation overflows in
fp32 once a chunk's cumulative log decay falls below about −88 (at
``logw = −3`` over a chunk of 64, for example), and the output is then NaN;
the JAX version does the same.  `kernels/ops.wkv6` dispatches between the
three.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .ref import ref_wkv6

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_K = 64       # the kernel's rows are padded to 16, 32 or 64
MAX_HEAD_V = 1024     # columns of a head, in tiles of TILES a block
TILES = (16, 32, 64)  # column tiles of a block (csrc/wkv6.cu: MAX_TILE)
TARGET_BLOCKS = 256   # two blocks per SM of the H100's 132
DECODE_MAX_T = 4      # longer calls take the chunked variant
CHUNK = 32            # tokens a cp.async stage of the chunked variant
SUB_CHUNK = 16        # tokens a sub-chunk: pairs inside it decay directly
CHUNKED_THREADS = 256
_VARIANT_CODE = {"decode": 0, "chunked": 1}


def wkv6_geometry(B: int, T: int, H: int, K: int, V: int) -> dict:
    """The launch shape of the CUDA kernel for r ``[B, T, H, K]`` and v
    ``[B, T, H, V]``.

    The tile is the narrowest of ``TILES`` that holds V (64 for wider V),
    halved while the grid of ``B·H·ceil(V/tile)`` blocks is below
    ``TARGET_BLOCKS`` and the tile is wider than 16 columns; ``tiles``
    tiles cover the V columns exactly once.  Rows are padded to ``kmax`` in
    {16, 32, 64}.  T ≤ ``DECODE_MAX_T`` takes ``"decode"``: a thread owns 4
    rows × 4 columns, so ``kmax / 4`` threads share a column.  Longer T
    takes ``"chunked"``: ``CHUNKED_THREADS`` threads, chunks of ``chunk``
    tokens in sub-chunks of ``sub_chunk``; the state's rows × 4 columns
    are held by the first threads, 2 rows a thread (4 at the widest tile
    and K > 32).  → dict with ``variant``, ``tile``, ``tiles``, ``blocks``,
    ``threads``, ``threads_per_column``, ``rows_per_thread``, ``kmax``,
    ``chunk`` and ``sub_chunk`` (None for decode)."""
    if min(B, T, H, K, V) < 1 or K > MAX_HEAD_K or V > MAX_HEAD_V:
        raise ValueError(f"no wkv6 launch for B={B} T={T} H={H} K={K} V={V}"
                         f" (K ≤ {MAX_HEAD_K}, V ≤ {MAX_HEAD_V})")
    kmax = next(n for n in (16, 32, 64) if K <= n)
    tile = next((n for n in TILES if V <= n), TILES[-1])
    while tile > TILES[0] and B * H * -(-V // tile) < TARGET_BLOCKS:
        tile //= 2
    tiles = -(-V // tile)
    geo = {"tile": tile, "tiles": tiles, "blocks": B * H * tiles,
           "kmax": kmax}
    if T <= DECODE_MAX_T:
        return {"variant": "decode", **geo,
                "threads": tile // 4 * (kmax // 4),
                "threads_per_column": kmax // 4, "rows_per_thread": 4,
                "chunk": None, "sub_chunk": None}
    quads = kmax * tile // 4
    rows = quads // CHUNKED_THREADS if quads >= 2 * CHUNKED_THREADS else 2
    return {"variant": "chunked", **geo, "threads": CHUNKED_THREADS,
            "threads_per_column": kmax // rows, "rows_per_thread": rows,
            "chunk": CHUNK, "sub_chunk": SUB_CHUNK}


def _chunk_math(r, k, v, logw, u, S0):
    """One chunk of the closed form of `repro.kernels.wkv6._chunk_math`,
    batched over the leading axes.  All inputs fp32.

    r, k, logw: [..., L, K]; v: [..., L, V]; u: [..., K] (broadcast);
    S0: [..., K, V] → (o [..., L, V], S_L [..., K, V])."""
    L = r.shape[-2]
    p = torch.cumsum(logw, dim=-2)                      # P̃_t
    p_prev = p - logw                                   # P̃_{t-1}
    q_t = r * torch.exp(p_prev)
    k_t = k * torch.exp(-p)
    a = q_t @ k_t.transpose(-1, -2)                     # [..., L, L]
    strict = torch.ones((L, L), dtype=torch.bool, device=r.device).tril(-1)
    a = torch.where(strict, a, torch.zeros((), device=r.device))
    o = a @ v
    o = o + torch.sum(r * (u[..., None, :] * k), dim=-1, keepdim=True) * v
    o = o + q_t @ S0
    pL = p[..., -1:, :]                                 # [..., 1, K]
    k_hat = k * torch.exp(pL - p)
    S = torch.exp(pL).transpose(-1, -2) * S0 + k_hat.transpose(-1, -2) @ v
    return o, S


def wkv6_chunked(r, k, v, logw, u, state=None, *, chunk: int = 64):
    """The chunked plain version (`wkv6_chunked_jnp`): r, k, logw
    [B, T, H, K]; v [B, T, H, V]; u [H, K]; state [B, H, K, V] or None →
    (o [B, T, H, V] in r's dtype, S_T [B, H, K, V] fp32).  T is padded to
    a multiple of ``chunk`` with ``logw = 0`` and ``k = 0`` (identity
    updates)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    S = (torch.zeros((B, H, K, V), dtype=f32, device=r.device)
         if state is None else state.to(f32))
    pt = (-T) % chunk

    def bhtx(a):  # [B, T, H, X] → [B, H, Tp, X] in fp32, zero-padded in T
        return F.pad(a.to(f32), (0, 0, 0, 0, 0, pt)).transpose(1, 2)

    rp, kp, vp, wp = (bhtx(a) for a in (r, k, v, logw))
    uf = u.to(f32)[None]                                # [1, H, K]
    outs = []
    for c0 in range(0, T + pt, chunk):
        sl = slice(c0, c0 + chunk)
        o, S = _chunk_math(rp[:, :, sl], kp[:, :, sl], vp[:, :, sl],
                           wp[:, :, sl], uf, S)
        outs.append(o)
    o = torch.cat(outs, dim=2)[:, :, :T]
    return o.transpose(1, 2).to(r.dtype), S


def _kernel_fn():
    fn = _build.load("wkv6").wkv6_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def wkv6_cuda(r, k, v, logw, u, state=None):
    """r, k, logw: [B, T, H, K]; v: [B, T, H, V]; u: [H, K]; state
    [B, H, K, V] or None (zeros) → (o [B, T, H, V] in r's dtype,
    S_T [B, H, K, V] fp32), on the CUDA kernel in the variant and tile of
    `wkv6_geometry`.

    r, k and v share one dtype, fp32 or bf16; logw is fp32 or bf16; each is
    read in its own dtype and the sums are fp32.  u and the state are fp32.
    All are contiguous.  K ≤ 64 and V ≤ 1024; any T ≥ 1.

    A CUDA tensor launches the kernel (and adds one to
    ``wkv6_cuda.launches``) or raises; a CPU tensor runs the plain
    `ref_wkv6`."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    if k.shape != r.shape or logw.shape != r.shape \
            or v.shape[:3] != (B, T, H) or v.ndim != 4 \
            or tuple(u.shape) != (H, K):
        raise ValueError(f"inconsistent wkv6 operands: r {tuple(r.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}")
    if state is not None and tuple(state.shape) != (B, H, K, V):
        raise ValueError(f"state {tuple(state.shape)} for (B, H, K, V) = "
                         f"{(B, H, K, V)}")
    devs = {t.device for t in (r, k, v, logw, u)
            + (() if state is None else (state,))}
    if len(devs) != 1:
        raise ValueError(f"wkv6 operands on several devices: {devs}")
    if r.device.type == "cpu":
        o, S = ref_wkv6(r, k, v, logw, u, state)
        return o.to(r.dtype), S
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_cuda runs on CUDA or CPU tensors, got "
                         f"{r.device}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype \
            or v.dtype != r.dtype or logw.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes r, k, v of one dtype (fp32 or "
                         f"bf16) and fp32 or bf16 logw, got {r.dtype}, "
                         f"{k.dtype}, {v.dtype}, {logw.dtype}")
    if u.dtype != torch.float32 or (state is not None
                                    and state.dtype != torch.float32):
        raise ValueError(f"the kernel takes fp32 u and state, got {u.dtype}"
                         f" and {None if state is None else state.dtype}")
    if not all(t.is_contiguous() for t in (r, k, v, logw, u)) or (
            state is not None and not state.is_contiguous()):
        raise ValueError("wkv6_cuda takes contiguous operands")
    if not 1 <= K <= MAX_HEAD_K or not 1 <= V <= MAX_HEAD_V:
        raise ValueError(f"head sizes K={K}, V={V} outside the kernel's "
                         f"1..{MAX_HEAD_K} and 1..{MAX_HEAD_V}")
    if min(B, T, H) < 1:
        raise ValueError(f"shape outside the kernel's launch grid: r "
                         f"{tuple(r.shape)}")
    geo = wkv6_geometry(B, T, H, K, V)
    if geo["blocks"] > 2 ** 31 - 1:
        raise ValueError(f"shape outside the kernel's launch grid: r "
                         f"{tuple(r.shape)}, {geo['blocks']} blocks")
    o = torch.empty((B, T, H, V), dtype=r.dtype, device=r.device)
    s_out = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _kernel_fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       logw.data_ptr(), u.data_ptr(),
                       None if state is None else state.data_ptr(),
                       o.data_ptr(), s_out.data_ptr(), B, T, H, K, V,
                       _DTYPE_CODE[r.dtype], _DTYPE_CODE[logw.dtype],
                       _VARIANT_CODE[geo["variant"]], geo["tile"], CHUNK,
                       SUB_CHUNK, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 CUDA launch failed: cudaError {err}")
    wkv6_cuda.launches += 1
    return o, s_out


wkv6_cuda.launches = 0  # kernel launches; chip_smoke.py resets it


def wkv6_work(r, v, logw, state_given: bool = True) -> tuple[int, int]:
    """(bytes, FLOP) one call needs: r, k, logw and v read once in their
    dtypes, u and the initial state read once, o and S_T written once; 7
    FLOP per (t, i, j) of the recurrence (k·v, u·kv, S + ·, r · and its
    sum, w · S + kv) and one exp per (t, i)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    it = r.element_size()
    nbytes = (2 * B * T * H * K * it + B * T * H * K * logw.element_size()
              + 2 * B * T * H * V * it + H * K * 4
              + (2 if state_given else 1) * B * H * K * V * 4)
    return nbytes, 7 * B * T * H * K * V + B * T * H * K
