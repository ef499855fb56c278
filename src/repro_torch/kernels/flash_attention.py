"""GQA-native online-softmax attention.

Counterpart of `repro.kernels.flash_attention`.  ``flash_attention_cuda``
is the wrapper of the hand-written CUDA kernel `csrc/flash_attention.cu`,
which replaces the TPU kernel `flash_attention_pallas`: the rep = H / Hkv
query heads of each kv group are folded into the row axis so one K/V tile
serves the whole group, masks are causal, windowed, padded-kv and
``kpos < 0``, and the offsets are per batch row.  The kernel has two
variants, picked by the plain `flash_attention_geometry`: split-KV on the
CUDA cores (decode and every fp32 call; the plain model of its split and
combine is `split_kv_attention`) and bf16 tensor cores for prefill.  Its
plain version is `ref.ref_attention`, which the wrapper runs for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.
`kernels/ops.attention` dispatches between it, `ops._blockwise_attention`
and `ref_attention`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .log_conv2d import sm_count, split_tickets
from .ref import attention_mask, ref_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODE = {"split": 0, "mma": 1}
_I32_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65535
MAX_HEAD_DIM = 256
NEG_INF = -1e30
# the kernel's tiles (csrc/flash_attention.cu): the split-KV variant takes
# SPLIT_ROWS folded rows a block and SPLIT_KEYS keys a block a stage (8
# warps of 4 keys), in at most MAX_SPLITS chunks of at least MIN_SPLIT_KEYS
# keys; the tensor-core variant takes MMA_ROWS folded rows a block and
# MMA_KEYS[head_dim padded to 64, 128 or 256] keys a tile (its 8 warps take
# the tiles in two alternating groups)
SPLIT_ROWS, SPLIT_KEYS, MAX_SPLITS, MIN_SPLIT_KEYS = 8, 32, 64, 64
MMA_ROWS = 64
MMA_KEYS = {64: 64, 128: 64, 256: 32}
# the per-head kernel that the "repeat" traffic model assumes takes
# REPEAT_BLOCK_Q query rows a block unless the caller gives its own
REPEAT_BLOCK_Q = 16


def takes_mma(Tq: int, D: int, q_dtype, kv_dtype,
              aligned: bool = True) -> bool:
    """Whether a call takes the tensor-core variant: bf16 q, k and v with
    Tq > 1, D a multiple of 16 (at most 256) and 16-byte aligned rows."""
    return (q_dtype == kv_dtype == torch.bfloat16 and Tq > 1
            and D % 16 == 0 and D <= MAX_HEAD_DIM and aligned)


def flash_attention_geometry(B: int, Tq: int, Tk: int, H: int, Hkv: int,
                             D: int, q_dtype, kv_dtype, n_sm: int = 132,
                             aligned: bool = True,
                             splits: int | None = None) -> dict:
    """The launch shape of the CUDA kernel for q ``[B, Tq, H, D]`` and k, v
    ``[B, Tk, Hkv, D]`` on a card of ``n_sm`` SMs.

    bf16 q, k and v with Tq > 1, D a multiple of 16 and 16-byte aligned
    rows (``aligned``, `takes_mma`) take the tensor-core variant ``"mma"``:
    blocks of ``MMA_ROWS`` folded rows walking every key tile.  Every other
    call takes ``"split"``: blocks of ``SPLIT_ROWS`` folded rows and one
    chunk of ``keys_per_split`` keys (a multiple of ``SPLIT_KEYS``), with
    as many chunks as bring the launch nearest one block per SM, at most
    ``MAX_SPLITS`` and none shorter than ``MIN_SPLIT_KEYS`` keys unless Tk
    is: ``splits`` chunks cover the Tk keys exactly once and none is empty.
    An explicit ``splits`` replaces that count and must keep the launcher's
    contract (1 to ``MAX_SPLITS`` chunks, each of whole stages, none empty;
    1 for ``"mma"``), else ValueError naming it.
    → dict with ``variant``, ``rows`` (folded rows a block), ``keys`` (keys
    a tile or stage), ``row_blocks``, ``splits``, ``keys_per_split`` and
    ``blocks``."""
    if min(B, Tq, Tk, H, Hkv, D) < 1 or H % Hkv:
        raise ValueError(f"no attention: B={B} Tq={Tq} Tk={Tk} H={H} "
                         f"Hkv={Hkv} D={D}")
    rows = H // Hkv * Tq
    if takes_mma(Tq, D, q_dtype, kv_dtype, aligned):
        if splits not in (None, 1):
            raise ValueError(f"splits={splits!r}: the tensor-core variant "
                             f"takes 1")
        n_rb = -(-rows // MMA_ROWS)
        dp = next(n for n in (64, 128, 256) if D <= n)
        return {"variant": "mma", "rows": MMA_ROWS, "keys": MMA_KEYS[dp],
                "row_blocks": n_rb, "splits": 1, "keys_per_split": Tk,
                "blocks": B * Hkv * n_rb}
    n_rb = -(-rows // SPLIT_ROWS)
    tiles = B * Hkv * n_rb
    stages = -(-Tk // SPLIT_KEYS)
    if splits is not None:
        if not isinstance(splits, int) or \
                not 1 <= splits <= min(MAX_SPLITS, stages):
            raise ValueError(f"splits={splits!r}: 1 to "
                             f"{min(MAX_SPLITS, stages)} chunks of {Tk} keys")
        kps = -(-stages // splits) * SPLIT_KEYS
        if -(-Tk // kps) != splits:
            raise ValueError(f"splits={splits}: chunks of {kps} keys cover "
                             f"{Tk} keys in {-(-Tk // kps)}, so one would "
                             f"be empty")
    else:
        splits = max(1, min(MAX_SPLITS, -(-n_sm // tiles),
                            Tk // MIN_SPLIT_KEYS))
        kps = -(-stages // splits) * SPLIT_KEYS
        splits = -(-Tk // kps)
    return {"variant": "split", "rows": SPLIT_ROWS, "keys": SPLIT_KEYS,
            "row_blocks": n_rb, "splits": splits, "keys_per_split": kps,
            "blocks": tiles * splits}


def _aligned16(t: torch.Tensor) -> bool:
    """Rows of ``t`` start on 16-byte boundaries (for 16-byte copies)."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st * es % 16 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
        if n > 1)


def _kernel_fn():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                       + [ctypes.c_float] + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _offset_arg(off, B: int, device):
    """An offset as the kernel takes it: ``(tensor, value, kind, step)``.
    An int is passed by value (kind 0); an int32 or int64 tensor with one
    value or one per batch row is read in place on the device (kind 1 or 2,
    element b * step), so decode at per-row positions launches no kernel to
    build its offsets and never synchronises.  Other integer dtypes are
    converted to int64 first."""
    if not isinstance(off, torch.Tensor):
        if not -2 ** 31 <= int(off) < 2 ** 31:
            raise ValueError(f"offset {off} outside int32")
        return None, int(off), 0, 0
    off = off.to(device)
    if off.dtype not in (torch.int32, torch.int64):
        off = off.to(torch.int64)
    if off.dim() != 1:
        off = off.reshape(-1)
    if off.numel() not in (1, B):
        raise ValueError(f"an offset tensor has one value or one per "
                         f"batch row ({B}), got {off.numel()}")
    step = off.stride(0) if off.numel() > 1 else 0
    return off, 0, 1 if off.dtype == torch.int32 else 2, step


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None,
                         scale=None, q_offset=0, k_offset=0, config=None):
    """q: [B, Tq, H, D]; k, v: [B, Tk, Hkv, D] with H a multiple of Hkv and
    D ≤ 256 → o [B, Tq, H, D] in q's dtype, on the CUDA kernel.

    q, k and v are fp32 or bf16, each read in its own dtype (the engine's
    decode has a bf16 q and an fp32 cache) with unit stride along D.
    `q_offset` / `k_offset` are the absolute positions of q[:, 0] and
    k[:, 0]: an int, or an int tensor ``[B]`` with one per batch row.
    `flash_attention_geometry` picks the variant: split-KV on the CUDA
    cores (every call with fp32 keys and values, an fp32 q, or Tq = 1), or
    bf16 tensor cores (bf16 q, k and v in prefill); ``config`` (a mapping,
    or None) may give the split variant's ``splits``, checked against the
    launcher's contract on every device.  A call whose keys are
    split gets an fp32 scratch for the partials and a ticket a row block
    from the per-device `split_tickets`.  Either way one launch, and the
    same inputs give the same bits.

    A CUDA tensor launches the kernel (and adds one to
    ``flash_attention_cuda.launches``) or raises; a CPU tensor runs the
    plain `ref_attention`.  Grad guard: with grad mode on, an input that
    requires grad raises on every device (`_build.refuse_grad`), since the
    kernel's output has no backward."""
    _build.refuse_grad("flash_attention_cuda", q, k, v)
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
    splits = (config or {}).get("splits")
    if q.device.type == "cpu":
        if splits is not None:
            flash_attention_geometry(B, Tq, Tk, H, Hkv, D, q.dtype, k.dtype,
                                     aligned=_aligned16(q) and _aligned16(k)
                                     and _aligned16(v), splits=splits)
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
    if min(B, Tq, Tk) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if B * Hkv > _GRID_YZ_MAX or H * Tq > _I32_MAX // MAX_HEAD_DIM \
            or Tk > _I32_MAX - MAX_HEAD_DIM:
        raise ValueError(f"shape outside the kernel's launch grid: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    vec = _aligned16(k) and _aligned16(v)
    geo = flash_attention_geometry(B, Tq, Tk, H, Hkv, D, q.dtype, k.dtype,
                                   sm_count(q.device.index),
                                   aligned=vec and _aligned16(q),
                                   splits=splits)
    if geo["blocks"] > _I32_MAX:
        raise ValueError(f"shape outside the kernel's launch grid: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    qo, ko = (_offset_arg(x, B, q.device) for x in (q_offset, k_offset))
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    part = tickets = None
    if geo["splits"] > 1:
        tiles = B * Hkv * geo["row_blocks"]
        part = torch.empty(geo["splits"] * tiles * geo["rows"]
                           * (MAX_HEAD_DIM + 2), dtype=torch.float32,
                           device=q.device)
        tickets = split_tickets(q.device, tiles)
    scale = scale if scale is not None else 1.0 / D ** 0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = _kernel_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       ptr(qo[0]), ptr(ko[0]), ptr(part), ptr(tickets),
                       *qo[1:], *ko[1:], B, Tq, Tk, H, Hkv, D, int(causal),
                       0 if window is None else int(window), float(scale),
                       *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
                       _VARIANT_CODE[geo["variant"]], geo["row_blocks"],
                       geo["splits"], geo["keys_per_split"], int(vec), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention CUDA launch failed: cudaError "
                           f"{err}")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0  # kernel launches; chip_smoke.py resets it


# ---------------------------------------------------------------------------
# the split-KV variant's split and combine, in plain torch
# ---------------------------------------------------------------------------


def _fold(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """``[B, Tq, H, D]`` → ``[B, Hkv, rep·Tq, D]``: row r of kv group g is
    query head ``g·rep + r // Tq`` at position ``r % Tq``."""
    B, Tq, H, D = x.shape
    return (x.reshape(B, Tq, Hkv, H // Hkv, D).permute(0, 2, 3, 1, 4)
            .reshape(B, Hkv, H // Hkv * Tq, D))


def split_kv_partials(q, k, v, *, keys_per_split: int, causal=True,
                      window=None, scale=None, q_offset=0, k_offset=0):
    """Per-split online-softmax state of the split-KV variant, in fp32.

    Split s owns keys ``[s·keys_per_split, (s+1)·keys_per_split)``; rows are
    the folded rows of each kv group.  → ``(m, l, acc)`` of shapes ``[S, B,
    Hkv, R]``, ``[S, B, Hkv, R]`` and ``[S, B, Hkv, R, D]`` with R = rep·Tq:
    the split's largest unmasked score (NEG_INF where it has none), the sum
    of ``exp(s - m)`` over its unmasked keys, and that sum weighted by v.
    A split that the masks leave empty gives ``m = NEG_INF``, l = 0 and
    acc = 0."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / D ** 0.5
    f32 = torch.float32
    qf = _fold(q.to(f32) * scale, Hkv)                       # [B, Hkv, R, D]
    kf, vf = (t.to(f32).permute(0, 2, 1, 3) for t in (k, v))  # [B, Hkv, Tk, D]
    mask = attention_mask(Tq, Tk, causal=causal, window=window,
                          q_offset=q_offset, k_offset=k_offset,
                          device=q.device)                   # [B|1, Tq, Tk]
    mask = mask[:, None].expand(mask.shape[0], rep, Tq, Tk).reshape(
        mask.shape[0], 1, rep * Tq, Tk)                      # [B|1, 1, R, Tk]
    neg = torch.tensor(NEG_INF, dtype=f32, device=q.device)
    ms, ls, accs = [], [], []
    for k0 in range(0, Tk, keys_per_split):
        k1 = min(k0 + keys_per_split, Tk)
        ok = mask[..., k0:k1]
        s = torch.where(ok, qf @ kf[:, :, k0:k1].transpose(-1, -2), neg)
        m = s.amax(dim=-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(p @ vf[:, :, k0:k1])
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def split_kv_combine(m, l, acc) -> torch.Tensor:
    """Merge per-split ``(m, l, acc)`` as the kernel's last block does:
    ``M = max_s m_s``, weights ``exp(m_s - M)``, ``o = Σ w·acc / Σ w·l``
    with the sum replaced by 1 where it is 0 (a fully masked row gives 0).
    An empty split (m = NEG_INF, l = 0, acc = 0) adds exactly 0.  → fp32
    folded rows ``[B, Hkv, R, D]``."""
    M = m.amax(dim=0)
    w = torch.exp(m - M)
    L = (w * l).sum(dim=0)
    A = (w[..., None] * acc).sum(dim=0)
    return A / torch.where(L > 0, L, torch.ones((), device=L.device))[..., None]


def split_kv_attention(q, k, v, *, keys_per_split: int, causal=True,
                       window=None, scale=None, q_offset=0, k_offset=0):
    """The split-KV variant's function in plain torch: `split_kv_partials`,
    then `split_kv_combine`, unfolded to ``[B, Tq, H, D]`` in q's dtype."""
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    o = split_kv_combine(*split_kv_partials(
        q, k, v, keys_per_split=keys_per_split, causal=causal, window=window,
        scale=scale, q_offset=q_offset, k_offset=k_offset))
    return (o.reshape(B, Hkv, H // Hkv, Tq, D).permute(0, 3, 1, 2, 4)
            .reshape(B, Tq, H, D).to(q.dtype))


# ---------------------------------------------------------------------------
# the tensor-core variant's error, in plain torch
# ---------------------------------------------------------------------------

BF16_ROUNDING = 2.0 ** -8     # unit roundoff of bf16 (8 significant bits)
FP32_ROUNDING = 2.0 ** -24
EXP_ERROR = 2.0 ** -18        # ex2.approx and the rounding of its argument


def mma_error_limit(q, k, v, *, causal=True, window=None, scale=None,
                    q_offset=0, k_offset=0, z: float = 8.0):
    """(o, limit) for the tensor-core variant on bf16 q, k and v: ``o`` is
    the attention of the widened operands in fp32 and ``limit`` an
    elementwise bound on ``|o_kernel - o|``, both ``[B, Tq, H, D]`` fp32.

    The variant sums exact bf16 products in fp32 for S, rounds each p to
    bf16 for PV while l sums the unrounded p, and rounds o to bf16.  With
    u = 2^-8, A = Σ p|v| / l and R² = Σ p²v² / l² over a row's keys:
      * p rounded: each error is within u·p_j|v_j| / l, of zero mean;
        Hoeffding's bound gives z·u·R at a tail probability of
        2·exp(-z²/2) an element (worst case u·A);
      * S off by δ (fp32 sums of D terms, in the kernel and here, and the
        exponential): weights off by a factor within e^{±2δ}, so
        (e^{2δ} - 1)·A;
      * l and PV summed in fp32 over up to Tk keys: 2·Tk·2^-24·A;
      * o rounded to bf16: u·|o|, and u times the terms above.
    A row with no key gives o = 0 and limit 0, as the kernel gives 0."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / D ** 0.5
    f32 = torch.float32
    qf = q.to(f32).permute(0, 2, 1, 3)                       # [B, H, Tq, D]
    kf, vf = (t.to(f32).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))                               # [B, H, Tk, D]
    mask = attention_mask(Tq, Tk, causal=causal, window=window,
                          q_offset=q_offset, k_offset=k_offset,
                          device=q.device)[:, None]          # [B|1, 1, Tq, Tk]
    s = torch.where(mask, qf @ kf.transpose(-1, -2) * scale,
                    torch.tensor(NEG_INF, dtype=f32, device=q.device))
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    o = p @ vf
    a = p @ vf.abs()
    r = ((p * p) @ (vf * vf)).sqrt()
    dots = torch.where(mask, qf.abs() @ kf.abs().transpose(-1, -2), 0.0)
    delta = 2 * D * FP32_ROUNDING * scale * dots.amax(dim=-1, keepdim=True) \
        + EXP_ERROR
    u = BF16_ROUNDING
    limit = u * o.abs() + (1 + u) * (
        z * u * r + torch.expm1(2 * delta) * a + 2 * Tk * FP32_ROUNDING * a)
    return tuple(t.permute(0, 2, 1, 3) for t in (o, limit))


# ---------------------------------------------------------------------------
# analytic device-memory traffic
# ---------------------------------------------------------------------------


def attention_traffic_bytes(impl: str, B: int, Tq: int, Tk: int, H: int,
                            Hkv: int, D: int, *, block_q: int | None = None,
                            block_k: int | None = None,
                            itemsize: int = 4,
                            kv_itemsize: int | None = None,
                            config=None) -> dict:
    """Bytes moved between device memory and the chip for one attention
    call, per implementation (the model of `repro.kernels.flash_attention.
    attention_traffic_bytes`, with ``"cuda"`` for the GQA-native kernel).

    Counts every block fetch: K/V tiles are re-read once per q block, q and
    out move once, plus any materialisation the path needs.  ``"repeat"``
    models a dispatch that expands K/V to H heads before a per-head kernel
    of ``block_q`` rows a block (``REPEAT_BLOCK_Q`` if not given).
    For ``"cuda"`` without ``block_q`` the blocks are the kernel's, from
    `flash_attention_geometry` (with the ``splits`` of ``config`` where
    given, as the wrapper launches it): rows a block by variant, and with
    kv splits the fp32 partials, written once and read once by the
    combine, which ``"total"`` counts beside q, K/V and out.  An explicit ``block_q`` (and ``block_k``, which no route's
    bytes depend on) models a one-pass kernel of that many rows a block, as
    the JAX model does.  ``kv_itemsize`` (default ``itemsize``) is that of
    k and v where it differs from q's (decode over an fp32 cache).  Returns
    ``{"q", "kv", "out", "total"}``."""
    rep = H // Hkv
    kv_itemsize = kv_itemsize or itemsize
    q_b = B * Tq * H * D * itemsize
    out_b = q_b
    kv_arr = 2 * B * Tk * Hkv * D * kv_itemsize      # K and V as stored
    part = 0                                          # split-KV partials
    if impl == "cuda":                                # native GQA kernel
        if block_q is None:
            dt, kvdt = (torch.bfloat16 if n == 2 else torch.float32
                        for n in (itemsize, kv_itemsize))
            geo = flash_attention_geometry(
                B, Tq, Tk, H, Hkv, D, dt, kvdt,
                splits=(config or {}).get("splits"))
            block_q = geo["rows"]
            if geo["splits"] > 1:                     # (m, l, acc) a row
                part = 2 * 4 * geo["splits"] * B * Hkv * geo["row_blocks"] \
                    * block_q * (D + 2)
        n_qb = -(-rep * Tq // block_q)                # folded-row q blocks
        kv = kv_arr * n_qb
    elif impl == "repeat":                            # expand-then-stream
        n_qb = -(-Tq // (block_q or REPEAT_BLOCK_Q))  # per-head q blocks
        kv = kv_arr * rep + kv_arr * rep * n_qb       # materialise + stream
    elif impl == "blockwise":
        kv = kv_arr                                   # K/V once
    elif impl == "ref":
        # full score matrix written and read, K/V rep-expanded
        kv = kv_arr * rep + 2 * B * H * Tq * Tk * itemsize
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return {"q": int(q_b), "kv": int(kv), "out": int(out_b),
            "total": int(q_b + kv + out_b + part)}


def __getattr__(name: str):
    # `attention_key` moved to kernels/autotune.py
    if name == "attention_key":
        from .autotune import attention_key
        return attention_key
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
