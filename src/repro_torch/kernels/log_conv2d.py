"""NHWC conv2d against packed 6-bit(+sign) log-quantized weights.

Counterpart of `repro.kernels.log_conv2d`.  Three implementations share one
contract (`kernels/ops.conv2d` dispatches between them):

  * ``log_conv2d_fused`` — the wrapper of the hand-written CUDA kernel
    `csrc/log_conv2d.cu`, which replaces the TPU kernel
    `log_conv2d_fused_pallas`.  It reads the int8 codes as stored (natural
    HWIO or lane-packed), decodes them next to the tensor cores into two
    exact bf16 planes (`plane_table`), multiplies them with x split into
    three bf16 pieces that sum to x exactly, sums in fp32 and applies √2
    and the per-channel scale in the epilogue.  Its launch shape (tile, shares of the reduction)
    comes from the plain `log_conv2d_geometry`.  On a CPU tensor it runs
    the plain `log_conv2d_blockwise` instead; on a CUDA tensor it launches
    the kernel or raises.
  * ``log_conv2d_blockwise`` — decode, then `F.conv2d(groups=)`, converting
    NHWC ↔ NCHW only at the boundary.
  * ``log_conv2d_ref`` — explicit im2col patches × `ref.ref_log_matmul`.
    Independent of `F.conv2d`, so it cross-checks the patch extraction.

All take ``packed [K, K, Cin//groups, Cout]`` int8 codes with a
per-output-channel (or scalar) fp scale, `stride`, `padding`
("SAME"/"VALID"/int/explicit pairs, XLA's SAME convention) and `groups`.
`conv_traffic_bytes` models the bytes each implementation moves, for the
kernel-dispatch profiler and the autotuner; `conv_key`, a conv's shape key,
lives in `kernels/autotune.py` and is re-exported here.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.logquant import LogQuantConfig
from . import _build
from .ref import ref_log_matmul

DEFAULT_CFG = LogQuantConfig()


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------


def _pad_pair(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA-style SAME padding for one spatial dim (low side gets total//2)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def normalize_padding(padding, K: int, stride: int, H: int, W: int):
    """→ ((lo_h, hi_h), (lo_w, hi_w)), accepting SAME/VALID/int/pairs."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return (0, 0), (0, 0)
        if p == "SAME":
            return _pad_pair(H, K, stride), _pad_pair(W, K, stride)
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (ph, pw) = padding
    if isinstance(ph, int):
        return (ph, ph), (pw, pw)
    return tuple(ph), tuple(pw)


def _out_size(size: int, k: int, stride: int, pads: tuple[int, int]) -> int:
    return (size + pads[0] + pads[1] - k) // stride + 1


def _pad_nhwc(x, pads):
    (ph0, ph1), (pw0, pw1) = pads
    return F.pad(x, (0, 0, pw0, pw1, ph0, ph1))


def _im2col(x, K: int, stride: int, pads):
    """x: [B, H, W, C] → patches [B, Ho, Wo, K*K*C], tap-major (kh, kw, c),
    the order of ``w.reshape(K*K*Cin, Cout)`` for an HWIO kernel."""
    B, H, W, C = x.shape
    xp = _pad_nhwc(x, pads)
    Ho = _out_size(H, K, stride, pads[0])
    Wo = _out_size(W, K, stride, pads[1])
    taps = [xp[:, kh:kh + (Ho - 1) * stride + 1:stride,
               kw:kw + (Wo - 1) * stride + 1:stride, :]
            for kh in range(K) for kw in range(K)]
    patches = torch.stack(taps, dim=3)            # [B, Ho, Wo, K*K, C]
    return patches.reshape(B, Ho, Wo, K * K * C), Ho, Wo


def _block_diag_codes(packed, groups: int):
    """packed [K, K, cin_g, Cout] → [K*K*(groups·cin_g), Cout] block-diagonal
    int8 codes: row (tap, g, i) holds the codes of group g's output channels
    and the zero code (int8 0, which decodes to 0.0) everywhere else."""
    K1, K2, cin_g, Cout = packed.shape
    cout_g = Cout // groups
    taps = K1 * K2
    w = packed.reshape(taps, cin_g, Cout)
    if groups == 1:
        return w.reshape(taps * cin_g, Cout)
    group_of_out = torch.arange(Cout, device=packed.device) // cout_g
    in_group = (group_of_out[None, :]
                == torch.arange(groups, device=packed.device)[:, None])
    wbd = w[:, None, :, :] * in_group[None, :, None, :].to(packed.dtype)
    return wbd.reshape(taps * groups * cin_g, Cout)


def _check_shapes(x, packed, groups):
    if x.ndim != 4 or packed.ndim != 4:
        raise ValueError(f"expected x [B,H,W,C] and codes [K,K,Cin_g,Cout], "
                         f"got {tuple(x.shape)} and {tuple(packed.shape)}")
    B, H, W, C = x.shape
    K1, K2, cin_g, Cout = packed.shape
    if K1 != K2:
        raise ValueError(f"square kernels only, got {K1}x{K2}")
    if C != cin_g * groups or Cout % groups:
        raise ValueError(f"x {tuple(x.shape)} and codes {tuple(packed.shape)} "
                         f"do not fit groups={groups}")
    return B, H, W, C, K1, Cout


def _scale_vector(scale, Cout: int, device) -> torch.Tensor:
    """A scalar or per-channel scale of any shape → contiguous fp32 [Cout]."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(-1)
    return s.expand(Cout).contiguous()


@functools.lru_cache(maxsize=16)
def _decode_tables(cfg: LogQuantConfig, device: torch.device):
    """LUT[j] = 2^(j/steps) and 2^-e, exact in fp32; made once per device
    (a host-to-device copy per call would stall the stream)."""
    lut = torch.tensor([2.0 ** (j / cfg.steps) for j in range(cfg.steps)],
                       dtype=torch.float32, device=device)
    pow2 = torch.tensor([2.0 ** -e for e in range(cfg.bias + 1)],
                        dtype=torch.float32, device=device)
    return lut, pow2


def decode_codes(packed: torch.Tensor,
                 cfg: LogQuantConfig = DEFAULT_CFG) -> torch.Tensor:
    """Eq. (8): packed int8 → fp32, ``sign · LUT[c & (steps-1)] ·
    2^(c >> frac_bits)`` with c the unbiased code and LUT[j] = 2^(j/steps).

    Every factor is exact in fp32 (a LUT entry times a power of two), so
    this is the decode the CUDA kernel reproduces bit for bit.  The zero
    code decodes to +0.0."""
    p = packed.to(torch.int32)
    biased = p & ((1 << cfg.bits) - 1)
    code = biased - cfg.bias                     # ∈ [-bias, 0]
    lut, pow2 = _decode_tables(cfg, packed.device)
    mag = lut[code & (cfg.steps - 1)] * pow2[-(code >> cfg.frac_bits)]
    sign = 1 - 2 * ((p >> cfg.bits) & 1)
    return torch.where(biased != cfg.zero_code, sign * mag,
                       torch.zeros_like(mag))


def conv_nhwc(x, w_hwio, *, stride: int, pads, groups: int = 1):
    """Float conv with NHWC activations and an HWIO kernel, explicit pads."""
    (ph0, ph1), (pw0, pw1) = pads
    xn = x.permute(0, 3, 1, 2)
    if ph0 == ph1 and pw0 == pw1:
        padding = (ph0, pw0)
    else:
        xn, padding = F.pad(xn, (pw0, pw1, ph0, ph1)), 0
    y = F.conv2d(xn, w_hwio.permute(3, 2, 0, 1), stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def log_conv2d_blockwise(x, packed, scale, cfg: LogQuantConfig = DEFAULT_CFG,
                         *, stride: int = 1, padding="SAME", groups: int = 1,
                         out_dtype=None):
    """Decode the codes, then `F.conv2d` (NHWC ↔ NCHW at the boundary)."""
    B, H, W, C, K, Cout = _check_shapes(x, packed, groups)
    pads = normalize_padding(padding, K, stride, H, W)
    w = decode_codes(packed, cfg) * _scale_vector(scale, Cout, packed.device)
    y = conv_nhwc(x.to(torch.float32), w, stride=stride, pads=pads,
                  groups=groups)
    return y.to(out_dtype or x.dtype)


def log_conv2d_ref(x, packed, scale, cfg: LogQuantConfig = DEFAULT_CFG,
                   *, stride: int = 1, padding="SAME", groups: int = 1,
                   out_dtype=None):
    """Full-materialisation oracle: explicit patches × `ref_log_matmul`."""
    B, H, W, C, K, Cout = _check_shapes(x, packed, groups)
    pads = normalize_padding(padding, K, stride, H, W)
    patches, Ho, Wo = _im2col(x.to(torch.float32), K, stride, pads)
    codes = _block_diag_codes(packed, groups)
    scale = _scale_vector(scale, Cout, packed.device).reshape(1, Cout)
    out = ref_log_matmul(patches.reshape(B * Ho * Wo, -1), codes, scale, cfg,
                         out_dtype=out_dtype or x.dtype)
    return out.reshape(B, Ho, Wo, Cout)


# ---------------------------------------------------------------------------
# lane-packed grouped-conv layout
# ---------------------------------------------------------------------------

LANES = 128  # lane width of the TPU matrix unit the packed layout targets


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def lane_pack_geometry(groups: int, cin_g: int, lane_pack: int | None = None,
                       lanes: int = LANES) -> dict:
    """How many groups share one lane block for a grouped conv.

    ``lane_pack``: ``None`` → auto (pack whenever ≥2 groups fit a block),
    ``0``/``1`` → off, ``n ≥ 2`` → up to ``n`` groups per block.  Returns
    ``{"g_b", "cin_lane", "n_sb"}``: groups per block (1 = off), each
    group's channel slot (`cin_g` padded to a power of two) and the
    superblock count ``ceil(groups / g_b)``."""
    off = dict(g_b=1, cin_lane=cin_g, n_sb=groups)
    if groups <= 1 or (lane_pack is not None and lane_pack <= 1):
        return off
    cin_lane = _next_pow2(cin_g)
    g_b = lanes // cin_lane if cin_lane <= lanes else 0
    if lane_pack is not None:
        g_b = min(g_b, lane_pack)
    g_b = min(g_b, groups)
    if g_b < 2:
        return off
    return dict(g_b=g_b, cin_lane=cin_lane, n_sb=-(-groups // g_b))


def lane_pack_codes(packed, groups: int, g_b: int, cin_lane: int):
    """packed [K, K, cin_g, Cout] → [n_sb, K*K, g_b*cin_lane, Cout//groups]
    int8 codes; lane ``g*cin_lane + i`` of a superblock holds group ``g``'s
    channel ``i``.  Padding uses int8 0, the zero code."""
    K1, K2, cin_g, Cout = packed.shape
    taps, cout_g = K1 * K2, Cout // groups
    n_sb = -(-groups // g_b)
    w = packed.reshape(taps, cin_g, groups, cout_g)
    # F.pad pads trailing dims first: (cout_g, groups, cin_g)
    w = F.pad(w, (0, 0, 0, n_sb * g_b - groups, 0, cin_lane - cin_g))
    w = w.permute(2, 0, 1, 3).reshape(n_sb, g_b, taps, cin_lane, cout_g)
    return w.permute(0, 2, 1, 3, 4).reshape(n_sb, taps, g_b * cin_lane,
                                            cout_g).contiguous()


def lane_unpack_codes(packed_lp, shape, groups: int, g_b: int,
                      cin_lane: int):
    """Inverse of `lane_pack_codes`: → the natural [K, K, cin_g, Cout]."""
    K1, K2, cin_g, Cout = shape
    taps, cout_g = K1 * K2, Cout // groups
    n_sb = packed_lp.shape[0]
    w = packed_lp.reshape(n_sb, taps, g_b, cin_lane, cout_g)
    w = w.permute(0, 2, 1, 3, 4).reshape(n_sb * g_b, taps, cin_lane, cout_g)
    w = w[:groups, :, :cin_g, :]
    return w.permute(1, 2, 0, 3).reshape(K1, K2, cin_g, Cout).contiguous()


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_I32_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65535
# the dense kernel's tile: BM output pixels x BN output channels a block,
# R walked in stages of BK reduction indices (csrc/log_conv2d.cu)
BM, BN, BK = 128, 64, 32
# the depthwise kernel: DW_PW outputs a thread along W, at most DW_NT
# threads and DW_SMEM_MAX bytes of shared memory a block, tiles at most
# DW_TW columns and DW_CT channels wide
DW_PW, DW_NT, DW_SMEM_MAX, DW_TW, DW_CT = 4, 256, 232448, 16, 32


@functools.lru_cache(maxsize=16)
def plane_table(cfg: LogQuantConfig, device: torch.device) -> torch.Tensor:
    """The dense kernel's decode table: int32 ``[2^(bits+1)]``, entry ``c``
    = ``bf16(W_e(c)) | bf16(W_o(c)) << 16`` (bit patterns).

    A code decodes to ``s·2^e`` (even code) or ``s·√2·2^e`` (odd code, with
    frac_bits 1), so ``dec(c) = W_e(c) + fp32(√2)·W_o(c)``: the even plane
    holds ``s·2^e`` for an even code and +0 otherwise, the odd plane ``s·2^e``
    for an odd code and +0 otherwise.  Every plane value is an exact bf16
    number (e ≥ -126 for bits ≤ 7).  The zero code gives +0 in both.  Made
    once per device."""
    even, odd = [], []
    for c in range(2 << cfg.bits):
        biased = c & ((1 << cfg.bits) - 1)
        code = biased - cfg.bias
        v = (-1.0) ** (c >> cfg.bits) * 2.0 ** (code >> cfg.frac_bits)
        if biased == cfg.zero_code:
            v = 0.0
        is_odd = cfg.frac_bits == 1 and code & 1
        even.append(0.0 if is_odd else v)
        odd.append(v if is_odd else 0.0)

    def bits16(v):
        return torch.tensor(v).to(torch.bfloat16).view(torch.int16).to(
            torch.int64) & 0xFFFF

    entry = bits16(even) | (bits16(odd) << 16)
    entry = torch.where(entry >= 2 ** 31, entry - 2 ** 32, entry)
    return entry.to(torch.int32).to(device)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _depthwise_smem(th: int, tw: int, ct: int, K: int, stride: int) -> int:
    """Shared memory of a depthwise block: the fp32 input patch of a
    ``th x tw`` output tile, halo included, and the decoded codes, both
    ``ct`` channels wide."""
    return 4 * ct * (((th - 1) * stride + K) * ((tw - 1) * stride + K)
                     + K * K)


def _check_tile(tile, K: int, stride: int) -> tuple[int, int, int]:
    """An explicit depthwise tile against the launcher's contract: ``tw`` a
    multiple of ``DW_PW``, ``ct`` in {4, 8, 16, 32}, at most ``DW_NT``
    threads and ``DW_SMEM_MAX`` bytes of shared memory a block."""
    try:
        th, tw, ct = (int(v) for v in tile)
    except (TypeError, ValueError):
        raise ValueError(f"tile={tile!r}: a depthwise tile is (th, tw, ct)")
    if th < 1 or tw < DW_PW or tw % DW_PW:
        raise ValueError(f"tile={tile!r}: th >= 1 and tw a multiple of "
                         f"{DW_PW}")
    if ct not in (4, 8, 16, 32):
        raise ValueError(f"tile={tile!r}: ct must be 4, 8, 16 or 32")
    if ct // 4 * th * (tw // DW_PW) > DW_NT:
        raise ValueError(f"tile={tile!r}: {ct // 4 * th * (tw // DW_PW)} "
                         f"threads a block, at most {DW_NT}")
    smem = _depthwise_smem(th, tw, ct, K, stride)
    if smem > DW_SMEM_MAX:
        raise ValueError(f"tile={tile!r}: {smem} bytes of shared memory a "
                         f"block, at most {DW_SMEM_MAX}")
    return th, tw, ct


def _depthwise_geometry(B, Ho, Wo, C, K, Cout, stride, cout_g, n_sm,
                        tile=None):
    """A depthwise block owns ``th x tw`` outputs of ``ct`` channels of one
    image; a thread, 4 channels of ``DW_PW`` adjacent outputs.  An explicit
    ``tile`` is taken as it is (`_check_tile`).  Otherwise ``tw`` splits Wo
    into near-equal tiles of at most ``DW_TW`` columns (half that at
    stride > 1, where the patch is wider); ``ct`` is ``DW_CT`` or the
    power of two that holds Cout; ``th`` is the largest that keeps the
    block within ``DW_NT`` threads and the shared memory.  Where those
    tiles launch fewer than ``n_sm`` blocks, ``ct`` halves (down to 16) and
    then ``th`` shrinks until they do, or to one-row tiles."""
    if tile is not None:
        th, tw, ct = _check_tile(tile, K, stride)
    else:
        th, tw, ct = _depthwise_tile(B, Ho, Wo, Cout, K, stride, n_sm)
    tiles_h, tiles_w, tiles_c = _cdiv(Ho, th), _cdiv(Wo, tw), _cdiv(Cout, ct)
    return {"path": "depthwise",
            "load": "cp.async" if C % 4 == 0 and cout_g == 1 else "gather",
            "tile": (th, tw, ct), "threads": ct // 4 * th * (tw // DW_PW),
            "smem_bytes": _depthwise_smem(th, tw, ct, K, stride),
            "tiles_h": tiles_h, "tiles_w": tiles_w, "tiles_c": tiles_c,
            "tiles": B * tiles_h * tiles_w * tiles_c, "splits": 1,
            "stages_per_split": 1, "blocks": B * tiles_h * tiles_w * tiles_c}


def _depthwise_tile(B, Ho, Wo, Cout, K, stride, n_sm):
    """The heuristic's depthwise tile (`_depthwise_geometry`)."""
    tw_max = DW_TW if stride == 1 else DW_TW // 2
    tw = DW_PW * _cdiv(_cdiv(Wo, _cdiv(Wo, tw_max)), DW_PW)
    tiles_w = _cdiv(Wo, tw)
    ct = min(DW_CT, 4 * _next_pow2(_cdiv(Cout, 4)))

    def rows(ct):
        """The largest near-equal th that fits, and its block count."""
        per_row = ct // 4 * (tw // DW_PW)
        for th in range(min(Ho, DW_NT // per_row), 0, -1):
            th = _cdiv(Ho, _cdiv(Ho, th))
            if _depthwise_smem(th, tw, ct, K, stride) <= DW_SMEM_MAX:
                return th, B * _cdiv(Ho, th) * tiles_w * _cdiv(Cout, ct)
        raise ValueError(f"no depthwise tile fits {DW_SMEM_MAX} bytes of "
                         f"shared memory at K={K}, stride={stride}")

    th, blocks = rows(ct)
    while blocks < n_sm and ct > 16:
        ct //= 2
        th, blocks = rows(ct)
    tiles_h = _cdiv(Ho, th)
    while blocks < n_sm and th > 1:
        tiles_h += 1
        th = _cdiv(Ho, tiles_h)
        blocks = B * _cdiv(Ho, th) * tiles_w * _cdiv(Cout, ct)
    return th, tw, ct


def dense_shares(stages: int, splits: int) -> int:
    """Stages a share when ``splits`` shares cover ``stages`` stages: the
    launcher's contract is that they cover them exactly and none is empty,
    else ValueError naming ``splits``."""
    if not isinstance(splits, int) or not 1 <= splits <= stages:
        raise ValueError(f"splits={splits!r}: 1 to {stages} shares of "
                         f"{stages} stages")
    sps = -(-stages // splits)
    if -(-stages // sps) != splits:
        raise ValueError(f"splits={splits}: shares of {sps} stages cover "
                         f"{stages} stages in {-(-stages // sps)}, so one "
                         f"would be empty")
    return sps


def log_conv2d_geometry(B: int, H: int, W: int, C: int, K: int, Cout: int,
                        stride: int = 1, padding="SAME", groups: int = 1,
                        n_sm: int = 132, splits: int | None = None,
                        tile=None) -> dict:
    """The launch shape of the CUDA kernel for one conv on a card of
    ``n_sm`` SMs.  Each path takes one knob and ignores the other's:
    ``tile`` (depthwise) and ``splits`` (dense); ``None`` leaves it to the
    heuristic below, and an explicit one that breaks the launcher's
    contract raises ValueError naming it.

    Depthwise (``C // groups == 1``): a block owns a ``tile`` of ``th x tw``
    outputs of ``ct`` channels of one image (`_depthwise_geometry`) and
    stages its input patch in ``smem_bytes`` of shared memory; ``load`` is
    ``cp.async`` (16-byte copies, C % 4 == 0 and one output channel a
    group) or ``gather``.  → dict with ``path``, ``load``, ``tile``,
    ``threads``, ``smem_bytes``, ``tiles_h``, ``tiles_w``, ``tiles_c``,
    ``tiles``, ``splits`` (1), ``stages_per_split`` (1) and ``blocks``.

    Dense: an implicit GEMM, M = B·Ho·Wo pixels by N = Cout // groups
    channels a group, R = K·K·cin_g reduction indices in ``stages`` of
    ``BK``; a block owns a ``BM x BN`` tile of one group and one share of
    ``stages_per_split`` stages.  Where the tiles alone leave SMs idle the
    shares bring the launch near two blocks per SM, and at least one block
    per SM where R allows it: ``splits`` shares cover the stages exactly and
    none is empty.  ``load`` names how x reaches shared memory: ``cp.async``
    (cin_g % 16 == 0, each 16-index chunk lies in one tap) or ``gather``.
    → dict with ``path``, ``load``, ``bm``, ``bn``, ``bk``, ``m_tiles``,
    ``n_tiles``, ``tiles``, ``stages``, ``splits``, ``stages_per_split``
    and ``blocks``."""
    pads = normalize_padding(padding, K, stride, H, W)
    Ho, Wo = _out_size(H, K, stride, pads[0]), _out_size(W, K, stride, pads[1])
    if min(B, Ho, Wo, C, Cout, K, groups) < 1 or C % groups or Cout % groups:
        raise ValueError(f"no conv: B={B} H={H} W={W} C={C} K={K} "
                         f"Cout={Cout} stride={stride} groups={groups}")
    cin_g, cout_g, M = C // groups, Cout // groups, B * Ho * Wo
    if cin_g == 1:
        return _depthwise_geometry(B, Ho, Wo, C, K, Cout, stride, cout_g,
                                   n_sm, tile)
    m_tiles, n_tiles = -(-M // BM), -(-cout_g // BN)
    tiles = m_tiles * n_tiles * groups
    stages = -(-K * K * cin_g // BK)
    if splits is not None:
        sps = dense_shares(stages, splits)
    else:
        want = min(stages, max(1, round(2 * n_sm / tiles)))
        while True:
            sps = -(-stages // want)
            splits = -(-stages // sps)
            if tiles * splits >= n_sm or splits == stages:
                break
            want += 1
    return {"path": "dense", "load": "cp.async" if cin_g % 16 == 0
            else "gather", "bm": BM, "bn": BN, "bk": BK, "m_tiles": m_tiles,
            "n_tiles": n_tiles, "tiles": tiles, "stages": stages,
            "splits": splits, "stages_per_split": sps,
            "blocks": tiles * splits}


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# per device: one zeroed int32 ticket per output tile of a split launch, for
# the split-K kernels (log_conv2d, log_matmul) and the split-KV variant of
# flash_attention (a ticket a row block); each launch leaves the
# tickets it used at zero again, so launches that share a device run one
# after another on one stream, as the port's callers do
_TICKETS: dict[int, torch.Tensor] = {}


def split_tickets(device: torch.device, tiles: int) -> torch.Tensor:
    buf = _TICKETS.get(device.index)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _TICKETS[device.index] = buf
    return buf


def _kernel_fn():
    fn = _build.load("log_conv2d").log_conv2d_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 24
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def knob_args(config) -> dict:
    """``config`` (None or a mapping) → the geometry's ``splits`` / ``tile``
    keyword arguments; other keys (``lane_pack``) are not launch knobs."""
    config = config or {}
    return {k: config.get(k) for k in ("splits", "tile")}


def log_conv2d_fused(x, packed, scale, cfg: LogQuantConfig = DEFAULT_CFG, *,
                     stride: int = 1, padding="SAME", groups: int = 1,
                     lane: tuple[int, int] | None = None, config=None,
                     on_launch=None):
    """NHWC conv on the CUDA kernel `csrc/log_conv2d.cu` → fp32 NHWC.

    x: fp32 [B, H, W, C], contiguous.  packed: contiguous int8 codes, either
    natural HWIO [K, K, C//groups, Cout] or, with ``lane=(g_b, cin_lane)``,
    the lane-packed [n_sb, K*K, g_b*cin_lane, Cout//groups] that
    `lane_pack_codes` makes, read as stored.  scale: scalar or
    per-output-channel.  The launch shape comes from `log_conv2d_geometry`,
    with the knobs of ``config`` (a mapping with ``splits`` and ``tile``,
    None for the heuristic's), which are checked against the launcher's
    contract on every device.  ``on_launch``, where given, is called with
    no argument right before the launch (the kernel-dispatch profiler
    starts its timed span there).

    A CUDA tensor launches the kernel (and adds one to
    ``log_conv2d_fused.launches``) or raises; a CPU tensor runs the plain
    `log_conv2d_blockwise`, and a meta tensor gives its output's shape.
    Grad guard: with grad mode on, an input that requires grad raises on
    every device (`_build.refuse_grad`), since the kernel's output has no
    backward."""
    _build.refuse_grad("log_conv2d_fused", x, scale)
    if x.ndim != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"log_conv2d_fused takes contiguous fp32 NHWC "
                         f"activations, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    if packed.dtype != torch.int8 or not packed.is_contiguous():
        raise ValueError(f"log_conv2d_fused takes contiguous int8 codes, got "
                         f"{packed.dtype} contiguous={packed.is_contiguous()}")
    if packed.device != x.device:
        raise ValueError(f"x on {x.device} but codes on {packed.device}")
    B, H, W, C = x.shape
    if C % groups:
        raise ValueError(f"C={C} is not a multiple of groups={groups}")
    cin_g = C // groups
    if lane is None:
        _, _, _, _, K, Cout = _check_shapes(x, packed, groups)
        cout_g = Cout // groups
        g_b, w_sb, w_gl = 1, cout_g, 0
        w_tap, w_in = cin_g * Cout, Cout
    else:
        g_b, cin_lane = lane
        n_sb, taps, L, cout_g = packed.shape
        K = int(round(taps ** 0.5))
        Cout = groups * cout_g
        if (K * K != taps or L != g_b * cin_lane or cin_lane < cin_g
                or n_sb != -(-groups // g_b)):
            raise ValueError(f"lane-packed codes {tuple(packed.shape)} do not "
                             f"fit lane={lane}, C={C}, groups={groups}")
        w_sb, w_gl, w_tap, w_in = taps * L * cout_g, cin_lane * cout_g, \
            L * cout_g, cout_g
    scale = _scale_vector(scale, Cout, x.device)
    knobs = knob_args(config)

    if x.device.type in ("cpu", "meta"):
        if any(v is not None for v in knobs.values()):
            log_conv2d_geometry(B, H, W, C, K, Cout, stride, padding, groups,
                                **knobs)
        codes = packed if lane is None else lane_unpack_codes(
            packed, (K, K, cin_g, Cout), groups, g_b, lane[1])
        # contiguous NHWC, as the kernel writes it
        return log_conv2d_blockwise(x, codes, scale, cfg, stride=stride,
                                    padding=padding,
                                    groups=groups).contiguous()
    if x.device.type != "cuda":
        raise ValueError(f"log_conv2d_fused runs on CUDA or CPU tensors, "
                         f"got {x.device}")
    if cfg.frac_bits not in (0, 1) or not 1 <= cfg.bits <= 7:
        raise ValueError(f"the CUDA kernel decodes bits ≤ 7 and frac_bits "
                         f"∈ {{0, 1}}, got {cfg}")
    pads = normalize_padding(padding, K, stride, H, W)
    Ho, Wo = _out_size(H, K, stride, pads[0]), _out_size(W, K, stride, pads[1])
    if min(Ho, Wo) < 1:
        raise ValueError(f"empty output for x {tuple(x.shape)}, K={K}, "
                         f"stride={stride}, pads={pads}")
    y = torch.empty((B, Ho, Wo, Cout), dtype=torch.float32, device=x.device)
    if max(x.numel(), y.numel(), packed.numel()) > _I32_MAX:
        raise ValueError("tensor too large for the kernel's 32-bit indexing")
    geo = log_conv2d_geometry(B, H, W, C, K, Cout, stride, pads, groups,
                              sm_count(x.device.index), **knobs)
    if geo["path"] == "dense" and (
            geo["m_tiles"] > _GRID_YZ_MAX
            or groups * geo["splits"] > _GRID_YZ_MAX):
        raise ValueError("shape too large for the kernel's launch grid")
    part = tickets = None
    if geo["splits"] > 1:
        part = torch.empty((geo["splits"], B * Ho * Wo, Cout),
                           dtype=torch.float32, device=x.device)
        tickets = split_tickets(x.device, geo["tiles"])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernel, planes = _kernel_fn(), plane_table(cfg, x.device)
    if on_launch is not None:
        on_launch()
    err = kernel(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                 planes.data_ptr(), y.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 tickets.data_ptr() if tickets is not None else None,
                 B, H, W, C, Ho, Wo, Cout, K, stride, pads[0][0],
                 pads[1][0], groups, g_b, w_sb, w_gl, w_tap, w_in,
                 cfg.bits, cfg.frac_bits, geo["stages_per_split"],
                 geo["splits"], *geo.get("tile", (0, 0, 0)), stream)
    if err != 0:
        raise RuntimeError(f"log_conv2d CUDA launch failed: cudaError {err}")
    log_conv2d_fused.launches += 1
    return y


log_conv2d_fused.launches = 0  # kernel launches; chip_smoke.py resets it


# ---------------------------------------------------------------------------
# analytic device-memory traffic and the shape key
# ---------------------------------------------------------------------------


def _covered(n_out: int, tile: int, stride: int, pad: int, reach: int,
             size: int) -> int:
    """Input rows (or columns) that tiles of ``tile`` outputs fetch, summed
    over the ``ceil(n_out / tile)`` tiles along one axis: tile ``i`` reads
    the ``reach`` input indices from ``i * tile * stride - pad``, clipped
    to ``[0, size)`` (indices outside the image are zero-filled, not
    read)."""
    total = 0
    for i in range(_cdiv(n_out, tile)):
        lo = i * tile * stride - pad
        total += max(0, min(lo + reach, size) - max(lo, 0))
    return total


def _taps_inside(n_out: int, stride: int, pad: int, K: int,
                 size: int) -> int:
    """``_covered(n_out, 1, stride, pad, K, size)`` in K steps: for each tap
    k, the outputs o with ``0 <= o * stride + k - pad < size``."""
    return sum(max(0, min(n_out, (size - 1 + pad - k) // stride + 1)
                   - max(0, -(-(pad - k) // stride))) for k in range(K))


def conv_traffic_bytes(impl: str, B: int, H: int, W: int, C: int, K: int,
                       Cout: int, *, stride: int = 1, padding="SAME",
                       groups: int = 1, act_itemsize: int = 4,
                       code_itemsize: int = 1, bits: int = 6,
                       n_sm: int = 132, config=None) -> dict:
    """Bytes moved between device memory and the chip for one conv call,
    per implementation → ``{"act", "w", "out", "act_w", "total"}``.

    ``"fp32"`` (a float conv on fp32 weights), ``"blockwise"`` (decode,
    then a float conv: x once, int8 codes once) and ``"ref"`` (modelled as
    ``"fp32"``, as the JAX package's dispatch does) are the formulas of
    `repro.kernels.log_conv2d.conv_traffic_bytes`, so both packages give
    the same bytes for them.  ``"min"`` is the least any implementation
    moves: x, the codes, the scale and y, each once (the byte count of a
    conv's bound).

    ``"cuda"`` counts what the kernel `csrc/log_conv2d.cu` fetches at the
    launch shape of `log_conv2d_geometry` (on a card of ``n_sm`` SMs, with
    the ``splits`` and ``tile`` of ``config`` where given, as the wrapper
    launches it):

      dense      each block reads the in-image x values of its rows for
                 the reduction indices of its share (so x is read once per
                 column tile; taps in the padding are zero-filled, not
                 read), the codes of its share's rows and its columns (once
                 per row tile) and the 2^(bits+1)-entry plane table; the
                 scale is read once per row tile.  y is written once.
                 With ``splits > 1`` every share writes its fp32 partials
                 and the last share of a tile reads them all back
                 (``"partials"``), beside one int32 ticket a tile, taken by
                 an atomic of each share and reset once.
      depthwise  each block stages its input patch, halo included, clipped
                 to the image, its channels wide; it reads its K*K codes
                 and its scales once for each channel; y is written once.

    Accesses are counted first order: L2 hits and sub-sector waste are not
    modelled.  JAX's ``lanes`` and ``matmul_block`` are left out: they
    model the TPU's whole-128-lane block DMAs and the explicit im2col path
    ``pallas_im2col`` (not ported), neither of which the CUDA kernel has;
    it reads natural and lane-packed codes alike, so its bytes do not
    depend on the layout."""
    pads = normalize_padding(padding, K, stride, H, W)
    Ho, Wo = _out_size(H, K, stride, pads[0]), _out_size(W, K, stride, pads[1])
    cin_g = C // groups
    x_b = B * H * W * C * act_itemsize
    out_b = B * Ho * Wo * Cout * act_itemsize
    w_codes = K * K * cin_g * Cout * code_itemsize
    part = 0
    impl = {"ref": "fp32"}.get(impl, impl)
    if impl == "fp32":
        act, w = x_b, K * K * cin_g * Cout * act_itemsize
    elif impl == "blockwise":
        act, w = x_b, w_codes
    elif impl == "min":
        act, w = x_b, w_codes + 4 * Cout
    elif impl == "cuda":
        g = log_conv2d_geometry(B, H, W, C, K, Cout, stride, pads, groups,
                                n_sm, **knob_args(config))
        if g["path"] == "depthwise":
            th, tw, ct = g["tile"]
            rows = _covered(Ho, th, stride, pads[0][0], (th - 1) * stride + K,
                            H)
            cols = _covered(Wo, tw, stride, pads[1][0], (tw - 1) * stride + K,
                            W)
            act = B * rows * cols * Cout * act_itemsize
            per_tile = B * g["tiles_h"] * g["tiles_w"]
            w = per_tile * Cout * (K * K * code_itemsize + 4)
        else:
            rows = _taps_inside(Ho, stride, pads[0][0], K, H)
            cols = _taps_inside(Wo, stride, pads[1][0], K, W)
            act = g["n_tiles"] * groups * cin_g * B * rows * cols \
                * act_itemsize
            w = g["m_tiles"] * Cout * (K * K * cin_g * code_itemsize + 4) \
                + g["blocks"] * (2 << bits) * 4
            if g["splits"] > 1:
                part = 2 * g["splits"] * B * Ho * Wo * Cout * 4 \
                    + g["tiles"] * (8 * g["splits"] + 4)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    out = {"act": int(act), "w": int(w), "out": int(out_b + part),
           "act_w": int(act + w), "total": int(act + w + out_b + part)}
    if impl == "cuda":
        out["partials"] = int(part)
    return out


def __getattr__(name: str):
    # `conv_key` moved to kernels/autotune.py (which imports this module)
    if name == "conv_key":
        from .autotune import conv_key
        return conv_key
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
