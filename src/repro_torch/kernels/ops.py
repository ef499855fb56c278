"""The kernel-call surface of the port (counterpart of `repro.kernels.ops`:
`log_matmul`, `conv2d`, `attention` and `wkv6`).

Every op takes the dispatch knob ``impl=``, resolved by `resolve_impl`:

  "cuda"      — the op's hand-written CUDA kernel (`log_matmul_cuda`,
                `log_conv2d_fused`, `flash_attention_cuda`, `wkv6_cuda`);
                on a CPU tensor its wrapper runs the op's plain version
  "blockwise" — plain PyTorch: decode then matmul, decode then `F.conv2d`,
                online softmax over kv chunks, the chunked WKV closed form
  "ref"       — the full-materialisation oracles (tests)
  "auto"      — "cuda" for a CUDA tensor, "blockwise" for a CPU tensor

plus a per-op frozen config: ``ConvConfig(lane_pack=...)`` for the
grouped-conv layout, ``AttentionConfig`` for the blockwise version's chunk
and math knobs, ``WkvConfig(chunk=...)`` for the chunked WKV.

While the kernel-dispatch profiler is on (`obs.kernel_profile`), every op
goes through `kernel_profile.dispatch` with its shape key and analytic
bytes, in the formats of `repro.kernels.ops`; while it is off, neither is
computed.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.logquant import (LogQuantConfig, QuantizedTensor,
                                       quantize_tensor)
from repro_torch.obs import kernel_profile as _kprof
from .flash_attention import (attention_key, attention_traffic_bytes,
                              flash_attention_cuda)
from .log_conv2d import (conv_key, conv_traffic_bytes, lane_unpack_codes,
                         log_conv2d_blockwise, log_conv2d_fused,
                         log_conv2d_ref, sm_count)
from .log_matmul import log_matmul_cuda
from .ref import positions, ref_attention, ref_log_matmul, ref_wkv6
from .wkv6 import wkv6_chunked, wkv6_cuda

_OP_IMPLS = {
    "log_matmul": ("cuda", "blockwise", "ref"),
    "conv2d": ("cuda", "blockwise", "ref"),
    "attention": ("cuda", "blockwise", "ref"),
    "wkv6": ("cuda", "blockwise", "ref"),
}


def resolve_impl(op: str, impl: str = "auto", device=None) -> str:
    """An explicit ``impl`` (validated against the op's implementations)
    beats ``"auto"``, which picks "cuda" when the operands lie on a CUDA
    device and "blockwise" otherwise.  It never asks whether a card exists:
    the tensors' device decides."""
    choices = _OP_IMPLS[op]
    if impl == "auto":
        dev = torch.device(device) if device is not None else None
        impl = "cuda" if dev is not None and dev.type == "cuda" else "blockwise"
    if impl not in choices:
        raise ValueError(f"unknown {op} impl {impl!r}; expected "
                         f"{'|'.join(choices)}|auto")
    return impl


# ---------------------------------------------------------------------------
# log_matmul
# ---------------------------------------------------------------------------


def log_matmul(x, qt: QuantizedTensor, *, impl: str = "auto"):
    """x: [..., K] @ dequant(qt [K, N]) → [..., N] in x's dtype."""
    impl = resolve_impl("log_matmul", impl, x.device)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    N = qt.packed.shape[-1]
    scale = torch.as_tensor(qt.scale, dtype=torch.float32,
                            device=x.device).reshape(1, -1).expand(1, N)
    if impl == "cuda":
        call = lambda: log_matmul_cuda(x2.contiguous(), qt.packed, scale,
                                       qt.cfg, out_dtype=x.dtype)
    else:
        # blockwise == ref for a matmul (as in the JAX package)
        call = lambda: ref_log_matmul(x2, qt.packed, scale, qt.cfg,
                                      out_dtype=x.dtype)
    if _kprof.PROFILER.enabled():
        M, it = x2.shape[0], x.element_size()
        act, w, outb = M * K * it, K * N, M * N * it  # codes move as int8
        traffic = {"act": act, "w": w, "out": outb,
                   "total": act + w + outb}
        key = f"log_matmul|{x.device.type}|m{M}|k{K}|n{N}"
        out = _kprof.dispatch("log_matmul", impl, key, traffic, call,
                              traced=_kprof.is_traced(x), device=x.device)
    else:
        out = call()
    return out.reshape(*lead, N)


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    """Layout spec for `conv2d`.

    ``lane_pack`` says whether a `QuantizedTensor`'s baked ``"lane_packed"``
    layout may ride onto the kernel: ``None`` (or the baked factor) uses it
    as stored; any other value (``1`` = off) unpacks it to HWIO first.  An
    explicit value beats the baked layout.  The CUDA kernel reads natural
    HWIO codes as well as packed ones, so HWIO codes are never packed per
    call."""
    lane_pack: int | None = None


def _lane_pack(config) -> int | None:
    if config is None:
        return None
    if isinstance(config, ConvConfig):
        return config.lane_pack
    return dict(config).get("lane_pack")


def conv2d(x, qt, *, stride: int = 1, padding="SAME", groups: int = 1,
           impl: str = "auto", out_dtype=None,
           qcfg: LogQuantConfig | None = None,
           config: ConvConfig | dict | None = None):
    """x: [B, H, W, Cin] ⊛ dequant(qt [K, K, Cin//groups, Cout]) → NHWC out.

    `qt` is a `QuantizedTensor` of packed log codes in any of its layouts
    (natural, ``conv_taps``, ``lane_packed``); a plain float kernel is
    packed on the fly (inference only).  Supports stride,
    SAME/VALID/int/explicit padding and grouped/depthwise convs."""
    if impl == "pallas_im2col":
        raise ValueError("conv2d impl 'pallas_im2col' (explicit im2col onto "
                         "the log_matmul kernel) is not ported (ROADMAP.md "
                         "queue B, item 2)")
    if not isinstance(qt, QuantizedTensor):
        qt = quantize_tensor(torch.as_tensor(qt, device=x.device),
                             qcfg or LogQuantConfig())
    impl = resolve_impl("conv2d", impl, x.device)
    packed, lane = qt.packed, None
    if qt.layout == "conv_taps":
        packed = packed.reshape(qt.shape)  # [taps, cin_g, Cout] → HWIO view
    elif qt.layout == "lane_packed":
        # the baked layout rides onto the kernel when it matches this call;
        # any disagreement (other groups, a conflicting explicit lane_pack,
        # a plain impl) unpacks the codes to HWIO, which is always correct
        g_b, cin_lane, meta_groups = qt.layout_meta
        want = _lane_pack(config)
        if impl == "cuda" and meta_groups == groups and want in (None, g_b):
            lane = (g_b, cin_lane)
        else:
            packed = lane_unpack_codes(packed, qt.shape, meta_groups, g_b,
                                       cin_lane)
    kw = dict(stride=stride, padding=padding, groups=groups)
    fn = {"cuda": functools.partial(log_conv2d_fused, lane=lane),
          "ref": log_conv2d_ref, "blockwise": log_conv2d_blockwise}[impl]

    def call():
        y = fn(x, packed, qt.scale, qt.cfg, **kw)
        return y if out_dtype is None else y.to(out_dtype)
    if not _kprof.PROFILER.enabled():
        return call()
    B, H, W, C = x.shape
    K, Cout = qt.shape[0], qt.shape[-1]
    n_sm = sm_count(x.device.index) if x.is_cuda else 132
    traffic = conv_traffic_bytes(impl, B, H, W, C, K, Cout, **kw,
                                 act_itemsize=x.element_size(),
                                 bits=qt.cfg.bits, n_sm=n_sm)
    key = conv_key(B, H, W, C, K, Cout, **kw, cfg=qt.cfg,
                   backend=x.device.type)
    return _kprof.dispatch("conv2d", impl, key, traffic, call,
                           traced=_kprof.is_traced(x, packed),
                           device=x.device)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Math spec for `attention`'s blockwise version.  The CUDA kernel's
    tiles come from `flash_attention.flash_attention_geometry`."""
    block_k: int | None = None       # blockwise kv chunk (default 1024)
    acc_dtype: Any = torch.float32   # blockwise score/accum math dtype
    gqa_broadcast: bool = False      # blockwise: einsum-broadcast GQA


def _blockwise_attention(q, k, v, *, causal, window, scale, q_offset,
                         k_offset=0, block_k: int = 1024,
                         acc_dtype=torch.float32, gqa_broadcast: bool = False):
    """Online softmax over kv chunks of ``block_k`` keys.

    q: [B, Tq, H, D]; k, v: [B, Tk, Hkv, D]; offsets are ints or int
    tensors ``[B]``.  `acc_dtype` runs the score/accumulator math in bf16
    (running max and sum stay fp32); `gqa_broadcast` contracts a
    ``[B, Tq, Hkv, rep, D]`` view of q against unexpanded K/V instead of
    repeating K/V rep times."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / D ** 0.5
    f32, cdt, dev = torch.float32, acc_dtype, q.device

    pk = (-Tk) % block_k
    kp = F.pad(k, (0, 0, 0, 0, 0, pk))
    vp = F.pad(v, (0, 0, 0, 0, 0, pk))
    nkv = (Tk + pk) // block_k

    use_bcast = gqa_broadcast and rep > 1
    qf = q.to(cdt) * torch.tensor(scale, dtype=cdt, device=dev)
    if use_bcast:
        qf = qf.reshape(B, Tq, Hkv, rep, D)
    qpos = positions(Tq, q_offset, dev)[:, :, None]          # [B|1, Tq, 1]
    k_off = torch.as_tensor(k_offset, device=dev).reshape(-1, 1, 1)

    m = torch.full((B, H, Tq, 1), -1e30, dtype=f32, device=dev)
    l = torch.zeros((B, H, Tq, 1), dtype=f32, device=dev)
    acc = torch.zeros((B, H, Tq, D), dtype=f32, device=dev)
    neg = torch.tensor(-1e30, dtype=f32, device=dev)
    for kv_idx in range(nkv):
        kb = kp[:, kv_idx * block_k:(kv_idx + 1) * block_k]
        vb = vp[:, kv_idx * block_k:(kv_idx + 1) * block_k]
        if use_bcast:
            s = torch.einsum("bqhrd,bkhd->bhrqk", qf, kb.to(cdt))
            s = s.reshape(B, H, Tq, block_k)
        else:
            if rep > 1:
                kb = kb.repeat_interleave(rep, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(cdt))
        s = s.to(f32)
        kpos = (kv_idx * block_k + torch.arange(block_k, device=dev)
                )[None, None, :] + k_off                      # [B|1, 1, bk]
        mask = (kpos < Tk + k_off) & (kpos >= 0)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & ((qpos - kpos) < window)
        mask = mask[:, None]                                  # head axis
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros((), device=dev))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if use_bcast:
            pv = torch.einsum("bhrqk,bkhd->bqhrd",
                              p.reshape(B, Hkv, rep, Tq, block_k).to(cdt),
                              vb.to(cdt))
            pv = pv.reshape(B, Tq, H, D).permute(0, 2, 1, 3)
        else:
            if rep > 1:
                vb = vb.repeat_interleave(rep, dim=2)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(cdt), vb.to(cdt))
        acc = alpha * acc + pv.to(f32)
        m = m_new
    out = acc / torch.where(l > 0, l, torch.ones((), device=dev))
    return out.permute(0, 2, 1, 3).to(q.dtype)


_UNSET = object()  # legacy-kwarg sentinel: distinguishes "not passed"


def _translate_legacy_attn_kwargs(config, legacy: dict):
    """Deprecation shim: `block_k=`/`acc_dtype=`/`gqa_broadcast=` become
    `AttentionConfig` fields."""
    passed = {n: v for n, v in legacy.items() if v is not _UNSET}
    if not passed:
        return config or AttentionConfig()
    warnings.warn(
        f"ops.attention({', '.join(sorted(passed))}=…) is deprecated; pass "
        f"config=AttentionConfig(...) instead (legacy kwargs are removed "
        f"next release)", DeprecationWarning, stacklevel=3)
    if config is not None:
        raise ValueError("pass either config=AttentionConfig(...) or the "
                         f"legacy kwargs {sorted(passed)}, not both")
    return AttentionConfig(**passed)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale=None, q_offset=0, k_offset=0, impl: str = "auto",
              config: AttentionConfig | None = None, block_k=_UNSET,
              acc_dtype=_UNSET, gqa_broadcast=_UNSET):
    """GQA/MQA attention.  q: [B, Tq, H, D]; k, v: [B, Tk, Hkv, D] with H a
    multiple of Hkv.

    `q_offset` / `k_offset` are the absolute positions of q[:, 0] and
    k[:, 0] (decode at a cache index, ring caches): each an int, or an int
    tensor ``[B]`` with one per batch row, on every impl.  An int gives the
    JAX package's semantics exactly.  ``block_k=`` / ``acc_dtype=`` /
    ``gqa_broadcast=`` are deprecated aliases of the `AttentionConfig`
    fields."""
    config = _translate_legacy_attn_kwargs(
        config, dict(block_k=block_k, acc_dtype=acc_dtype,
                     gqa_broadcast=gqa_broadcast))
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"inconsistent attention operands: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or H % Hkv != 0:
        raise ValueError(
            f"GQA requires query heads divisible by kv heads; got H={H} "
            f"query heads vs Hkv={Hkv} kv heads (q {tuple(q.shape)}, k "
            f"{tuple(k.shape)})")
    impl = resolve_impl("attention", impl, q.device)
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset,
              k_offset=k_offset)
    if impl == "ref":
        call = lambda: ref_attention(q, k, v, **kw)
    elif impl == "blockwise":
        call = lambda: _blockwise_attention(
            q, k, v, **kw, block_k=config.block_k or 1024,
            acc_dtype=config.acc_dtype, gqa_broadcast=config.gqa_broadcast)
    else:
        call = lambda: flash_attention_cuda(q, k, v, **kw)
    if not _kprof.PROFILER.enabled():
        return call()
    Tk = k.shape[1]
    traffic = attention_traffic_bytes(impl, B, Tq, Tk, H, Hkv, D,
                                      itemsize=q.element_size(),
                                      kv_itemsize=k.element_size())
    key = attention_key(B, Tq, Tk, H, Hkv, D, causal=causal, window=window,
                        backend=q.device.type)
    return _kprof.dispatch("attention", impl, key, traffic, call,
                           traced=_kprof.is_traced(q, k, v),
                           device=q.device)


# ---------------------------------------------------------------------------
# wkv6
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WkvConfig:
    """Chunking spec for `wkv6`'s blockwise version (the chunk length
    bounds the exp dynamic range of the closed form; see `kernels/wkv6.py`).
    The CUDA kernel reads no chunk from it: its variant, chunk and
    sub-chunk come from `wkv6_geometry`, which has no knob a user sets."""
    chunk: int = 64


def wkv6(r, k, v, logw, u, state=None, *, impl: str = "auto",
         config: WkvConfig | None = None, chunk: int | None = None):
    """RWKV6 WKV.  r, k, logw: [B, T, H, K]; v: [B, T, H, V]; u: [H, K];
    state: [B, H, K, V] or None → (o [B, T, H, V], S_T [B, H, K, V] fp32).

    ``config=WkvConfig(chunk=…)`` is the spec'd surface; ``chunk=`` stays
    as an alias that beats it.  "cuda" and "blockwise" return o in r's
    dtype, "ref" in fp32 (as the JAX oracle does)."""
    impl = resolve_impl("wkv6", impl, r.device)
    chunk = chunk if chunk is not None else (config or WkvConfig()).chunk
    if impl == "ref":
        call = lambda: ref_wkv6(r, k, v, logw, u, state)
    elif impl == "blockwise":
        call = lambda: wkv6_chunked(r, k, v, logw, u, state, chunk=chunk)
    else:
        call = lambda: wkv6_cuda(
            *(t.contiguous() for t in (r, k, v, logw)),
            u.to(torch.float32).contiguous(),
            None if state is None else state.to(torch.float32).contiguous())
    if not _kprof.PROFILER.enabled():
        return call()
    B, T, H, K = r.shape
    V = v.shape[-1]
    it = r.element_size()
    rkw = 3 * B * T * H * K * it            # r, k and per-step decay logw
    vb = 2 * B * T * H * V * it             # v in, wkv out
    st = 2 * B * H * K * V * 4              # state read + write (f32)
    traffic = {"rkw": rkw, "v": vb, "state": st, "u": H * K * it,
               "total": rkw + vb + st + H * K * it}
    key = f"wkv6|{r.device.type}|b{B}|t{T}|h{H}|k{K}|v{V}|c{chunk}"
    return _kprof.dispatch("wkv6", impl, key, traffic, call,
                           traced=_kprof.is_traced(r, k, v, logw, u, state),
                           device=r.device)
