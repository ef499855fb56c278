"""The kernel-call surface of the port (counterpart of `repro.kernels.ops`:
`log_matmul`, `conv2d`, `attention` and `wkv6`).

Every op takes the dispatch knob ``impl=``, resolved by `resolve_impl`:

  "cuda"      — the op's hand-written CUDA kernel (`log_matmul_cuda`,
                `log_conv2d_fused`, `flash_attention_cuda`, `wkv6_cuda`);
                on a CPU tensor its wrapper runs the op's plain version
  "cuda_im2col" — conv2d only: explicit im2col onto `log_matmul_cuda`
                (JAX's "pallas_im2col")
  "blockwise" — plain PyTorch: decode then matmul, decode then `F.conv2d`,
                online softmax over kv chunks, the chunked WKV closed form
  "ref"       — the full-materialisation oracles (tests)
  "auto"      — "cuda" for a CUDA tensor, "blockwise" for a CPU tensor

plus a per-op frozen config: ``ConvConfig`` for the grouped-conv layout
and B1's launch knobs, ``AttentionConfig`` for the blockwise version's
chunk and math knobs and B3's split count, ``WkvConfig(chunk=...)`` for
the chunked WKV.  With ``impl="cuda"`` the launch knobs a config leaves
unset come from the autotune tables (`kernels/autotune.py`) under the
``cuda`` backend key, whatever the tensors' device, or else from the
geometry's heuristic; ``autotune=True`` measures them first (on the card).

While the kernel-dispatch profiler is on (`obs.kernel_profile`), every op
goes through `kernel_profile.dispatch` with its shape key and analytic
bytes, in the formats of `repro.kernels.ops`; while it is off, neither is
computed.

While the dry run's counter is installed (`set_counter`, by
`launch/dryrun.py`), every op counts as one unit of work, its FLOPs by the
kernel's arithmetic and its bytes those of its operands and results, on
every impl: a step counts the same on the card, where the kernel runs, as
on ``meta`` tensors, where the plain version runs uncounted.

Under a mesh (`models.sharding`), an op given DTensor operands reaches its
kernel through `local_map`, with placements written out per op
(`_sharded_log_matmul`, `_sharded_attention`, `_sharded_wkv6`,
`_sharded_conv2d`): each rank's kernel runs on its own shard, never on a
gathered global copy, and on a CPU rank the plain version runs under the
same placements.  On plain tensors nothing of this runs.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any

import torch
import torch.nn.functional as F

from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.core.logquant import (LogQuantConfig, QuantizedTensor,
                                       quantize_tensor)
from repro_torch.models import sharding as _sharding
from repro_torch.obs import kernel_profile as _kprof
from . import autotune as _autotune
from .autotune import attention_key, conv_key
from .flash_attention import (_aligned16, attention_traffic_bytes,
                              flash_attention_cuda, flash_attention_geometry,
                              takes_mma)
from .log_conv2d import (conv_traffic_bytes, knob_args, lane_unpack_codes,
                         log_conv2d_blockwise, log_conv2d_fused,
                         log_conv2d_geometry, log_conv2d_im2col,
                         log_conv2d_ref, sm_count)
from .log_matmul import log_matmul_cuda
from .ref import positions, ref_attention, ref_log_matmul, ref_wkv6
from .wkv6 import wkv6_chunked, wkv6_cuda

_OP_IMPLS = {
    "log_matmul": ("cuda", "blockwise", "ref"),
    "conv2d": ("cuda", "cuda_im2col", "blockwise", "ref"),
    "attention": ("cuda", "blockwise", "ref"),
    "wkv6": ("cuda", "blockwise", "ref"),
}


_COUNTER = None  # the dry run's counter (`launch.dryrun.Count`) or None


def set_counter(counter):
    """Install the dry run's counter (None removes it); returns the one it
    replaces.  The counter's ``kernel(op, call, inputs, work)`` runs
    ``call`` and counts it."""
    global _COUNTER
    old, _COUNTER = _COUNTER, counter
    return old


def _counted(op: str, call, inputs, work):
    """``call`` as the installed counter sees it: ``inputs`` are the
    tensors the op reads, ``work(out)`` its (flops, transcendentals).  An
    op under autograd runs its plain version on every device (the kernels
    refuse grad) and is counted op by op."""
    counter = _COUNTER
    if counter is None or (torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in inputs)):
        return call
    return lambda *a, **k: counter.kernel(op, lambda: call(*a, **k),
                                          inputs, work)


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
    if _sharding.is_sharded(x, qt.packed, qt.scale):
        return _sharded_log_matmul(x, qt, impl)
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
    call = _counted("log_matmul", call, (x2, qt.packed, scale),
                    lambda y: (y.numel() * (2 * K + 1), 0))
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
    """Layout and launch spec for `conv2d`.

    ``lane_pack`` says whether a `QuantizedTensor`'s baked ``"lane_packed"``
    layout may ride onto the kernel: ``None`` (or the baked factor) uses it
    as stored; any other value (``1`` = off) unpacks it to HWIO first.  An
    explicit value beats the baked layout.  The CUDA kernel reads natural
    HWIO codes as well as packed ones, so HWIO codes are never packed per
    call.

    ``splits`` (the dense path's split-K shares) and ``tile`` (the
    depthwise path's ``(th, tw, ct)``) are B1's launch knobs; each path
    reads its own.  Precedence: an explicit value here beats the autotune
    table, which beats the geometry's heuristic (`log_conv2d_geometry`);
    an explicit knob that breaks the launcher's contract raises
    ValueError."""
    lane_pack: int | None = None
    splits: int | None = None
    tile: tuple[int, int, int] | None = None


_WARNED_ONCE: set[str] = set()  # one-shot UserWarning dedupe, per process


def _warn_once(msg: str) -> None:
    if msg not in _WARNED_ONCE:
        _WARNED_ONCE.add(msg)
        warnings.warn(msg, UserWarning, stacklevel=4)


def _conv_config_dict(config) -> dict:
    """A `ConvConfig` or mapping → its explicit (non-None) fields, a tile
    as a tuple."""
    if config is None:
        return {}
    if isinstance(config, ConvConfig):
        config = dataclasses.asdict(config)
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in dict(config).items() if v is not None}


def _hashable_padding(padding):
    if isinstance(padding, (list, tuple)):
        return tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                     for p in padding)
    return padding


def _resolve_conv(x, packed, scale, qcfg, shape, explicit: dict,
                  autotune: bool, lane) -> dict:
    """B1's launch knobs for one call: an explicit field beats the autotune
    tiers, which beat the heuristic (None).  Resolved once a shape and
    process (`autotune.RESOLVED`), where the lookup is counted; a table
    config the launcher's contract refuses falls back to the heuristic
    with a one-shot warning, an explicit one raises."""
    B, H, W, C, K, Cout, stride, padding, groups = shape
    ck = ("conv2d", shape, qcfg,
          tuple(sorted(explicit.items())) if explicit else (), autotune)
    hit = _autotune.RESOLVED.get(ck)
    if hit is not None:
        return hit
    kw = dict(stride=stride, padding=padding, groups=groups)
    field = "tile" if C // groups == 1 else "splits"
    knobs = knob_args(explicit)
    if any(v is not None for v in knobs.values()):
        log_conv2d_geometry(B, H, W, C, K, Cout, **kw, **knobs)  # raises
    if autotune and field in explicit:
        _warn_once(f"ops.conv2d: autotune=True is a no-op because config= "
                   f"pins {field}; drop it to run the tuning sweep for this "
                   f"shape")
    if autotune and field not in explicit:
        tuned = _autotune.autotune_conv2d(x, packed, scale, qcfg, **kw,
                                          lane=lane)
    elif field not in explicit:
        key = _autotune.conv_key(B, H, W, C, K, Cout, cfg=qcfg, **kw)
        tuned = _autotune.lookup(key)
        if tuned:
            try:
                log_conv2d_geometry(B, H, W, C, K, Cout, **kw,
                                    **knob_args(tuned))
            except ValueError as e:
                _warn_once(f"ops.conv2d: the autotune table's {tuned} for "
                           f"{key} breaks the launcher's contract ({e}); the "
                           f"heuristic launches instead")
                tuned = None
    else:
        tuned = None
    config = {**_autotune.default_config(B, H, W, C, K, Cout, **kw),
              **knob_args(tuned),
              **{k: v for k, v in knobs.items() if v is not None}}
    _autotune.RESOLVED[ck] = config
    return config


def conv_knobs(x, qt, *, stride: int = 1, padding="SAME", groups: int = 1,
               config: ConvConfig | dict | None = None) -> dict:
    """The launch knobs (``splits``, ``tile``) with which
    ``conv2d(x, qt, impl="cuda", config=config)`` launches B1 on this
    call (for the traffic model and the checks of a caller)."""
    B, H, W, C = x.shape
    shape = (B, H, W, C, qt.shape[0], qt.shape[-1], stride,
             _hashable_padding(padding), groups)
    return _resolve_conv(x, None, None, qt.cfg, shape,
                         _conv_config_dict(config), False, None)


def conv2d(x, qt, *, stride: int = 1, padding="SAME", groups: int = 1,
           impl: str = "auto", out_dtype=None,
           qcfg: LogQuantConfig | None = None,
           config: ConvConfig | dict | None = None, autotune: bool = False):
    """x: [B, H, W, Cin] ⊛ dequant(qt [K, K, Cin//groups, Cout]) → NHWC out.

    `qt` is a `QuantizedTensor` of packed log codes in any of its layouts
    (natural, ``conv_taps``, ``lane_packed``); a plain float kernel is
    packed on the fly (inference only).  Supports stride,
    SAME/VALID/int/explicit padding and grouped/depthwise convs.

    With ``impl="cuda"`` the kernel's knobs come from ``config`` (a
    `ConvConfig` or mapping), filled field by field from the autotune
    tables and then the heuristic (`_resolve_conv`); ``autotune=True``
    measures the knob of the conv's path on the card first and persists
    the winner (a no-op, with a one-shot warning, where ``config`` pins
    it).  On a CPU tensor the knobs are resolved and checked, and the
    plain version runs.

    ``impl="cuda_im2col"`` (JAX's ``"pallas_im2col"``) builds the patches
    in device memory and runs every conv, grouped ones on block-diagonal
    codes, on the log_matmul kernel (`log_conv2d_im2col`); it has no
    launch knob, so no autotune lookup, and a ``lane_packed`` layout is
    unpacked to HWIO first.  On a CPU tensor its product is the plain
    `ref_log_matmul`."""
    if not isinstance(qt, QuantizedTensor):
        qt = quantize_tensor(torch.as_tensor(qt, device=x.device),
                             qcfg or LogQuantConfig())
    if _sharding.is_sharded(x, qt.packed, qt.scale):
        return _sharded_conv2d(x, qt, dict(
            stride=stride, padding=padding, groups=groups, impl=impl,
            out_dtype=out_dtype, config=config, autotune=autotune))
    impl = resolve_impl("conv2d", impl, x.device)
    explicit = _conv_config_dict(config)
    packed, lane = qt.packed, None
    if qt.layout == "conv_taps":
        packed = packed.reshape(qt.shape)  # [taps, cin_g, Cout] → HWIO view
    elif qt.layout == "lane_packed":
        # the baked layout rides onto the kernel when it matches this call;
        # any disagreement (other groups, a conflicting explicit lane_pack,
        # a plain impl) unpacks the codes to HWIO, which is always correct
        g_b, cin_lane, meta_groups = qt.layout_meta
        want = explicit.get("lane_pack")
        if impl == "cuda" and meta_groups == groups and want in (None, g_b):
            lane = (g_b, cin_lane)
        else:
            packed = lane_unpack_codes(packed, qt.shape, meta_groups, g_b,
                                       cin_lane)
    kw = dict(stride=stride, padding=padding, groups=groups)
    B, H, W, C = x.shape
    K, Cout = qt.shape[0], qt.shape[-1]
    knobs = None
    if impl == "cuda":
        knobs = _resolve_conv(
            x, packed, qt.scale, qt.cfg,
            (B, H, W, C, K, Cout, stride, _hashable_padding(padding), groups),
            explicit, autotune, lane)
        fn = functools.partial(log_conv2d_fused, lane=lane, config=knobs)
    else:
        fn = {"ref": log_conv2d_ref, "blockwise": log_conv2d_blockwise,
              "cuda_im2col": log_conv2d_im2col}[impl]

    def call(on_launch=None):
        # the kernel calls on_launch right before its launch, where the
        # profiler's timed span starts
        y = (fn(x, packed, qt.scale, qt.cfg, **kw) if on_launch is None
             else fn(x, packed, qt.scale, qt.cfg, on_launch=on_launch, **kw))
        return y if out_dtype is None else y.to(out_dtype)
    # the im2col route multiplies block-diagonal codes: all C per output
    cin = C if impl == "cuda_im2col" else C // groups
    call = _counted("conv2d", call, (x, packed, qt.scale),
                    lambda y: (y.numel() * (2 * K * K * cin + 1), 0))
    if not _kprof.PROFILER.enabled():
        return call()
    n_sm = sm_count(x.device.index) if x.is_cuda else 132
    traffic = conv_traffic_bytes(impl, B, H, W, C, K, Cout, **kw,
                                 act_itemsize=x.element_size(),
                                 bits=qt.cfg.bits, n_sm=n_sm, config=knobs)
    key = conv_key(B, H, W, C, K, Cout, **kw, cfg=qt.cfg,
                   backend=x.device.type)
    return _kprof.dispatch("conv2d", impl, key, traffic, call,
                           traced=_kprof.is_traced(x, packed),
                           device=x.device, marks_launch=impl == "cuda")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Math spec for `attention`'s blockwise version, and the CUDA
    kernel's one launch knob: ``splits``, the split-KV variant's chunk
    count (the tensor-core variant takes none).  Its other tiles come from
    `flash_attention.flash_attention_geometry`.  An explicit ``splits``
    beats the autotune table, which beats the geometry's heuristic."""
    block_k: int | None = None       # blockwise kv chunk (default 1024)
    acc_dtype: Any = torch.float32   # blockwise score/accum math dtype
    gqa_broadcast: bool = False      # blockwise: einsum-broadcast GQA
    splits: int | None = None        # cuda: split-KV chunks


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
    kp = F.pad(k, (0, 0, 0, 0, 0, pk)) if pk else k
    vp = F.pad(v, (0, 0, 0, 0, 0, pk)) if pk else v
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


def _resolve_attention(q, k, v, shape, explicit, autotune: bool,
                       scale) -> tuple[int | None, bool]:
    """B3's ``splits`` for one call → (splits, explicit?): an explicit value
    beats the autotune tiers, which beat the heuristic (None); resolved
    once a shape and process, as `_resolve_conv`.  A table value that the
    launcher's contract refuses falls back to the heuristic with a
    one-shot warning."""
    B, Tq, Tk, H, Hkv, D, causal, window = shape
    ck = ("attention", shape, explicit, autotune)
    hit = _autotune.RESOLVED.get(ck)
    if hit is not None:
        return hit
    if explicit is not None:     # checked by the wrapper, on every device
        if autotune:
            _warn_once("ops.attention: autotune=True is a no-op because "
                       "config= pins splits; leave it unset to run the "
                       "tuning sweep for this shape")
        hit = (explicit, True)
    elif autotune:
        hit = (_autotune.autotune_attention(
            q, k, v, causal=causal, window=window, scale=scale)["splits"],
            False)
    else:
        key = _autotune.attention_key(B, Tq, Tk, H, Hkv, D, causal=causal,
                                      window=window)
        tuned = (_autotune.lookup(key) or {}).get("splits")
        if tuned is not None:
            try:
                flash_attention_geometry(B, Tq, Tk, H, Hkv, D, torch.float32,
                                         torch.float32, splits=tuned)
            except ValueError as e:
                _warn_once(f"ops.attention: the autotune table's splits="
                           f"{tuned} for {key} breaks the launcher's "
                           f"contract ({e}); the heuristic launches instead")
                tuned = None
        hit = (tuned, False)
    _autotune.RESOLVED[ck] = hit
    return hit


def attention_knobs(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    config: AttentionConfig | None = None,
                    autotune: bool = False, scale=None) -> dict:
    """The launch knob (``splits``) with which ``attention(q, k, v,
    impl="cuda", config=config)`` launches B3 on this call: resolved once a
    shape (`_resolve_attention`), and None where a table's count meets a
    call that takes the tensor-core variant, which has none."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    splits, pinned = _resolve_attention(
        q, k, v, (B, Tq, Tk, H, Hkv, D, causal, window),
        None if config is None else config.splits, autotune, scale)
    if (splits is not None and not pinned and Tq > 1
            and takes_mma(Tq, D, q.dtype, k.dtype, _aligned16(q)
                          and _aligned16(k) and _aligned16(v))):
        splits = None
    return {"splits": splits}


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale=None, q_offset=0, k_offset=0, impl: str = "auto",
              config: AttentionConfig | None = None, autotune: bool = False,
              block_k=_UNSET, acc_dtype=_UNSET, gqa_broadcast=_UNSET):
    """GQA/MQA attention.  q: [B, Tq, H, D]; k, v: [B, Tk, Hkv, D] with H a
    multiple of Hkv.

    `q_offset` / `k_offset` are the absolute positions of q[:, 0] and
    k[:, 0] (decode at a cache index, ring caches): each an int, or an int
    tensor ``[B]`` with one per batch row, on every impl.  An int gives the
    JAX package's semantics exactly.  ``block_k=`` / ``acc_dtype=`` /
    ``gqa_broadcast=`` are deprecated aliases of the `AttentionConfig`
    fields.  With ``impl="cuda"``, ``config.splits`` left unset comes from
    the autotune tables or the heuristic (`_resolve_attention`;
    ``autotune=True`` measures it on the card first); a table's split
    count does not apply to a call that takes the tensor-core variant."""
    config = _translate_legacy_attn_kwargs(
        config, dict(block_k=block_k, acc_dtype=acc_dtype,
                     gqa_broadcast=gqa_broadcast))
    if _sharding.is_sharded(q, k, v):
        return _sharded_attention(q, k, v, q_offset, k_offset, dict(
            causal=causal, window=window, scale=scale, impl=impl,
            config=config, autotune=autotune))
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
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
    knobs = None
    if impl == "ref":
        call = lambda: ref_attention(q, k, v, **kw)
    elif impl == "blockwise":
        call = lambda: _blockwise_attention(
            q, k, v, **kw, block_k=config.block_k or 1024,
            acc_dtype=config.acc_dtype, gqa_broadcast=config.gqa_broadcast)
    else:
        knobs = attention_knobs(q, k, v, causal=causal, window=window,
                                config=config, autotune=autotune,
                                scale=scale)
        call = lambda: flash_attention_cuda(q, k, v, **kw, config=knobs)
    # two products and the online softmax's max, subtract, mask and sum a
    # score, over every key (as the blockwise version and JAX's count it)
    scores = B * H * Tq * Tk
    call = _counted("attention", call, (q, k, v),
                    lambda o: (scores * (4 * D + 4), scores))
    if not _kprof.PROFILER.enabled():
        return call()
    traffic = attention_traffic_bytes(impl, B, Tq, Tk, H, Hkv, D,
                                      itemsize=q.element_size(),
                                      kv_itemsize=k.element_size(),
                                      config=knobs)
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
    if _sharding.is_sharded(r, k, v, logw, u, state):
        return _sharded_wkv6(r, k, v, logw, u, state,
                             dict(impl=impl, config=config, chunk=chunk))
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
    # a token and head: k·vᵀ, the decayed state plus it, the bonus u·k·vᵀ
    # added, r against the sum (2), per state element; one exp a decay
    Bw, Tw, Hw, Kw = r.shape
    call = _counted("wkv6", call, (r, k, v, logw, u, state),
                    lambda o: (7 * Bw * Tw * Hw * Kw * v.shape[-1],
                               Bw * Tw * Hw * Kw))
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


# ---------------------------------------------------------------------------
# under a mesh
# ---------------------------------------------------------------------------


def _mesh_of(*xs):
    return next(x.device_mesh for x in xs if _sharding.is_sharded(x))


def _model_dim(mesh):
    names = mesh.mesh_dim_names
    return names.index("model") if "model" in names else None


def _batch_placements(mesh, *xs) -> list:
    """Dim 0 (the batch) ``Shard(0)`` on each batch axis (pod, data) where
    one of ``xs`` has it there, every other mesh dim replicated: a decode
    step's query, which comes out of its projection ``Partial`` over
    ``data``, is then reduce-scattered to the cache's batch split, where
    taking the query's placement would gather the whole cache."""
    return [Shard(0) if (name in ("pod", "data")
                         and any(x.placements[i] == Shard(0) for x in xs))
            else Replicate()
            for i, name in enumerate(mesh.mesh_dim_names)]


def _on_model(pl: list, m, placement) -> list:
    pl = list(pl)
    if m is not None:
        pl[m] = placement
    return pl


def _sharded_log_matmul(x, qt, impl):
    """B2 on each rank's shard.  The codes are gathered over the batch axes
    (FSDP) and keep their ``model`` split: an ``(F, T)`` leaf's codes are
    ``Shard(1)`` (x replicated on ``model``, the output sharded on its last
    dim), a ``(T, F)`` leaf's ``Shard(0)`` (x ``Shard(-1)``, a ``Partial``
    output); codes replicated on ``model`` give a replicated output."""
    mesh = _mesh_of(x, qt.packed, qt.scale)
    x, packed, scale = (_sharding.replicated(t, mesh)
                        for t in (x, qt.packed, qt.scale))
    m, rep = _model_dim(mesh), [Replicate()] * mesh.ndim
    kind = packed.placements[m] if m is not None else Replicate()
    column = kind == Shard(packed.ndim - 1)
    row = kind == Shard(packed.ndim - 2)
    pl_x = _batch_placements(mesh, x)
    pl_out = _on_model(pl_x, m, Shard(x.ndim - 1) if column
                       else Partial() if row else Replicate())
    pl_x = _on_model(pl_x, m, Shard(x.ndim - 1) if row else Replicate())
    pl_codes = _on_model(rep, m, kind if (column or row) else Replicate())
    per_channel = scale.ndim >= 1 and scale.shape[-1] == packed.shape[-1]
    pl_scale = _on_model(rep, m, Shard(scale.ndim - 1)
                         if column and per_channel else Replicate())

    def local(xl, pl, sl):
        return log_matmul(xl, QuantizedTensor(pl, sl, qt.cfg,
                                              tuple(pl.shape)), impl=impl)
    return local_map(local, out_placements=pl_out,
                     in_placements=(pl_x, pl_codes, pl_scale),
                     redistribute_inputs=True)(x, packed, scale)


def _offset(off, mesh, pl_batch):
    """A per-row offset tensor [B] as a DTensor split like the batch; an
    int as is."""
    if not torch.is_tensor(off):
        return off, None
    return _sharding.replicated(off, mesh), pl_batch


def _sharded_attention(q, k, v, q_offset, k_offset, kw):
    """B3 on each rank's shard: the batch as q has it on (pod, data), the
    heads of q and k/v ``Shard(2)`` on ``model`` when both head counts
    divide it, else replicated."""
    mesh = _mesh_of(q, k, v)
    q, k, v = (_sharding.replicated(t, mesh) for t in (q, k, v))
    m = _model_dim(mesh)
    msz = mesh.size(m) if m is not None else 1
    heads = q.shape[2] % msz == 0 and k.shape[2] % msz == 0
    pl_b = _batch_placements(mesh, q, k, v)
    pl = _on_model(pl_b, m, Shard(2) if heads else Replicate())
    qo, pl_qo = _offset(q_offset, mesh, pl_b)
    ko, pl_ko = _offset(k_offset, mesh, pl_b)

    def local(ql, kl, vl, qol, kol):
        return attention(ql, kl, vl, q_offset=qol, k_offset=kol, **kw)
    return local_map(local, out_placements=pl,
                     in_placements=(pl, pl, pl, pl_qo, pl_ko),
                     redistribute_inputs=True)(q, k, v, qo, ko)


def _sharded_wkv6(r, k, v, logw, u, state, kw):
    """B4 on each rank's shard: the batch as r has it on (pod, data), the
    heads ``Shard`` on ``model`` (dim 2 of r/k/v/logw/o, 0 of u, 1 of the
    state) when they divide it, else replicated."""
    mesh = _mesh_of(r, k, v, logw, u, state)
    r, k, v, logw, u, state = (_sharding.replicated(t, mesh)
                               for t in (r, k, v, logw, u, state))
    m = _model_dim(mesh)
    heads = m is None or r.shape[2] % mesh.size(m) == 0
    pl_b = _batch_placements(mesh, r)
    pl_x = _on_model(pl_b, m, Shard(2) if heads else Replicate())
    pl_s = _on_model(pl_b, m, Shard(1) if heads else Replicate())
    pl_u = _on_model([Replicate()] * mesh.ndim, m,
                     Shard(0) if heads else Replicate())

    def local(rl, kl, vl, wl, ul, sl):
        return wkv6(rl, kl, vl, wl, ul, sl, **kw)
    return local_map(local, out_placements=(pl_x, pl_s),
                     in_placements=(pl_x, pl_x, pl_x, pl_x, pl_u,
                                    None if state is None else pl_s),
                     redistribute_inputs=True)(r, k, v, logw, u, state)


def _sharded_conv2d(x, qt, kw):
    """B1 replicated on every rank (the CNN has no sharding constraint)."""
    mesh = _mesh_of(x, qt.packed, qt.scale)
    x, packed, scale = (_sharding.replicated(t, mesh)
                        for t in (x, qt.packed, qt.scale))
    rep = [Replicate()] * mesh.ndim

    def local(xl, pl, sl):
        return conv2d(xl, QuantizedTensor(pl, sl, qt.cfg, qt.shape,
                                          qt.layout, qt.layout_meta), **kw)
    return local_map(local, out_placements=rep, in_placements=(rep,) * 3,
                     redistribute_inputs=True)(x, packed, scale)
