"""Op-keyed launch-knob tuner for the CUDA kernels (counterpart of
`repro.kernels.autotune`).

The paper's per-layer schedule is a compile-time choice; here it is the
launch knobs the CUDA launchers take at run time, so a tuned launch needs
no rebuild:

  * ``conv2d|…`` entries hold B1's knobs: ``splits`` (the dense path's
    split-K shares, `log_conv2d.dense_shares`) and ``tile`` (the depthwise
    path's ``(th, tw, ct)``, `log_conv2d._check_tile`);
  * ``attention|…`` entries hold B3's ``splits`` (the split-KV variant's
    chunks; the tensor-core variant takes none).

``None`` for a knob means the geometry's heuristic.  B2 (`log_matmul`) has
no namespace, as in the JAX package.

Table format (JSON, atomic rename on write):

    {"version": SCHEMA_VERSION,
     "entries": {"<op>|<key>": {"config": {...}, "us": 12.3, "when": ...}}}

Keys carry everything that changes the launch, in the JAX package's
format with the backend ``cuda``: op, quant config, layer shape,
stride/padding/groups (conv) or sequence lengths/head counts/masking
(attention).  Invalidation is by `SCHEMA_VERSION`.

Resolution is layered, as in the JAX package:

  1. the writable **user tier** — ``$REPRO_TORCH_AUTOTUNE_PATH`` if set,
     else ``~/.cache/repro_torch/kernel_autotune.json`` (never the JAX
     package's file) — where ``record()`` lands tuning winners;
  2. the read-only **packaged tier** —
     ``src/repro_torch/kernels/autotune_tables/cuda.json``, entries for the
     four paper CNNs' conv shapes at batch 1 and 8 and the serving
     attention shapes, built by ``python -m
     repro_torch.tools.build_autotune_table``.

`ops.conv2d(impl="cuda")` and `ops.attention(impl="cuda")` resolve a
shape's knobs once per process (`RESOLVED`, cleared by `reset_cache` and
`record`): an explicit config field beats the tiers, which beat the
heuristic.  The `autotune_lookup` counter splits
``hit_user``/``hit_warm``/``miss`` per op at that resolution;
`autotune_sweep` counts measured sweeps (``autotune=True``,
`autotune_conv2d`, `autotune_attention`), which time candidates on the
card by CUDA events and hold each against the plain version first.
"""

from __future__ import annotations

import json
import math
import os
import time

import torch

from repro_torch.core.logquant import LogQuantConfig
from repro_torch.obs import metrics as _obs_metrics
from . import flash_attention as _fa
from . import log_conv2d as _lc

# v1: B1's splits / tile and B3's splits, the CUDA launchers' run-time knobs
SCHEMA_VERSION = 1

# the split-K / split-KV fp32 partials a candidate launch may allocate
PARTIALS_BUDGET_BYTES = 64 << 20

ENV_PATH = "REPRO_TORCH_AUTOTUNE_PATH"

_CACHE: dict | None = None  # lazy-loaded user tier, reset via reset_cache()
_PACKAGED: dict[str, dict] | None = None  # backend → packaged-tier entries
# shape → resolved knobs, filled by `ops` once per shape and process
RESOLVED: dict = {}

# the read-only packaged tier ships inside the package; tests repoint this
# attribute at a temp dir to isolate themselves from it
PACKAGED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "autotune_tables")


def table_path() -> str:
    p = os.environ.get(ENV_PATH)
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "kernel_autotune.json")


def packaged_table_path(backend: str) -> str:
    return os.path.join(PACKAGED_DIR, f"{backend}.json")


def key_backend(key: str) -> str:
    """The backend field of a namespaced key (``<op>|<backend>|…``)."""
    parts = key.split("|")
    return parts[1] if len(parts) > 1 else ""


def reset_cache() -> None:
    global _CACHE, _PACKAGED
    _CACHE = None
    _PACKAGED = None
    RESOLVED.clear()


def _load() -> dict:
    global _CACHE
    if _CACHE is None:
        _CACHE = {"version": SCHEMA_VERSION, "entries": {}}
        try:
            with open(table_path()) as f:
                t = json.load(f)
            if t.get("version") == SCHEMA_VERSION:
                _CACHE = t
        except (OSError, ValueError):
            pass
    return _CACHE


def _load_packaged(backend: str) -> dict:
    """Entries of the read-only packaged tier for one backend (lazy; an
    absent/corrupt/stale-schema file is an empty tier, never an error)."""
    global _PACKAGED
    if _PACKAGED is None:
        _PACKAGED = {}
    if backend not in _PACKAGED:
        entries: dict = {}
        try:
            with open(packaged_table_path(backend)) as f:
                t = json.load(f)
            if t.get("version") == SCHEMA_VERSION:
                entries = t.get("entries", {})
        except (OSError, ValueError):
            pass
        _PACKAGED[backend] = entries
    return _PACKAGED[backend]


def _save(table: dict) -> None:
    path = table_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def conv_key(B, H, W, C, K, Cout, *, stride=1, padding="SAME", groups=1,
             cfg: LogQuantConfig = LogQuantConfig(),
             backend: str = "cuda") -> str:
    """Everything that changes the conv launch, as one namespaced key, in
    the format of `repro.kernels.autotune.conv_key`."""
    (ph0, ph1), (pw0, pw1) = _lc.normalize_padding(padding, K, stride, H, W)
    return (f"conv2d|{backend}|q{cfg.bits}.{cfg.frac_bits}"
            f"|x{B}x{H}x{W}x{C}|k{K}o{Cout}|s{stride}|g{groups}"
            f"|p{ph0}.{ph1}.{pw0}.{pw1}")


def attention_key(B, Tq, Tk, H, Hkv, D, *, causal=True, window=None,
                  backend: str = "cuda") -> str:
    """Everything that changes the attention launch, as one namespaced key,
    in the format of `repro.kernels.autotune.attention_key`."""
    return (f"attention|{backend}|b{B}|q{Tq}|k{Tk}|h{H}.{Hkv}|d{D}"
            f"|c{int(bool(causal))}|w{window if window is not None else '-'}")


def lookup(key: str) -> dict | None:
    """Layered resolution: the writable user tier shadows the packaged
    warm-start tier.  Per-op result counters (`autotune_lookup`, labels
    ``result=hit_user|hit_warm|miss``) make warm-start effectiveness a
    first-class metric."""
    entry = _load()["entries"].get(key)
    result = "hit_user"
    if entry is None:
        entry = _load_packaged(key_backend(key)).get(key)
        result = "hit_warm" if entry else "miss"
    _obs_metrics.REGISTRY.counter(
        "autotune_lookup", op=key.split("|", 1)[0], result=result).inc()
    return dict(entry["config"]) if entry else None


def record(key: str, config: dict, us: float) -> None:
    """Persist one tuning winner to the user tier (the packaged tier is
    read-only — `record` never touches it).

    The write merges, not clobbers: the on-disk entries are re-read
    immediately before the atomic replace, so entries landed by a
    concurrent process survive.  This process's own entries win any key
    conflict.  Clears the per-process resolutions (`RESOLVED`)."""
    table = _load()
    table["entries"][key] = {"config": dict(config), "us": round(us, 2),
                             "when": time.strftime("%Y-%m-%dT%H:%M:%S")}
    try:
        with open(table_path()) as f:
            disk = json.load(f)
    except (OSError, ValueError):
        disk = None
    if isinstance(disk, dict) and disk.get("version") == SCHEMA_VERSION:
        merged = dict(disk.get("entries", {}))
        merged.update(table["entries"])
        table["entries"] = merged
    _save(table)
    RESOLVED.clear()


# ---------------------------------------------------------------------------
# conv config space
# ---------------------------------------------------------------------------


def default_config(B, H, W, C, K, Cout, *, stride=1, padding="SAME",
                   groups=1) -> dict:
    """Knobs on a table miss: none, so `log_conv2d_geometry` picks the
    heuristic's shares (dense) or tile (depthwise) for the card it runs
    on."""
    return dict(splits=None, tile=None)


def _heuristic(B, H, W, C, K, Cout, stride, padding, groups, n_sm) -> dict:
    """The heuristic's own knobs, as an explicit config."""
    g = _lc.log_conv2d_geometry(B, H, W, C, K, Cout, stride, padding, groups,
                                n_sm)
    if g["path"] == "depthwise":
        return dict(splits=None, tile=list(g["tile"]))
    return dict(splits=g["splits"], tile=None)


def _distance(config: dict, heur: dict) -> float:
    """How far a candidate's knobs lie from the heuristic's (log2 steps)."""
    if config["tile"] is not None:
        return sum(abs(math.log2(a) - math.log2(b))
                   for a, b in zip(config["tile"], heur["tile"]))
    return abs(math.log2(config["splits"]) - math.log2(heur["splits"]))


def candidate_configs(B, H, W, C, K, Cout, *, stride=1, padding="SAME",
                      groups=1, n_sm: int = 132,
                      budget: int = PARTIALS_BUDGET_BYTES,
                      max_candidates: int | None = 12) -> list[dict]:
    """Candidate knobs for one conv, each within the launcher's contract,
    deduped after clamping, the heuristic's own first and the others by
    their distance from it (``max_candidates`` at most; None for all).

    Dense: share counts from 1 to the stage count (each as the count of
    shares its share size gives), those whose fp32 partials
    (``splits x M x Cout x 4`` bytes) exceed ``budget`` left out.
    Depthwise: ``(th, tw, ct)`` tiles with ``ct`` in {4, 8, 16, 32} up to
    the power of two that holds Cout, ``tw`` in {4, 8, 12, 16} up to Wo
    rounded to 4, and every near-equal ``th`` (``ceil(Ho / n)``) that keeps
    the tile within the threads and shared memory of a block."""
    pads = _lc.normalize_padding(padding, K, stride, H, W)
    Ho = _lc._out_size(H, K, stride, pads[0])
    Wo = _lc._out_size(W, K, stride, pads[1])
    heur = _heuristic(B, H, W, C, K, Cout, stride, padding, groups, n_sm)
    out = [heur]
    if heur["tile"] is not None:
        ct_max = max(4, 4 * _lc._next_pow2(-(-Cout // 4)))
        tws = sorted({tw for tw in (4, 8, 12, 16) if tw <= -(-Wo // 4) * 4})
        ths = sorted({-(-Ho // n) for n in range(1, Ho + 1)})
        for ct in (c for c in (4, 8, 16, 32) if c <= ct_max):
            for tw in tws:
                for th in ths:
                    tile = [th, tw, ct]
                    if tile == heur["tile"]:
                        continue
                    try:
                        _lc._check_tile(tile, K, stride)
                    except ValueError:
                        continue
                    out.append(dict(splits=None, tile=tile))
    else:
        g = _lc.log_conv2d_geometry(B, H, W, C, K, Cout, stride, padding,
                                    groups, n_sm)
        M = B * Ho * Wo
        seen = {heur["splits"]}
        for want in range(1, g["stages"] + 1):
            s = -(-g["stages"] // -(-g["stages"] // want))
            if s in seen or (s > 1 and s * M * Cout * 4 > budget):
                continue
            seen.add(s)
            out.append(dict(splits=s, tile=None))
    out[1:] = sorted(out[1:], key=lambda c: (_distance(c, heur),
                                             json.dumps(c)))
    return out if max_candidates is None else out[:max_candidates]


# ---------------------------------------------------------------------------
# attention config space
# ---------------------------------------------------------------------------


def default_attention_config(B, Tq, Tk, H, Hkv, D) -> dict:
    """Knobs on a table miss: none, so `flash_attention_geometry` picks the
    heuristic's split count for the card it runs on."""
    return dict(splits=None)


def attention_candidate_configs(B, Tq, Tk, H, Hkv, D, *,
                                q_dtype=torch.float32, kv_dtype=None,
                                n_sm: int = 132,
                                budget: int = PARTIALS_BUDGET_BYTES,
                                max_candidates: int | None = 12
                                ) -> list[dict]:
    """Candidate split counts of the split-KV variant (1 to the stage count
    or ``MAX_SPLITS``, each as the count its chunk length gives, whose
    partials fit ``budget``), the heuristic's first and the others by
    their distance from it; the tensor-core variant has one, 1."""
    kv_dtype = kv_dtype or q_dtype
    g = _fa.flash_attention_geometry(B, Tq, Tk, H, Hkv, D, q_dtype, kv_dtype,
                                     n_sm)
    heur = dict(splits=g["splits"])
    if g["variant"] == "mma":
        return [heur]
    stages = -(-Tk // _fa.SPLIT_KEYS)
    tiles = B * Hkv * g["row_blocks"]
    out, seen = [heur], {g["splits"]}
    for want in range(1, min(_fa.MAX_SPLITS, stages) + 1):
        kps = -(-stages // want) * _fa.SPLIT_KEYS
        s = -(-Tk // kps)
        if s in seen or s * tiles * g["rows"] * (_fa.MAX_HEAD_DIM + 2) * 4 \
                > budget:
            continue
        seen.add(s)
        out.append(dict(splits=s))
    out[1:] = sorted(out[1:], key=lambda c: (
        abs(math.log2(c["splits"]) - math.log2(heur["splits"])),
        c["splits"]))
    return out if max_candidates is None else out[:max_candidates]


# ---------------------------------------------------------------------------
# measurement (on the card)
# ---------------------------------------------------------------------------


def _device_us(fn, reps: int) -> float:
    """µs of device time a call of ``fn``: after a build and a warm call,
    the stream is held by a sleep kernel while ``reps`` calls are queued,
    so the CUDA events around them time the kernels back to back and not
    the host's launches."""
    fn()
    torch.cuda.synchronize()
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * reps)    # ~1 ms a call to queue under
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps * 1e3


def _needs_card(what: str, t: torch.Tensor, reps: int) -> None:
    if reps < 1:
        raise ValueError(
            f"{what} needs reps >= 1 to time a candidate (device time over "
            f"reps calls), got reps={reps}")
    if t.device.type != "cuda":
        raise ValueError(f"{what} times the CUDA kernel on the card; got a "
                         f"{t.device.type} tensor")


def autotune_conv2d(x, packed, scale, qcfg: LogQuantConfig, *, stride=1,
                    padding="SAME", groups=1, lane=None, reps: int = 3,
                    max_candidates: int = 12) -> dict:
    """Measure candidate knobs for this conv on the card, persist and
    return the best.

    ``packed`` is natural HWIO codes or, with ``lane=(g_b, cin_lane)``,
    lane-packed ones, as `log_conv2d_fused` takes them.  Each candidate's
    output is held against `log_conv2d_blockwise` within
    ``1e-4·(max|y|+1)`` before it is timed (a candidate that disagrees
    raises); its time is device time (`_device_us`).  The winner lands in
    the user tier under ``conv_key(...)``."""
    _needs_card("autotune_conv2d", x, reps)
    _obs_metrics.REGISTRY.counter("autotune_sweep", op="conv2d").inc()
    B, H, W, C = x.shape
    if lane is None:
        K, Cout, codes = packed.shape[0], packed.shape[-1], packed
    else:
        K = int(round(packed.shape[1] ** 0.5))
        Cout = groups * packed.shape[-1]
        codes = _lc.lane_unpack_codes(packed, (K, K, C // groups, Cout),
                                      groups, lane[0], lane[1])
    shape_kw = dict(stride=stride, padding=padding, groups=groups)
    key = conv_key(B, H, W, C, K, Cout, cfg=qcfg, **shape_kw)
    want = _lc.log_conv2d_blockwise(x, codes, scale, qcfg, **shape_kw)
    tol = 1e-4 * (float(want.abs().max()) + 1)
    best, best_us = None, float("inf")
    for config in candidate_configs(B, H, W, C, K, Cout, **shape_kw,
                                    n_sm=_lc.sm_count(x.device.index),
                                    max_candidates=max_candidates):
        def fn():
            return _lc.log_conv2d_fused(x, packed, scale, qcfg, lane=lane,
                                        config=config, **shape_kw)
        err = float((fn() - want).abs().max())
        if not err <= tol:
            raise RuntimeError(f"autotune_conv2d: candidate {config} for "
                               f"{key} is off the plain version by {err:.3e}"
                               f" (tolerance {tol:.3e})")
        us = _device_us(fn, reps)
        if us < best_us:
            best, best_us = config, us
    record(key, best, best_us)
    return dict(best)


def autotune_attention(q, k, v, *, causal=True, window=None, scale=None,
                       reps: int = 3, max_candidates: int = 12) -> dict:
    """Measure candidate split counts for this attention shape on the card,
    persist and return the best.

    Each candidate's output is held against `ref.ref_attention` within
    ``2e-4·(max|o|+1)`` (``8e-3`` with a bf16 q) before it is timed;
    the time is device time (`_device_us`).  Offsets don't enter the key,
    as in the JAX package."""
    from .ref import ref_attention
    _needs_card("autotune_attention", q, reps)
    _obs_metrics.REGISTRY.counter("autotune_sweep", op="attention").inc()
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    key = attention_key(B, Tq, Tk, H, Hkv, D, causal=causal, window=window)
    kw = dict(causal=causal, window=window, scale=scale)
    want = ref_attention(q, k, v, **kw).float()
    rel = 8e-3 if q.dtype == torch.bfloat16 else 2e-4
    tol = rel * (float(want.abs().max()) + 1)
    if _fa.takes_mma(Tq, D, q.dtype, k.dtype, _fa._aligned16(q)
                     and _fa._aligned16(k) and _fa._aligned16(v)):
        configs = [default_attention_config(B, Tq, Tk, H, Hkv, D)]
    else:
        configs = attention_candidate_configs(
            B, Tq, Tk, H, Hkv, D, q_dtype=torch.float32,
            n_sm=_lc.sm_count(q.device.index), max_candidates=max_candidates)
    best, best_us = None, float("inf")
    for config in configs:
        def fn():
            return _fa.flash_attention_cuda(q, k, v, **kw, config=config)
        err = float((fn().float() - want).abs().max())
        if not err <= tol:
            raise RuntimeError(f"autotune_attention: candidate {config} for "
                               f"{key} is off the plain version by {err:.3e}"
                               f" (tolerance {tol:.3e})")
        us = _device_us(fn, reps)
        if us < best_us:
            best, best_us = config, us
    record(key, best, best_us)
    return dict(best)
