"""Build (or check) the packaged autotune table of the CUDA kernels.

The twin of the JAX package's `tools/build_autotune_table.py`.  It walks
the model zoo (`models/cnn.py` `CNN_ZOO` at `configs/neuromax_cnn.py`'s
quantization) by shape tracing on the meta device (`zoo_conv_shapes`: no
parameter materialised) at batch 1 and batch 8, adds the attention shapes
(the five `ATTENTION_SHAPES` of the JAX package's
`tools/build_autotune_table.py`, and every prefill and decode
shape that `launch/serve.py` at its defaults can give gemma-2b,
recurrentgemma-2b and granite-moe-3b-a800m), picks the launch knobs of
each shape and writes ``src/repro_torch/kernels/autotune_tables/cuda.json``
— the packaged tier that `kernels/autotune.lookup` consults after the
user tier.

    python -m repro_torch.tools.build_autotune_table            # rebuild
    python -m repro_torch.tools.build_autotune_table --check    # the gate
    python -m repro_torch.tools.build_autotune_table --measure  # the card

Two sweeps:

  * default — the **analytic** sweep.  Every candidate
    (`candidate_configs` / `attention_candidate_configs`, all of them) is
    scored by a model of its device time.  Its roofline part is the larger
    of its bytes (`conv_traffic_bytes("cuda")` /
    `attention_traffic_bytes("cuda")`) over 3.35 TB/s and its operations
    over the peak of the unit it runs on (a block's padded work: six bf16
    products a multiply-add on the dense path's tensor cores, fp32 on the
    CUDA cores for the depthwise path and split-KV attention; a depthwise
    tile under 32 channels wide pays whole 128-byte lines for x and y),
    divided by the share of the SMs its blocks keep busy over their waves
    (``blocks / (ceil(blocks / n_sm) · n_sm)``, 132 SMs).  Bytes alone
    would always pick one share; the SMs alone, the most.  A dense conv and
    an attention call also pay a fixed time a launch (``FIXED_US``,
    ``ATTN_FIXED_US``) and,
    when split, the combine of their partials by the last block of a tile
    (``SPLIT_SYNC_US`` and the partials at ``COMBINE_BYTES_PER_US``); a
    dense conv runs no faster than a block's chain of ``stages_per_split``
    stages of ``STAGE_US`` each, two blocks on one SM going
    ``CO_RESIDENT`` times one block's rate (`modeled_dense_us`).  A
    candidate replaces the heuristic's own config only where it is
    modelled its path's `RESOLUTION` faster: closer than that, the model
    cannot tell them apart (the resolution is the least at which none of
    the path's picks was measured slower than the heuristic's knobs).  Deterministic: a second run writes a byte-identical file.
  * ``--measure`` — time candidates on the card through the tuners
    (`autotune_conv2d` / `autotune_attention`: device time, each candidate
    held against the plain version first); the winners land in the user
    tier, and in a table file only where ``--out`` names one (never the
    packaged tier by default).  Raises without a card.

``--check`` parses the table, verifies its schema version, re-walks the
zoo at the batches of its ``meta`` block and the attention shapes of this
module, and fails listing any uncovered key or any config that the
launchers' contracts refuse.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch.benchmarks.common import (PEAK_BF16_FLOPS, PEAK_FP32_FLOPS,
                                           PEAK_HBM_BYTES)
from repro_torch.configs.neuromax_cnn import CONFIG
from repro_torch.configs.registry import get_config
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import log_conv2d as lc
from repro_torch.models.attention import kv_cache_len
from repro_torch.models.cnn import zoo_conv_shapes

BACKEND = "cuda"
N_SM = 132          # the H100 SXM's SMs, for which the table is built
BATCHES = (1, 8)    # the JAX table's batch, and the paper slice's
LINE = 128          # bytes of a warp's coalesced access
# Latency terms of the analytic score and the paths' resolutions, fit by
# `python -m repro_torch.tools.time_autotune_candidates --fit` to the
# device time of every candidate of every walked shape (that module's
# ``--out``; an NVIDIA H100 80GB HBM3 at 700 W): each term by least squares
# on the relative error (median 8.5 % dense, 51 % depthwise, 25 % split-KV
# attention), each path's resolution the least at which none of its picks
# was measured slower than the heuristic's knobs.
FIXED_US = 6.71             # a dense conv's fixed device time
DW_FIXED_US = 1.16          # a depthwise conv's
ATTN_FIXED_US = 8.09        # an attention call's
STAGE_US = 1.80             # one BK-stage of one dense block, alone on an SM
CO_RESIDENT = 1.08          # two dense blocks on an SM: their rate over one's
SPLIT_SYNC_US = 5.18        # a split dense tile's ticket and combine pass
ATTN_SPLIT_SYNC_US = 13.8   # the same for a split attention row block
COMBINE_BYTES_PER_US = 20.6e3  # the partials the last block of a tile reads
# a path's modelled gains below this share keep the heuristic (None: every
# gain does, since no resolution kept the path's picks from losing)
RESOLUTION = {"dense": 0.3, "depthwise": None, "attention": 0.05}
REPS = 20           # calls a measured candidate runs back to back

# the attention shapes of the JAX package's tools/build_autotune_table.py
# (its bench's cases, fp32 there):
# (B, Tq, Tk, H, Hkv, D, causal, window)
ATTENTION_SHAPES = [
    [1, 1, 4096, 8, 2, 64, True, None],     # decode, GQA rep=4
    [1, 1, 8192, 8, 2, 64, True, None],     # decode, GQA rep=4, 8k ctx
    [1, 1, 4096, 8, 1, 64, True, None],     # decode, MQA
    [1, 128, 4096, 8, 2, 64, True, None],   # prefill chunk, GQA rep=4
    [1, 1, 4096, 8, 8, 64, True, None],     # decode, MHA control
]
SERVE_ARCHS = ("gemma-2b", "recurrentgemma-2b", "granite-moe-3b-a800m")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def serve_attention_shapes() -> list[dict]:
    """Every attention call `launch/serve.py` at its defaults can make for
    each of ``SERVE_ARCHS``: prefill of one prompt of 3 to max_prompt/2 - 1
    tokens (`make_requests`), padded to its power-of-two bucket unless the
    arch has recurrent layers, in activation dtype; decode of
    ``max_batch`` rows over each attention kind's cache
    (`models.attention.kv_cache_len`), a bf16 q against the engine's fp32
    cache."""
    from repro_torch.launch.serve import parse_args
    from repro_torch.serving.engine import EngineConfig, _next_pow2
    args = parse_args([])
    cache_dtype = EngineConfig().cache_dtype
    out = []
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        pad = not any(k in ("rwkv", "rec") for k in cfg.layer_pattern)
        lens = sorted({min(_next_pow2(t), args.max_prompt) if pad else t
                       for t in range(3, args.max_prompt // 2)})
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        act = _dtype_name(cfg.act_dtype)
        for kind in sorted({k for k in cfg.layer_pattern
                            if k in ("attn", "local")}):
            window = cfg.attn_window if kind == "local" else None
            for t in lens:
                out.append(dict(shape=[1, t, t, *heads, True, window],
                                q_dtype=act, kv_dtype=act,
                                source=f"{arch} prefill"))
            S = kv_cache_len(cfg, kind, args.max_len)
            out.append(dict(shape=[args.max_batch, 1, S, *heads, True,
                                   window],
                            q_dtype=act, kv_dtype=_dtype_name(cache_dtype),
                            source=f"{arch} decode"))
    return out


def attention_walk() -> list[dict]:
    """JAX's five shapes in fp32 (as its bench runs them), then the serve
    shapes; a key that two sources share keeps the first."""
    walk = [dict(shape=list(s), q_dtype="float32", kv_dtype="float32",
                 source="jax table") for s in ATTENTION_SHAPES]
    return walk + serve_attention_shapes()


def conv_walk(meta: dict) -> list[dict]:
    shapes = []
    for b in meta["batches"]:
        shapes += zoo_conv_shapes(batch=b, img=meta["img"],
                                  n_classes=meta["n_classes"],
                                  cin=meta["cin"],
                                  width_mult=meta["width_mult"])
    return shapes


def _conv_args(s: dict) -> tuple:
    return s["B"], s["H"], s["W"], s["C"], s["K"], s["Cout"]


def _conv_kw(s: dict) -> dict:
    return dict(stride=s["stride"], padding=s["padding"], groups=s["groups"])


def conv_key_of(s: dict) -> str:
    return autotune.conv_key(*_conv_args(s), **_conv_kw(s), cfg=CONFIG.qcfg,
                             backend=BACKEND)


def attention_key_of(a: dict) -> str:
    B, Tq, Tk, H, Hkv, D, causal, window = a["shape"]
    return autotune.attention_key(B, Tq, Tk, H, Hkv, D, causal=causal,
                                  window=window, backend=BACKEND)


# ---------------------------------------------------------------------------
# analytic sweep (deterministic)
# ---------------------------------------------------------------------------


def _busy_share(blocks: int) -> float:
    """The share of the SMs a launch's blocks keep busy over its waves."""
    return blocks / (-(-blocks // N_SM) * N_SM)


def modeled_us(nbytes: int, ops: int, peak: float, blocks: int) -> float:
    """max(bytes / 3.35 TB/s, ops / peak) over the SMs' busy share."""
    return max(nbytes / PEAK_HBM_BYTES, ops / peak) \
        / _busy_share(blocks) * 1e6


def modeled_dense_us(roofline_us: float, g: dict) -> float:
    """A dense launch of geometry ``g``: its roofline time, or a block's
    serial chain of stages where that is longer, plus the fixed time and,
    with split-K, the last block's combine of ``splits`` partial tiles.
    An SM holds two blocks at a time: with ``n`` blocks it runs ``n // 2``
    rounds of two chains at ``CO_RESIDENT`` times one chain's rate, and
    one chain alone where ``n`` is odd."""
    n = -(-g["blocks"] // N_SM)
    chain = STAGE_US * g["stages_per_split"] * (n // 2 * 2 / CO_RESIDENT
                                                + n % 2)
    combine = 0.0
    if g["splits"] > 1:
        combine = SPLIT_SYNC_US + g["splits"] * lc.BM * lc.BN * 4 \
            / COMBINE_BYTES_PER_US
    return FIXED_US + max(roofline_us, chain) + combine


def conv_roofline(s: dict, config: dict) -> tuple[float, dict]:
    """(the roofline µs over the SMs' busy share, the geometry) of one conv
    launch at ``config``."""
    knobs = lc.knob_args(config)
    g = lc.log_conv2d_geometry(*_conv_args(s), s["stride"], s["padding"],
                               s["groups"], N_SM, **knobs)
    t = lc.conv_traffic_bytes("cuda", *_conv_args(s), **_conv_kw(s),
                              bits=CONFIG.qcfg.bits, n_sm=N_SM, config=knobs)
    if g["path"] == "dense":    # 3 bf16 pieces of x times 2 code planes
        ops = 12 * lc.BM * lc.BN * lc.BK * g["stages_per_split"] * g["blocks"]
        return modeled_us(t["total"], ops, PEAK_BF16_FLOPS, g["blocks"]), g
    # a warp reads x and writes y in 128-byte lines: a tile narrower than
    # 32 fp32 channels moves whole lines for its ct·4 bytes a pixel
    th, tw, ct = g["tile"]
    waste = max(1, LINE // (4 * ct))
    nbytes = waste * (t["act"] + t["out"]) + t["w"]
    ops = 2 * th * tw * ct * s["K"] ** 2 * g["blocks"]
    return modeled_us(nbytes, ops, PEAK_FP32_FLOPS, g["blocks"]), g


def modeled_conv_us(s: dict, config: dict) -> float:
    roofline, g = conv_roofline(s, config)
    if g["path"] == "dense":
        return modeled_dense_us(roofline, g)
    return DW_FIXED_US + roofline


def modeled_attention_us(a: dict, config: dict) -> float:
    """The roofline time of one attention call, plus the fixed time and,
    with split-KV, the last block's combine of its row block's partials."""
    B, Tq, Tk, H, Hkv, D = a["shape"][:6]
    qdt, kvdt = _DTYPES[a["q_dtype"]], _DTYPES[a["kv_dtype"]]
    g = fa.flash_attention_geometry(B, Tq, Tk, H, Hkv, D, qdt, kvdt, N_SM,
                                    splits=config.get("splits"))
    nbytes = fa.attention_traffic_bytes(
        "cuda", B, Tq, Tk, H, Hkv, D, itemsize=qdt.itemsize,
        kv_itemsize=kvdt.itemsize, config=config)["total"]
    ops = 4 * g["rows"] * g["keys_per_split"] * D * g["blocks"]
    peak = PEAK_BF16_FLOPS if g["variant"] == "mma" else PEAK_FP32_FLOPS
    combine = 0.0
    if g["splits"] > 1:         # (m, l, acc) a row and split
        combine = ATTN_SPLIT_SYNC_US + g["splits"] * g["rows"] * (D + 2) \
            * 4 / COMBINE_BYTES_PER_US
    return ATTN_FIXED_US + modeled_us(nbytes, ops, peak, g["blocks"]) \
        + combine


def _pick(cands: list[dict], score, path: str) -> tuple[dict, float]:
    """The best-modelled candidate, unless the heuristic's own (the first)
    is within the path's `RESOLUTION` of it (always, where that is
    None)."""
    res = RESOLUTION[path]
    if res is None:
        return cands[0], score(cands[0])
    scored = [(score(c), i, c) for i, c in enumerate(cands)]
    best = min(scored, key=lambda t: (t[0], t[1]))
    if scored[0][0] <= best[0] * (1 + res):
        best = scored[0]
    return best[2], best[0]


def analytic_conv_winner(s: dict) -> tuple[dict, float]:
    cands = autotune.candidate_configs(*_conv_args(s), **_conv_kw(s),
                                       n_sm=N_SM, max_candidates=None)
    path = "depthwise" if cands[0]["tile"] is not None else "dense"
    return _pick(cands, lambda c: modeled_conv_us(s, c), path)


def analytic_attention_winner(a: dict) -> tuple[dict, float]:
    cands = autotune.attention_candidate_configs(
        *a["shape"][:6], q_dtype=_DTYPES[a["q_dtype"]],
        kv_dtype=_DTYPES[a["kv_dtype"]], n_sm=N_SM, max_candidates=None)
    return _pick(cands, lambda c: modeled_attention_us(a, c), "attention")


# ---------------------------------------------------------------------------
# measured sweep (the card; non-deterministic)
# ---------------------------------------------------------------------------


def _needs_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("--measure times the kernels on the card, and "
                           "this machine has no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def measured_conv_winner(s: dict, reps: int, seed: int = 0
                         ) -> tuple[dict, float]:
    """`autotune_conv2d` on random x and codes of one shape, grouped codes
    lane-packed as `quantize_cnn_params` bakes them → (winner, µs)."""
    from repro_torch.core.logquant import quantize_tensor
    dev = _needs_card()
    rng = np.random.default_rng(seed)
    B, H, W, C, K, Cout = _conv_args(s)
    G = s["groups"]
    x = torch.as_tensor(rng.normal(size=(B, H, W, C)).astype(np.float32),
                        device=dev)
    qt = quantize_tensor(torch.as_tensor(
        rng.normal(size=(K, K, C // G, Cout)).astype(np.float32),
        device=dev), CONFIG.qcfg)
    codes, lane = qt.packed, None
    lp = lc.lane_pack_geometry(G, C // G)
    if lp["g_b"] > 1:
        codes = lc.lane_pack_codes(qt.packed, G, lp["g_b"], lp["cin_lane"])
        lane = (lp["g_b"], lp["cin_lane"])
    with torch.no_grad():
        best = autotune.autotune_conv2d(x, codes, qt.scale.reshape(-1),
                                        qt.cfg, **_conv_kw(s), lane=lane,
                                        reps=reps)
    return best, autotune._load()["entries"][conv_key_of(s)]["us"]


def measured_attention_winner(a: dict, reps: int, seed: int = 0
                              ) -> tuple[dict, float]:
    dev = _needs_card()
    B, Tq, Tk, H, Hkv, D, causal, window = a["shape"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Tq, H, D), generator=gen, device=dev).to(
        _DTYPES[a["q_dtype"]])
    k, v = (torch.randn((B, Tk, Hkv, D), generator=gen, device=dev).to(
        _DTYPES[a["kv_dtype"]]) for _ in range(2))
    with torch.no_grad():
        best = autotune.autotune_attention(q, k, v, causal=causal,
                                           window=window, reps=reps)
    return best, autotune._load()["entries"][attention_key_of(a)]["us"]


# ---------------------------------------------------------------------------
# build / check
# ---------------------------------------------------------------------------


def build_table(meta: dict, measure: bool = False, reps: int = REPS) -> dict:
    entries = {}
    for s in conv_walk(meta):
        key = conv_key_of(s)
        if key in entries:
            continue
        cfg, us = (measured_conv_winner(s, reps) if measure
                   else analytic_conv_winner(s))
        entries[key] = {"config": cfg, "us": round(us, 2),
                        "when": "packaged",
                        "how": "measured" if measure else "analytic",
                        "nets": s["nets"]}
    for a in attention_walk():
        key = attention_key_of(a)
        if key in entries:
            continue
        cfg, us = (measured_attention_winner(a, reps) if measure
                   else analytic_attention_winner(a))
        entries[key] = {"config": cfg, "us": round(us, 2),
                        "when": "packaged",
                        "how": "measured" if measure else "analytic",
                        "source": a["source"],
                        "dtypes": [a["q_dtype"], a["kv_dtype"]]}
    return {"version": autotune.SCHEMA_VERSION,
            "generated_by": "python -m repro_torch.tools.build_autotune_table",
            "meta": dict(meta, qbits=CONFIG.qcfg.bits,
                         qfrac=CONFIG.qcfg.frac_bits, n_sm=N_SM,
                         resolution=RESOLUTION),
            "entries": entries}


def check_table(path: str) -> list[str]:
    """→ list of problems (empty = the table is valid and covers the
    walk)."""
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable ({e})"]
    if table.get("version") != autotune.SCHEMA_VERSION:
        return [f"{path}: schema version {table.get('version')} != "
                f"SCHEMA_VERSION {autotune.SCHEMA_VERSION}"]
    entries, problems = table.get("entries", {}), []
    meta = dict(DEFAULT_META, **table.get("meta", {}))
    for s in conv_walk(meta):
        key = conv_key_of(s)
        cfg = entries.get(key, {}).get("config")
        if not isinstance(cfg, dict):
            problems.append(f"{path}: missing conv entry {key}")
            continue
        try:
            lc.log_conv2d_geometry(*_conv_args(s), s["stride"],
                                   s["padding"], s["groups"], N_SM,
                                   **lc.knob_args(cfg))
        except ValueError as e:
            problems.append(f"{path}: {key} config {cfg} refused: {e}")
    for a in attention_walk():
        key = attention_key_of(a)
        cfg = entries.get(key, {}).get("config")
        if not isinstance(cfg, dict):
            problems.append(f"{path}: missing attention entry {key}")
            continue
        B, Tq, Tk, H, Hkv, D = a["shape"][:6]
        try:
            fa.flash_attention_geometry(B, Tq, Tk, H, Hkv, D,
                                        _DTYPES[a["q_dtype"]],
                                        _DTYPES[a["kv_dtype"]], N_SM,
                                        splits=cfg.get("splits"))
        except ValueError as e:
            problems.append(f"{path}: {key} config {cfg} refused: {e}")
    return problems


DEFAULT_META = dict(batches=list(BATCHES), img=224, n_classes=1000, cin=3,
                    width_mult=1.0)


def write_table(table: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="build/check the packaged autotune table of the CUDA "
                    "kernels")
    ap.add_argument("--out", default=None,
                    help="table file (default: the packaged tier; with "
                         "--measure, none: the winners land in the user "
                         "tier alone)")
    ap.add_argument("--measure", action="store_true",
                    help="time candidates on the card instead of the "
                         "deterministic analytic sweep")
    ap.add_argument("--check", action="store_true",
                    help="validate the table (schema, coverage, contracts) "
                         "instead of building")
    args = ap.parse_args(argv)
    path = args.out or autotune.packaged_table_path(BACKEND)

    if args.check:
        problems = check_table(path)
        if problems:
            print("\n".join(problems[:40]), file=sys.stderr)
            print(f"FAIL: {len(problems)} problem(s)", file=sys.stderr)
            return 1
        with open(path) as f:
            n = len(json.load(f)["entries"])
        print(f"{path}: ok ({n} entries cover the walk)")
        return 0
    if args.measure:
        _needs_card()
    table = build_table(DEFAULT_META, measure=args.measure)
    if args.measure and args.out is None:
        print(f"measured {len(table['entries'])} winners into the user "
              f"tier {autotune.table_path()}")
        return 0
    write_table(table, path)
    print(f"wrote {path}: {len(table['entries'])} entries "
          f"({'measured' if args.measure else 'analytic'} sweep)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
