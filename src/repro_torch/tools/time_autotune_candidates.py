"""Time every autotune candidate on the card, and fit the analytic score's
latency constants to those times.

    python -m repro_torch.tools.time_autotune_candidates --out FILE   # card
    python -m repro_torch.tools.time_autotune_candidates --fit FILE   # CPU

``--out`` walks the shapes of `build_autotune_table` (the zoo's convs at
its batches and the attention shapes) and runs every candidate of each
(`candidate_configs` / `attention_candidate_configs`, all of them) on
random inputs: each candidate's output is held against the heuristic's
within ``1e-4·(max|y|+1)`` (``8e-3`` for a bf16 q), then timed by device
time (`autotune._device_us`, ``REPS`` calls back to back).  It writes one
row a candidate: the shape, the knobs, the geometry and the µs.

``--fit`` reads such a file on any machine and fits the constants of
`build_autotune_table`'s score (`fit`): each term's by least squares on
the relative error of its candidates, then each path's ``RESOLUTION``,
the least at which none of its picks is measured slower than the
heuristic's knobs.  It prints
them, the model's error, and for each shape the measured µs of the
analytic pick, of the heuristic's knobs and of the fastest candidate.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.tools import build_autotune_table as bt

REPS = 20


def _conv_rows(dev, meta) -> list[dict]:
    from repro_torch.core.logquant import quantize_tensor
    from repro_torch.kernels import autotune
    from repro_torch.kernels import log_conv2d as lc
    rng, rows, seen = np.random.default_rng(0), [], set()
    for s in bt.conv_walk(meta):
        key = bt.conv_key_of(s)
        if key in seen:
            continue
        seen.add(key)
        B, H, W, C, K, Cout = bt._conv_args(s)
        G, kw = s["groups"], bt._conv_kw(s)
        x = torch.as_tensor(rng.normal(size=(B, H, W, C)).astype(np.float32),
                            device=dev)
        qt = quantize_tensor(torch.as_tensor(
            rng.normal(size=(K, K, C // G, Cout)).astype(np.float32),
            device=dev), bt.CONFIG.qcfg)
        scale = qt.scale.reshape(-1)
        cands = autotune.candidate_configs(B, H, W, C, K, Cout, **kw,
                                           n_sm=lc.sm_count(dev.index),
                                           max_candidates=None)
        want = None
        for i, c in enumerate(cands):
            def fn(c=c):
                return lc.log_conv2d_fused(x, qt.packed, scale, qt.cfg,
                                           config=c, **kw)
            y = fn()
            if want is None:        # the heuristic's knobs come first
                want, tol = y, 1e-4 * (float(y.abs().max()) + 1)
            elif not float((y - want).abs().max()) <= tol:
                raise RuntimeError(f"{key} at {c}: off the heuristic's "
                                   f"output")
            g = lc.log_conv2d_geometry(B, H, W, C, K, Cout, s["stride"],
                                       s["padding"], G, **lc.knob_args(c))
            rows.append({"key": key, "shape": s, "config": c,
                         "heuristic": i == 0, "path": g["path"],
                         "blocks": g["blocks"], "splits": g["splits"],
                         "stages_per_split": g["stages_per_split"],
                         "us": autotune._device_us(fn, REPS)})
        print(f"{key}: {len(cands)} candidates, best "
              f"{min(r['us'] for r in rows if r['key'] == key):.2f} µs")
        del x, qt
    return rows


def _attention_rows(dev) -> list[dict]:
    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_attention as fa
    gen, rows, seen = torch.Generator(device=dev).manual_seed(0), [], set()
    for a in bt.attention_walk():
        key = bt.attention_key_of(a)
        if key in seen:
            continue
        seen.add(key)
        B, Tq, Tk, H, Hkv, D, causal, window = a["shape"]
        qdt, kvdt = bt._DTYPES[a["q_dtype"]], bt._DTYPES[a["kv_dtype"]]
        q = torch.randn((B, Tq, H, D), generator=gen, device=dev).to(qdt)
        k, v = (torch.randn((B, Tk, Hkv, D), generator=gen,
                            device=dev).to(kvdt) for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=Tk - Tq)
        cands = autotune.attention_candidate_configs(
            B, Tq, Tk, H, Hkv, D, q_dtype=qdt, kv_dtype=kvdt,
            n_sm=fa.sm_count(dev.index), max_candidates=None)
        want = None
        for i, c in enumerate(cands):
            def fn(c=c):
                return fa.flash_attention_cuda(q, k, v, **kw, config=c)
            y = fn().float()
            if want is None:
                rel = 8e-3 if qdt == torch.bfloat16 else 2e-4
                want, tol = y, rel * (float(y.abs().max()) + 1)
            elif not float((y - want).abs().max()) <= tol:
                raise RuntimeError(f"{key} at {c}: off the heuristic's "
                                   f"output")
            g = fa.flash_attention_geometry(B, Tq, Tk, H, Hkv, D, qdt, kvdt,
                                            splits=c["splits"])
            rows.append({"key": key, "attention": a, "config": c,
                         "heuristic": i == 0, "variant": g["variant"],
                         "blocks": g["blocks"], "splits": g["splits"],
                         "us": autotune._device_us(fn, REPS)})
        print(f"{key}: {len(cands)} candidates")
    return rows


def time_all(out: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("--out times the kernels on the card, and this "
                           "machine has no CUDA device")
    dev = torch.device("cuda", 0)
    with torch.no_grad():
        rows = {"conv": _conv_rows(dev, bt.DEFAULT_META),
                "attention": _attention_rows(dev),
                "card": torch.cuda.get_device_name(0), "reps": REPS}
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)


# the resolutions `--fit` tries for a path, least first
RESOLUTIONS = tuple(round(0.05 * i, 2) for i in range(1, 11))


def _set(names, values) -> None:
    for n, v in zip(names, values):
        setattr(bt, n, float(v))


def _by_key(rows) -> dict:
    by_key: dict = {}
    for r in rows:
        by_key.setdefault(r["key"], []).append(r)
    return by_key


def _path(r: dict) -> str:
    return r.get("path", "attention")


def _pick_index(scores, path: str) -> int:
    """`build_autotune_table._pick` on a list of scores, the heuristic's
    first."""
    best = min(range(len(scores)), key=lambda i: (scores[i], i))
    res = bt.RESOLUTION[path]
    return 0 if res is None or scores[0] <= scores[best] * (1 + res) \
        else best


def _slower(by_key, score) -> int:
    """Picks measured slower than the heuristic's knobs under ``score``."""
    return sum(rs[_pick_index([score(r) for r in rs], _path(rs[0]))]["us"]
               > rs[0]["us"] for rs in by_key.values())


def _report(by_key, score) -> dict:
    out = {}
    for key, rs in by_key.items():
        i = _pick_index([score(r) for r in rs], _path(rs[0]))
        out[key] = {"pick_us": rs[i]["us"], "heuristic_us": rs[0]["us"],
                    "fastest_us": min(r["us"] for r in rs),
                    "pick": rs[i]["config"]}
    return out


def _least_squares(rows, names, model) -> np.ndarray:
    """Fit ``names`` (attributes of `build_autotune_table`) by least
    squares on the relative error of ``model`` over ``rows``; → the
    residuals."""
    from scipy.optimize import least_squares

    def resid(p):
        _set(names, p)
        return np.array([model(r) / r["us"] - 1 for r in rows])
    res = least_squares(resid, [max(getattr(bt, n), 1e-3) for n in names],
                        bounds=(0, np.inf))
    _set(names, res.x)
    return res.fun


def fit(path: str) -> dict:
    """The score's constants for the candidates timed in ``path``.  Each
    term's constants are fit by least squares on the relative error of its
    candidates: dense convs (``FIXED_US``, ``STAGE_US``, ``CO_RESIDENT``,
    ``SPLIT_SYNC_US``, ``COMBINE_BYTES_PER_US``), depthwise convs
    (``DW_FIXED_US``) and split-KV attention (``ATTN_FIXED_US``,
    ``ATTN_SPLIT_SYNC_US``, with the dense fit's combine rate).  Then
    ``RESOLUTION`` is the least of `RESOLUTIONS` at which no key's pick is
    measured slower than the heuristic's knobs, for each path (dense,
    depthwise, attention; None where none is: then the path keeps the
    heuristic's knobs)."""
    with open(path) as f:
        data = json.load(f)
    for r in data["conv"]:          # the part no constant changes
        r["roofline"], r["geo"] = bt.conv_roofline(r["shape"], r["config"])
    dense = [r for r in data["conv"] if r["path"] == "dense"]
    depthwise = [r for r in data["conv"] if r["path"] != "dense"]
    split = [r for r in data["attention"] if r["variant"] == "split"]
    names = {"dense": ["FIXED_US", "STAGE_US", "CO_RESIDENT",
                       "SPLIT_SYNC_US", "COMBINE_BYTES_PER_US"],
             "depthwise": ["DW_FIXED_US"],
             "attention": ["ATTN_FIXED_US", "ATTN_SPLIT_SYNC_US"]}

    def conv_model(r):
        if r["path"] == "dense":
            return bt.modeled_dense_us(r["roofline"], r["geo"])
        return bt.DW_FIXED_US + r["roofline"]

    def attn_model(r):
        return bt.modeled_attention_us(r["attention"], r["config"])
    err = {"dense": _least_squares(dense, names["dense"], conv_model),
           "depthwise": _least_squares(depthwise, names["depthwise"],
                                       conv_model),
           "attention": _least_squares(split, names["attention"],
                                       attn_model)}
    by_key = {**_by_key(data["conv"]), **_by_key(data["attention"])}

    def model(r):
        return conv_model(r) if "geo" in r else attn_model(r)
    for path in bt.RESOLUTION:
        keys = {k: rs for k, rs in by_key.items() if _path(rs[0]) == path}
        for res in RESOLUTIONS + (None,):
            bt.RESOLUTION[path] = res
            if _slower(keys, model) == 0:
                break
    consts = {n: float(getattr(bt, n))
              for n in sum(names.values(), [])}
    consts["RESOLUTION"] = dict(bt.RESOLUTION)
    keys = _report(by_key, model)
    summary = {"constants": consts, "keys": keys,
               "median_rel_err": {k: float(np.median(np.abs(v)))
                                  for k, v in err.items()}}
    slower = {k for k, v in keys.items() if v["pick_us"] > v["heuristic_us"]}
    print(json.dumps(consts, indent=1))
    print(f"median relative error: {summary['median_rel_err']}")
    for k, v in keys.items():
        print(f"{k}: pick {v['pick']} {v['pick_us']:.2f} µs, heuristic "
              f"{v['heuristic_us']:.2f}, fastest {v['fastest_us']:.2f}"
              f"{'  SLOWER' if k in slower else ''}")
    gain = sum(v["heuristic_us"] - v["pick_us"] for v in keys.values())
    print(f"{len(slower)} of {len(keys)} picks measured slower than the "
          f"heuristic; {gain:.2f} µs gained over the keys")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--out", help="time every candidate (card) into FILE")
    g.add_argument("--fit", help="fit the score's constants to FILE")
    args = ap.parse_args(argv)
    if args.out:
        time_all(args.out)
    else:
        fit(args.fit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
