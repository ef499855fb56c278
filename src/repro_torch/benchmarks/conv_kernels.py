"""Log-conv kernel times across the paper's CNN layer shapes, on the card:
the twin of the JAX package's `benchmarks/conv_kernels.py`.

    python -m repro_torch.benchmarks.run --only conv_kernels     # the card
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only conv_kernels \
        --device cpu --img 16

The same four layers (VGG-16 CONV1_1 and CONV3_1, MobileNet v1 DW2 and
PW2, from `core/accelerator.py`) at batch 4, at ``img`` pixels (224 on the
card; the JAX bench's 32 was a CI size).  Per layer, with TF32 off: the
CUDA kernel (`ops.conv2d(impl="cuda")`), the explicit-im2col route onto
the log_matmul kernel (``impl="cuda_im2col"``, JAX's ``pallas_im2col``),
`F.conv2d` on fp32 weights (the JAX bench's `lax.conv` baseline) and
decode + `F.conv2d` (the blockwise path), each as `torch.profiler` device
time (host clock on the CPU, where "cuda" and "cuda_im2col" run their
plain versions); ``overhead_x`` (kernel over fp32); ``rel_quant_err`` of
blockwise against fp32 (gate < 0.2, as JAX); the kernel and the im2col
route against blockwise (gate: within 1e-4·(max|y|+1), the port's conv
tolerance); the bytes of `conv_traffic_bytes` for ``fp32`` /
``blockwise`` / ``cuda`` / ``min`` (``"total"``: x, weights, y and, for
``cuda``, the split-K partials); as JAX's row, ``bytes_im2col`` and
``bytes_fused`` (``"act_w"`` of ``cuda_im2col`` and ``cuda``) and their
ratio ``fused_traffic_win_x``, held against JAX's ``TRAFFIC_WIN_3X3`` =
4.0 on the 3×3 layers (``traffic_ok``); the bound max(min bytes / 3.35
TB/s, FLOP / 989 TFLOP/s) and the kernel's share of it.

A probe holds the kernel and the im2col route against blockwise on
``1×8×8×3 → 16`` (maxdiff < 1e-3; JAX's interpret probes, fused ≡
im2col ≡ blockwise).  ``lane_rows`` take JAX's four narrow-group
cases at ``batch × img × img``: the kernel on the baked ``lane_packed``
layout and with ``ConvConfig(lane_pack=1)`` against blockwise, device
time of the lane-packed codes against natural HWIO codes, and ``cuda``
bytes.

``cold_start`` is the autotune warm-start gate of the JAX bench: with an
empty user tier, the four paper CNNs at 224 px (batch 1, as JAX's) are
traced on the meta device exactly as serving dispatches them (packed
weights, ``conv_impl="cuda"``, lane-packed depthwise codes), and every
conv's launch knobs must resolve from the packaged tier (no miss, no
sweep).

The traffic gate's verdict is ``traffic_win_3x3_ok`` beside the smallest
3×3 win ``traffic_win_3x3``; it is reported, not part of ``ok`` (the
correctness gates and the cold start): the CUDA conv kernel's count reads
x once per tap and column tile (first order, L2 hits not modelled), where
JAX's fused kernel re-slices one slab for every tap, so the port's win on
CONV3_1 (Cout 256) falls short of JAX's 4.0.  Left out, a ``null`` with a
note in the JSON: JAX's 128-lane byte gate (``LANE_PACK_WIN``, a model of
the TPU's lanes: the CUDA kernel reads a group's channels, not whole
128-lane blocks).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.core.accelerator import mobilenet_v1_layers, vgg16_layers
from repro_torch.core.device import resolve_device
from repro_torch.core.logquant import QuantizedTensor, quantize_tensor
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.log_conv2d import (conv_nhwc, conv_traffic_bytes,
                                            lane_pack_codes,
                                            lane_pack_geometry,
                                            normalize_padding, sm_count)
from repro_torch.models import cnn as cnn_models
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.quantize import quantize_cnn_params

from .common import (bound_us, card_name, device_us, fmt_table, timer_name,
                     write_json)

IMG = 224   # the paper's image size; the JAX bench's CI size was 32
BATCH = 4   # serving-sized microbatch, as the JAX bench
QUANT_ERR_LIMIT = 0.2   # blockwise against fp32, as the JAX bench
TRAFFIC_WIN_3X3 = 4.0   # fused act+w bytes under im2col's, as the JAX bench
CONV_TOL = 1e-4         # kernel against blockwise: CONV_TOL·(max|y|+1)
PROBE_LIMIT = 1e-3      # the JAX bench's interpret-probe limit
LANE_CASES = [  # (name, C, groups, Cout, K, stride), the JAX bench's
    ("dw_cin1", 64, 64, 64, 3, 1),
    ("dw_cin1_s2", 64, 64, 64, 3, 2),
    ("grp_cin2", 64, 32, 64, 3, 1),
    ("grp_cin4", 64, 16, 64, 3, 1),
]
IMPLS = ("fp32", "blockwise", "cuda", "min")


def _layer_cases(img: int):
    vgg = {s.name: s for s in vgg16_layers(img)}
    mbn = {s.name: s for s in mobilenet_v1_layers(img)}
    for net, spec in (("vgg16", vgg["CONV1_1"]), ("vgg16", vgg["CONV3_1"]),
                      ("mobilenet_v1", mbn["DW2"]),
                      ("mobilenet_v1", mbn["PW2"])):
        yield net, spec, spec.C if spec.kind == "dwconv" else 1


def _maxdiff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _tol(y) -> float:
    return CONV_TOL * (float(y.abs().max()) + 1)


def _lane_packed(qt, groups: int):
    """``qt`` (natural HWIO codes) in the baked ``lane_packed`` layout that
    `serving.quantize.quantize_cnn_params` gives a depthwise kernel."""
    lp = lane_pack_geometry(groups, qt.shape[2])
    codes = lane_pack_codes(qt.packed, groups, lp["g_b"], lp["cin_lane"])
    return QuantizedTensor(codes, qt.scale.reshape(-1), qt.cfg, qt.shape,
                           layout="lane_packed",
                           layout_meta=(lp["g_b"], lp["cin_lane"], groups))


def autotune_counts(op: str = "conv2d") -> dict:
    """Current `autotune_lookup` totals of one op, and all sweeps."""
    reg = obs_metrics.REGISTRY
    out = {r: reg.counter("autotune_lookup", op=op, result=r).value
           for r in ("hit_user", "hit_warm", "miss")}
    out["sweeps"] = sum(reg.counter("autotune_sweep", op=o).value
                        for o in ("conv2d", "attention"))
    return out


def cold_start_section(img: int = IMG, batch: int = 1) -> dict:
    """First-inference warm-start gate: with an empty user tier (the
    environment's path pointed at a file that does not exist), the four
    CNNs traced on the meta device through `ops.conv2d(impl="cuda")` on
    packed weights, each conv's knobs resolved once a shape; every
    resolution must come from the packaged tier."""
    prev = os.environ.get(autotune.ENV_PATH)
    tmp = tempfile.TemporaryDirectory(prefix="repro-torch-coldstart-")
    os.environ[autotune.ENV_PATH] = os.path.join(tmp.name, "empty.json")
    autotune.reset_cache()
    per_net, before, calls = {}, autotune_counts(), []
    try:
        for name, (_, apply) in cnn_models.CNN_ZOO.items():
            params, _ = cnn_models.make_cnn(name, device="meta")
            qp = quantize_cnn_params(params, conv_layout="lane_packed")
            n0, n_calls = autotune_counts(), len(calls)
            with cnn_models._capture_conv_shapes(calls):
                apply(qp, torch.empty((batch, img, img, 3), device="meta"),
                      quant="logq6", conv_impl="cuda")
            n1 = autotune_counts()
            per_net[name] = dict({k: n1[k] - n0[k] for k in n0},
                                 dispatches=len(calls) - n_calls)
    finally:
        if prev is None:
            os.environ.pop(autotune.ENV_PATH, None)
        else:
            os.environ[autotune.ENV_PATH] = prev
        autotune.reset_cache()
        tmp.cleanup()
    after = autotune_counts()
    d = {k: after[k] - before[k] for k in before}
    lookups = d["hit_user"] + d["hit_warm"] + d["miss"]
    # knobs are resolved (and the lookup counted) once a distinct shape
    keys = len({autotune.conv_key(c["B"], c["H"], c["W"], c["C"], c["K"],
                                  c["Cout"], stride=c["stride"],
                                  padding=c["padding"], groups=c["groups"])
                for c in calls})
    ok = (lookups > 0 and d["miss"] == 0 and d["sweeps"] == 0
          and d["hit_warm"] == lookups == keys)
    return {"img": img, "batch": batch, "conv_dispatches": len(calls),
            "distinct_keys": keys, "lookups": lookups,
            "hit_warm": d["hit_warm"],
            "hit_user": d["hit_user"], "miss": d["miss"],
            "sweeps": d["sweeps"], "per_net": per_net, "ok": ok}


def run(device=None, root=None, img: int = IMG, batch: int = BATCH,
        reps: int = 5) -> dict:
    dev = resolve_device(device)
    n_sm = sm_count(dev.index or 0) if dev.type == "cuda" else 132
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            out = _run(dev, n_sm, img, batch, reps,
                       np.random.default_rng(0))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    path = write_json("BENCH_torch_conv.json", out, root)
    print(f"wrote {path}")
    return out


def _run(dev, n_sm, img, batch, reps, rng) -> dict:
    def tensor(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)

    rows, ok = [], True
    for net, spec, groups in _layer_cases(img):
        H = W = spec.H
        x = tensor(batch, H, W, spec.C)
        w = tensor(spec.K, spec.K, spec.C // groups, spec.P)
        qt = quantize_tensor(w)
        kw = dict(stride=spec.stride, padding=spec.pad, groups=groups)
        pads = normalize_padding(spec.pad, spec.K, spec.stride, H, W)

        def fp32():
            return conv_nhwc(x, w, stride=spec.stride, pads=pads,
                             groups=groups)

        def kernel():
            return ops.conv2d(x, qt, impl="cuda", **kw)

        def blockwise():
            return ops.conv2d(x, qt, impl="blockwise", **kw)

        def im2col():
            return ops.conv2d(x, qt, impl="cuda_im2col", **kw)
        y_fp, y_bw, y_k = fp32(), blockwise(), kernel()
        rel = float(torch.linalg.norm(y_bw - y_fp)
                    / (torch.linalg.norm(y_fp) + 1e-9))
        err, tol = _maxdiff(y_k, y_bw), _tol(y_bw)
        err_im2col = _maxdiff(im2col(), y_bw)
        us = {name: device_us(fn, dev, reps) for name, fn in (
            ("kernel", kernel), ("im2col", im2col), ("fp32", fp32),
            ("blockwise", blockwise))}
        traffic = {impl: conv_traffic_bytes(impl, batch, H, W, spec.C,
                                            spec.K, spec.P, **kw, n_sm=n_sm)
                   for impl in IMPLS + ("cuda_im2col",)}
        win = traffic["cuda_im2col"]["act_w"] / traffic["cuda"]["act_w"]
        traffic_ok = win >= TRAFFIC_WIN_3X3 if spec.K == 3 else True
        Ho, Wo = y_k.shape[1:3]
        flops = 2 * batch * Ho * Wo * spec.P * spec.K ** 2 * spec.C // groups
        b_us, by = bound_us(traffic["min"]["total"], flops)
        row_ok = (rel < QUANT_ERR_LIMIT and err <= tol and err_im2col <= tol
                  and y_k.shape == y_fp.shape)
        ok &= row_ok
        rows.append({
            "net": net, "layer": spec.name,
            "shape": f"{batch}x{H}x{W}x{spec.C}->{spec.P}",
            "K": spec.K, "stride": spec.stride, "groups": groups,
            "kernel_us": us["kernel"], "im2col_us": us["im2col"],
            "fp32_us": us["fp32"], "blockwise_us": us["blockwise"],
            "overhead_x": us["kernel"] / max(us["fp32"], 1e-9),
            "rel_quant_err": rel, "kernel_maxdiff": err, "kernel_tol": tol,
            "im2col_maxdiff": err_im2col,
            **{f"bytes_{i}": traffic[i]["total"] for i in IMPLS},
            "bytes_im2col": traffic["cuda_im2col"]["act_w"],
            "bytes_fused": traffic["cuda"]["act_w"],
            "fused_traffic_win_x": win, "traffic_ok": traffic_ok,
            "gflop": flops / 1e9, "bound_us": b_us, "bound_by": by,
            "share_of_bound": b_us / us["kernel"], "ok": row_ok})

    # the kernel and the im2col route against blockwise on a small layer
    # (JAX's interpret probes: fused ≡ im2col ≡ blockwise)
    xp, qp = tensor(1, 8, 8, 3), quantize_tensor(tensor(3, 3, 3, 16))
    y_bw = ops.conv2d(xp, qp, impl="blockwise")
    probes = {}
    for name, impl in (("kernel", "cuda"), ("im2col", "cuda_im2col")):
        d = _maxdiff(ops.conv2d(xp, qp, impl=impl), y_bw)
        probes[f"{name}_1x8x8x3_16"] = {"maxdiff": d, "limit": PROBE_LIMIT,
                                        "ok": d < PROBE_LIMIT}
        ok &= d < PROBE_LIMIT

    lane_rows = []
    for name, C, G, Cout, K, stride in LANE_CASES:
        xg = tensor(batch, img, img, C)
        qt = quantize_tensor(tensor(K, K, C // G, Cout))
        qt_lane = _lane_packed(qt, G)
        gkw = dict(stride=stride, padding="SAME", groups=G)
        y_bw = ops.conv2d(xg, qt, impl="blockwise", **gkw)
        tol = _tol(y_bw)
        d_lane = _maxdiff(ops.conv2d(xg, qt_lane, impl="cuda", **gkw), y_bw)
        d_hwio = _maxdiff(ops.conv2d(xg, qt_lane, impl="cuda",
                                     config=ops.ConvConfig(lane_pack=1),
                                     **gkw), y_bw)
        row_ok = d_lane <= tol and d_hwio <= tol
        ok &= row_ok
        lane_rows.append({
            "case": name, "cin_g": C // G, "groups": G, "K": K,
            "stride": stride, "shape": f"{batch}x{img}x{img}x{C}->{Cout}",
            "g_b": qt_lane.layout_meta[0],
            "lane_packed_us": device_us(
                lambda: ops.conv2d(xg, qt_lane, impl="cuda", **gkw), dev,
                reps),
            "hwio_us": device_us(
                lambda: ops.conv2d(xg, qt, impl="cuda", **gkw), dev, reps),
            "bytes_cuda": conv_traffic_bytes(
                "cuda", batch, img, img, C, K, Cout, **gkw,
                n_sm=n_sm)["total"],
            "maxdiff_lane_packed": d_lane, "maxdiff_lane_pack_1": d_hwio,
            "tol": tol, "ok": row_ok})

    print(fmt_table([{k: (f"{v:.4g}" if isinstance(v, float) else v)
                      for k, v in r.items()} for r in rows],
                    ["net", "layer", "shape", "kernel_us", "im2col_us",
                     "fp32_us", "blockwise_us", "overhead_x", "rel_quant_err",
                     "kernel_maxdiff", "im2col_maxdiff", "bytes_cuda",
                     "bytes_min", "fused_traffic_win_x", "traffic_ok",
                     "bound_us", "share_of_bound", "ok"]))
    print(fmt_table([{k: (f"{v:.4g}" if isinstance(v, float) else v)
                      for k, v in r.items()} for r in lane_rows],
                    ["case", "cin_g", "groups", "g_b", "lane_packed_us",
                     "hwio_us", "bytes_cuda", "maxdiff_lane_packed",
                     "maxdiff_lane_pack_1", "ok"]))
    for name, p in probes.items():
        print(f"{name}: |{name.split('_')[0]} - blockwise| = "
              f"{p['maxdiff']:.2e} ({'OK' if p['ok'] else 'FAIL'})")
    wins = [r["fused_traffic_win_x"] for r in rows if r["K"] == 3]
    print(f"fused traffic win on the 3x3 layers: min {min(wins):.3f}x "
          f"(JAX's gate {TRAFFIC_WIN_3X3}x: "
          f"{'OK' if min(wins) >= TRAFFIC_WIN_3X3 else 'FAIL'}, reported)")
    cold = cold_start_section()
    print(f"cold start (empty user tier, {cold['img']} px, batch "
          f"{cold['batch']}): {cold['conv_dispatches']} conv dispatches, "
          f"{cold['lookups']} resolutions, hit_warm {cold['hit_warm']}, miss "
          f"{cold['miss']}, sweeps {cold['sweeps']} "
          f"({'OK' if cold['ok'] else 'FAIL'})")
    return {
        "rows": rows, "probes": probes, "lane_rows": lane_rows,
        "timer": timer_name(dev), "card": card_name(dev), "img": img,
        "batch": batch, "tf32": False,
        "mean_kernel_overhead_x": float(np.mean([r["overhead_x"]
                                                 for r in rows])),
        "max_rel_quant_err": max(r["rel_quant_err"] for r in rows),
        "max_kernel_err_over_tol": max(r["kernel_maxdiff"] / r["kernel_tol"]
                                       for r in rows),
        "lane_pack_win_gate": None,
        "lane_pack_win_gate_note": "JAX's LANE_PACK_WIN models the TPU's "
        "whole-128-lane block fetches; the CUDA kernel fetches a group's "
        "channels, so the layout does not change its bytes",
        "traffic_win_3x3": min(wins), "traffic_win_3x3_gate": TRAFFIC_WIN_3X3,
        "traffic_win_3x3_ok": min(wins) >= TRAFFIC_WIN_3X3,
        "traffic_win_3x3_note": "act+w bytes of cuda_im2col over cuda; "
        "reported, not part of ok: the CUDA conv kernel's first-order count "
        "reads x once per tap and column tile",
        "cold_start": cold,
        "ok": bool(ok and cold["ok"])}
