#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Builds the CUDA kernels from `src/repro_torch/kernels/csrc/` at first use,
then runs, failing (non-zero exit, no final line) on the first phase that
goes wrong:

  1. the card (`nvidia-smi` name and power limit) and the fp32 settings:
     TF32 is switched off for cuDNN and matmul, so the plain versions are
     full fp32;
  2. the kernel build and its time;
  3. the decode table: all 128 codes through a 1x1 conv (x = 1, scale = 1),
     bit for bit against `decode_codes`, on both kernel paths;
  4. the kernel against `log_conv2d_ref` and `log_conv2d_blockwise` on the
     conv sweeps of the tests and on the 61 conv shapes of the four paper
     CNNs at batch 1 (tolerance 1e-4 * (max|y_ref| + 1));
  5. the slice: VGG-16, MobileNet v1, ResNet-34 and SqueezeNet at full
     width, 224 px, 1000 classes, batch 8, random weights from a seed,
     packed by `quantize_cnn_params(conv_layout="lane_packed")` and run with
     ``conv_impl="auto"``.  The kernel's launch count must rise by the net's
     conv count (13/27/36/26); in a second forward each conv's output must
     match ``"blockwise"`` on the same input, and the logits must match the
     ``"blockwise"`` forward's.  Each net's forward is timed and profiled
     (device busy time, idle share, top kernels);
  6. per-conv times at batch 8: kernel, plain version (im2col x matmul),
     the library call (decode + `F.conv2d`, and `F.conv2d` alone) and the
     fp32 bound.

Details go to `chiprun_out/chip_smoke.json`.  The last three lines are the
kernel table as JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks from NVIDIA's data sheet: fp32 on the CUDA cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
BATCH, IMG, N_CLASSES, SEED = 8, 224, 1000, 0
CONVS_PER_NET = {"vgg16": 13, "mobilenet_v1": 27, "resnet34": 36,
                 "squeezenet": 26}

SHAPES = [  # B, H, W, C, K, P, stride, padding, groups (tests/test_conv2d.py)
    (2, 8, 8, 5, 3, 7, 1, "SAME", 1),
    (1, 9, 7, 4, 3, 6, 2, "SAME", 1),
    (2, 8, 8, 6, 3, 6, 1, "VALID", 6),
    (1, 10, 10, 4, 1, 8, 1, "VALID", 1),
    (1, 8, 8, 6, 3, 4, 2, "SAME", 2),
    (1, 8, 8, 3, 5, 4, 2, 2, 1),
    (1, 8, 8, 3, 3, 5, 1, ((1, 2), (0, 1)), 1),
    (1, 10, 10, 4, 3, 6, 2, "SAME", 1),
    (1, 9, 9, 4, 3, 5, 2, "VALID", 1),
]
LANE_SHAPES = [
    (1, 8, 8, 6, 3, 6, 1, "SAME", 6),
    (1, 8, 8, 6, 3, 12, 1, "SAME", 6),
    (1, 9, 7, 12, 3, 8, 2, "SAME", 4),
    (1, 8, 8, 8, 3, 8, 1, "VALID", 4),
    (2, 8, 8, 16, 5, 8, 2, 2, 4),
    (1, 8, 8, 4, 3, 8, 1, ((1, 2), (0, 1)), 4),
]


def fail(msg: str):
    print(f"FAILED: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def profile_forward(fn) -> dict:
    """Device time of one call of ``fn`` from a `torch.profiler` trace: the
    sum of its CUDA kernels' durations, the kernel count and the kernels
    that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        name = e.name[:60]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"device_busy_ms": sum(by_name.values()),
            "device_kernels": len(kernels), "top_kernels_ms": top}


def conv_cost(r: dict) -> tuple[int, int]:
    """(bytes, flops) of one conv: each input read once, each output
    written once; 2 FLOP per multiply-add."""
    from repro_torch.kernels.log_conv2d import _out_size, normalize_padding
    B, H, W, C, K, Cout = (r[k] for k in ("B", "H", "W", "C", "K", "Cout"))
    pads = normalize_padding(r["padding"], K, r["stride"], H, W)
    Ho = _out_size(H, K, r["stride"], pads[0])
    Wo = _out_size(W, K, r["stride"], pads[1])
    cin_g = C // r["groups"]
    nbytes = 4 * B * H * W * C + K * K * cin_g * Cout + 4 * Cout \
        + 4 * B * Ho * Wo * Cout
    return nbytes, 2 * B * Ho * Wo * Cout * K * K * cin_g


def make_conv(r: dict, rng, dev):
    """Random activations and packed codes for one conv record → (x, qt,
    HWIO codes, codes as the kernel gets them, lane meta): grouped codes
    lane-packed as `quantize_cnn_params` bakes depthwise ones."""
    from repro_torch.core.logquant import quantize_tensor
    from repro_torch.kernels.log_conv2d import (lane_pack_codes,
                                                lane_pack_geometry)
    B, H, W, C, K, Cout, G = (r[k] for k in ("B", "H", "W", "C", "K", "Cout",
                                             "groups"))
    x = torch.as_tensor(rng.normal(size=(B, H, W, C)).astype(np.float32),
                        device=dev)
    fan_in = K * K * C // G
    w = rng.normal(size=(K, K, C // G, Cout)) * (2.0 / fan_in) ** 0.5
    qt = quantize_tensor(torch.as_tensor(w.astype(np.float32), device=dev))
    hwio = qt.packed
    codes, lane_meta = hwio, None
    lp = lane_pack_geometry(G, C // G)
    if lp["g_b"] > 1:
        codes = lane_pack_codes(hwio, G, lp["g_b"], lp["cin_lane"])
        lane_meta = (lp["g_b"], lp["cin_lane"])
    return x, qt, hwio, codes, lane_meta


def phase_decode(dev) -> None:
    from repro_torch.kernels.log_conv2d import decode_codes, log_conv2d_fused
    codes = torch.arange(128, dtype=torch.int8, device=dev)
    want = decode_codes(codes).view(torch.int32)
    ones = torch.ones(128, device=dev)
    # Cin = 1: the depthwise path; Cin = 2 with x = (1, 0): the dense path
    y1 = log_conv2d_fused(torch.ones((1, 1, 1, 1), device=dev),
                          codes.reshape(1, 1, 1, 128), ones, padding="VALID")
    w2 = torch.stack([codes, codes.flip(0)]).reshape(1, 1, 2, 128)
    x2 = torch.tensor([1.0, 0.0], device=dev).reshape(1, 1, 1, 2)
    y2 = log_conv2d_fused(x2, w2.contiguous(), ones, padding="VALID")
    torch.cuda.synchronize()
    for path, y in (("depthwise", y1), ("dense", y2)):
        bad = int((y.reshape(-1).view(torch.int32) != want).sum())
        print(f"decode table, {path} path: {128 - bad}/128 codes bit-exact")
        if bad:
            fail(f"{bad} decoded codes differ from decode_codes ({path})")


def check_conv(r: dict, rng, dev, label: str) -> dict:
    """Kernel (HWIO and, where the group layout packs, lane-packed codes)
    against ref and blockwise on one shape."""
    from repro_torch.kernels.log_conv2d import (log_conv2d_blockwise,
                                                log_conv2d_fused,
                                                log_conv2d_ref)
    x, qt, hwio, codes, lane = make_conv(r, rng, dev)
    kw = dict(stride=r["stride"], padding=r["padding"], groups=r["groups"])
    y_ref = log_conv2d_ref(x, hwio, qt.scale, **kw)
    y_bw = log_conv2d_blockwise(x, hwio, qt.scale, **kw)
    outs = {"hwio": log_conv2d_fused(x, hwio, qt.scale, **kw)}
    if lane is not None:
        outs["lane"] = log_conv2d_fused(x, codes, qt.scale, lane=lane, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 * (float(y_ref.abs().max()) + 1)
    res = {"shape": label, "tol": tol}
    for name, y in outs.items():
        if y.shape != y_ref.shape or not bool(torch.isfinite(y).all()):
            fail(f"{label} {name}: shape {tuple(y.shape)} or non-finite")
        res[f"{name}_vs_ref"] = float((y - y_ref).abs().max())
        res[f"{name}_vs_blockwise"] = float((y - y_bw).abs().max())
        if max(res[f"{name}_vs_ref"], res[f"{name}_vs_blockwise"]) > tol:
            fail(f"{label} {name}: {res} exceeds tol {tol:.3e}")
    return res


def sweep_record(s) -> dict:
    B, H, W, C, K, P, stride, padding, groups = s
    return dict(B=B, H=H, W=W, C=C, K=K, Cout=P, stride=stride,
                padding=padding, groups=groups)


def sig(r: dict) -> tuple:
    return tuple(str(r[k]) for k in ("B", "H", "W", "C", "K", "Cout",
                                     "stride", "padding", "groups"))


def phase_sweeps(dev) -> tuple[list, float]:
    from repro_torch.models.cnn import zoo_conv_shapes
    rng = np.random.default_rng(SEED)
    rows = [check_conv(sweep_record(s), rng, dev, f"sweep {s}")
            for s in SHAPES + LANE_SHAPES]
    print(f"sweeps: {len(rows)} shapes within tol, max |kernel - ref| "
          f"{max(r['hwio_vs_ref'] for r in rows):.3e}")
    zoo = zoo_conv_shapes(batch=1, img=IMG, n_classes=N_CLASSES)
    if len(zoo) != 61:
        fail(f"expected 61 zoo conv shapes, traced {len(zoo)}")
    zrows = [check_conv(r, rng, dev, "zoo " + "/".join(sig(r)[1:]))
             for r in zoo]
    err = max(max(r.get("lane_vs_ref", 0.0), r["hwio_vs_ref"]) for r in zrows)
    worst = max(max(r.get("lane_vs_ref", 0.0), r["hwio_vs_ref"]) / r["tol"]
                for r in zrows)
    print(f"zoo shapes at batch 1: {len(zrows)} within tol, max |kernel - "
          f"ref| {err:.3e}, worst err/tol {worst:.3e}")
    return rows + zrows, err


def phase_slice(dev) -> tuple[list, int]:
    from repro_torch.kernels import ops
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    from repro_torch.models.cnn import CNNS, make_cnn
    from repro_torch.serving.quantize import quantize_cnn_params
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((BATCH, IMG, IMG, 3), generator=gen, device=dev)
    nets = {}
    for name in CNNS:
        params, _ = make_cnn(name, SEED, n_classes=N_CLASSES, device=dev)
        nets[name] = quantize_cnn_params(params, conv_layout="lane_packed")

    def forward(name, quant, impl):
        with torch.no_grad():
            return CNNS[name][1](nets[name], x, quant=quant, conv_impl=impl)

    def checked_forward(name, quant):
        """A forward on the kernel in which every conv's output is also held
        against blockwise on the very same input → (logits, launches,
        worst err/tol over the net's convs)."""
        conv, ratios = ops.conv2d, []

        def checked(xin, qt, **kw):
            y = conv(xin, qt, **kw)
            yb = conv(xin, qt, **dict(kw, impl="blockwise"))
            tol = 1e-4 * (float(yb.abs().max()) + 1)
            ratios.append(float((y - yb).abs().max()) / tol)
            return y

        ops.conv2d = checked
        try:
            before = log_conv2d_fused.launches
            out = forward(name, quant, "auto")
            torch.cuda.synchronize()
        finally:
            ops.conv2d = conv
        return out, log_conv2d_fused.launches - before, max(ratios)

    # the main path: the repo's default model configuration, quant="logq6";
    # the launch count is zeroed just before it and read just after it
    log_conv2d_fused.launches = 0
    for name in CNNS:
        before = log_conv2d_fused.launches
        forward(name, "logq6", "auto")
        torch.cuda.synchronize()
        launched = log_conv2d_fused.launches - before
        if launched != CONVS_PER_NET[name]:
            fail(f"{name}: kernel launched {launched} times on the main "
                 f"path, expected {CONVS_PER_NET[name]}")
    main_launches = log_conv2d_fused.launches
    print(f"main path: {main_launches} kernel launches for one forward of "
          f"each net ({CONVS_PER_NET})")

    rows = []
    for quant in ("logq6", None):
        for name in CNNS:
            out, launched, worst = checked_forward(name, quant)
            if launched != CONVS_PER_NET[name]:
                fail(f"{name}: kernel launched {launched} times, expected "
                     f"{CONVS_PER_NET[name]}")
            if worst > 1.0:
                fail(f"{name} quant={quant}: a conv exceeds its tolerance "
                     f"against blockwise on the same input (err/tol "
                     f"{worst:.3e})")
            if tuple(out.shape) != (BATCH, N_CLASSES) or \
                    not bool(torch.isfinite(out).all()):
                fail(f"{name}: logits {tuple(out.shape)} or non-finite")
            ref = forward(name, quant, "blockwise")
            drift = float((out - ref).abs().max())
            row = {"net": name, "quant": quant, "launches": launched,
                   "conv_err_over_tol": worst, "drift": drift,
                   "max_abs_logit": float(ref.abs().max()),
                   "top1_agree": float((out.argmax(-1) == ref.argmax(-1))
                                       .float().mean())}
            if quant:
                # logq6 re-quantizes every activation after its ReLU.  A sum
                # within fp32 rounding of a half-step boundary takes the
                # other code under another summation order; that √2 step
                # moves the next layer's sums enough to flip more codes, and
                # at full size the flips cascade through the net.  So two
                # correct versions differ in their logits by percents (the
                # control measures it between the two plain versions); the
                # per-conv check above is the tight one.
                rel = 0.25
                row["control_drift"] = float(
                    (forward(name, quant, "ref") - ref).abs().max())
            else:
                rel = 1e-3  # tests/test_cnn.py:106
            row["tol"] = tol = rel * (row["max_abs_logit"] + 1)
            if drift > tol:
                fail(f"{name} quant={quant}: |logits - blockwise| {drift:.3e}"
                     f" > tol {tol:.3e}")
            msg = ""
            if quant:
                row["forward_ms"] = time_ms(
                    lambda: forward(name, quant, "auto"), 3)
                row["blockwise_forward_ms"] = time_ms(
                    lambda: forward(name, quant, "blockwise"), 3)
                row["images_per_s"] = BATCH / row["forward_ms"] * 1e3
                row.update(profile_forward(
                    lambda: forward(name, quant, "auto")))
                # no device events means the profiler saw nothing: the idle
                # share is then not measured
                row["idle_share"] = (1 - row["device_busy_ms"]
                                     / row["forward_ms"]
                                     if row["device_kernels"] else None)
                msg = (f", ref-vs-blockwise control {row['control_drift']:.3e}"
                       f"; forward {row['forward_ms']:.3f} ms "
                       f"({row['images_per_s']:.1f} images/s), blockwise "
                       f"forward {row['blockwise_forward_ms']:.3f} ms; "
                       f"profiled: {row['device_kernels']} device kernels, "
                       f"busy {row['device_busy_ms']:.3f} ms, idle share "
                       f"{row['idle_share']}, top {row['top_kernels_ms'][:3]}")
            rows.append(row)
            print(f"slice {name:12s} quant={quant}: launches {launched}, "
                  f"worst conv err/tol {worst:.3e}, |logits - blockwise| "
                  f"{drift:.3e} (tol {tol:.3e}, max|l| "
                  f"{row['max_abs_logit']:.3e}, top-1 agree "
                  f"{row['top1_agree']:.3f}){msg}")
    return rows, main_launches


def phase_conv_times(dev) -> tuple[dict, list]:
    from repro_torch.kernels.log_conv2d import (conv_nhwc, decode_codes,
                                                log_conv2d_blockwise,
                                                log_conv2d_fused,
                                                log_conv2d_ref,
                                                normalize_padding)
    from repro_torch.models.cnn import CNNS, trace_conv_shapes, \
        zoo_conv_shapes
    rng = np.random.default_rng(SEED + 2)
    times = {}
    with torch.no_grad():
        for r in zoo_conv_shapes(batch=BATCH, img=IMG, n_classes=N_CLASSES):
            x, qt, hwio, codes, lane = make_conv(r, rng, dev)
            kw = dict(stride=r["stride"], padding=r["padding"],
                      groups=r["groups"])
            nbytes, flops = conv_cost(r)
            pads = normalize_padding(r["padding"], r["K"], r["stride"],
                                     r["H"], r["W"])
            w = decode_codes(hwio) * qt.scale.reshape(-1)
            t = {"ms": time_ms(lambda: log_conv2d_fused(
                     x, codes, qt.scale, lane=lane, **kw), 5),
                 "library_ms": time_ms(lambda: log_conv2d_blockwise(
                     x, hwio, qt.scale, **kw), 5),
                 "plain_ms": time_ms(lambda: log_conv2d_ref(
                     x, hwio, qt.scale, **kw), 2),
                 "conv_only_ms": time_ms(lambda: conv_nhwc(
                     x, w, stride=r["stride"], pads=pads,
                     groups=r["groups"]), 5),
                 "bytes_ms": nbytes / PEAK_HBM_BYTES * 1e3,
                 "ops_ms": flops / PEAK_FP32_FLOPS * 1e3,
                 "gflop": flops / 1e9}
            t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
            times[sig(r)] = t
            print(f"conv {'/'.join(sig(r))} ({','.join(r['nets'])}): kernel "
                  f"{t['ms']:.4f} ms, library {t['library_ms']:.4f} ms "
                  f"(conv alone {t['conv_only_ms']:.4f}), plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
            del x, qt, hwio, codes, w
            torch.cuda.empty_cache()
    nets = []
    for name in CNNS:
        recs = trace_conv_shapes(name, batch=BATCH, img=IMG,
                                 n_classes=N_CLASSES)
        tot = {k: sum(times[sig(r)][k] for r in recs)
               for k in ("ms", "library_ms", "plain_ms", "conv_only_ms",
                         "bound_ms",
                         "bytes_ms", "ops_ms", "gflop")}
        tot["net"], tot["convs"] = name, len(recs)
        nets.append(tot)
        print(f"convs {name:12s} x{len(recs)} at batch {BATCH}: kernel "
              f"{tot['ms']:.3f} ms, library {tot['library_ms']:.3f} ms "
              f"(conv alone {tot['conv_only_ms']:.3f} ms), "
              f"plain {tot['plain_ms']:.3f} ms, fp32 bound "
              f"{tot['bound_ms']:.3f} ms ({tot['gflop']:.1f} GFLOP, "
              f"{tot['gflop'] / tot['ms']:.2f} TFLOP/s)")
    return times, nets


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the GPU only")
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(f"fp32 settings: cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(built) or 'nothing (cached)'}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    phase_decode(dev)
    checks, max_err = phase_sweeps(dev)
    slice_rows, launches = phase_slice(dev)
    times, nets = phase_conv_times(dev)

    tot = {k: sum(n[k] for n in nets)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                     "ops_ms")}
    kernel = {"name": "log_conv2d_fused", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/log_conv2d.cu",
              "replaces": "src/repro/kernels/log_conv2d.py:491",
              "launches": launches, "max_abs_err": max_err,
              "ms": tot["ms"], "plain_ms": tot["plain_ms"],
              "bound_ms": tot["bound_ms"],
              "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                           else "bytes"),
              "library_ms": tot["library_ms"]}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernel": kernel, "checks": checks,
         "slice": slice_rows, "nets": nets,
         "conv_times": {"/".join(k): v for k, v in times.items()}},
        indent=1))
    print(f"times are sums over one batch-{BATCH} forward of each of the "
          f"four nets ({sum(CONVS_PER_NET.values())} convs)")
    print(json.dumps({"kernels": [kernel]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
