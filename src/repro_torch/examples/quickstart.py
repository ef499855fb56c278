"""Quickstart: the paper's technique end to end in five steps.

1. log-quantize a weight matrix to 6-bit base-√2 codes (paper §3);
2. multiply with the log-domain shift+LUT semantics (paper §4, eq. 8) and
   check it against the float product;
3. run a 3×3 convolution through the functional NeuroMAX 6×3×6 PE-grid
   model (paper §5) and check it against a plain convolution;
4. analyze VGG16 on the accelerator dataflow model (paper §6);
5. call the framework's log_matmul op: on the card the hand-written CUDA
   kernel that decodes the codes next to the multiply (on the CPU its
   plain version).

    python -m repro_torch.examples.quickstart                 # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Counterpart of `examples/quickstart.py`, with the same inputs (numpy, seed
0) and the same printed figures; the PE grid, the log-PE thread's LUT and
step 5's tensors live on ``--device`` (default: the card).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.accelerator import run_network
from repro_torch.core.device import resolve_device
from repro_torch.core.logmath import LogPEThread
from repro_torch.core.logquant import (DEFAULT, log_dequantize, log_quantize,
                                       quantize_tensor)
from repro_torch.core.pe_grid import PEGrid
from repro_torch.kernels import ops
from repro_torch.kernels.log_conv2d import conv_nhwc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    out = {}

    # 1 — quantize ----------------------------------------------------------
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 8)).astype(np.float32) * 0.1
    packed, scale = log_quantize(torch.from_numpy(w), DEFAULT)
    deq = log_dequantize(packed, scale, DEFAULT).numpy()
    rel = np.abs(deq - w) / np.abs(w)
    out["median_rel_err"] = float(np.median(rel))
    print(f"1. 6-bit base-√2 codes: median |rel err| = "
          f"{np.median(rel)*100:.1f}% (bound 2^(1/4)-1 = 18.9%)")

    # 2 — shift+LUT product (eq. 8) -----------------------------------------
    thread = LogPEThread(device=device)
    wq, aq = -3, -5                  # codes: w = 2^(-1.5), a = 2^(-2.5)
    got = thread.to_float(thread(wq, aq))
    want = 2.0 ** (wq / 2) * 2.0 ** (aq / 2)
    out["thread"] = (got, want)
    print(f"2. log-PE thread: LUT(frac)>>~int = {got:.6f}, closed form "
          f"{want:.6f}  (Δ={abs(got-want):.2e})")

    # 3 — PE grid conv (§5.1) -----------------------------------------------
    x = rng.normal(size=(12, 6, 1)).astype(np.float32)
    k = rng.normal(size=(3, 3, 1, 1)).astype(np.float32)
    grid = PEGrid(mode="float", device=device)
    y, stats = grid.conv2d(x, k, stride=1)
    y = y[:, :, 0].cpu().numpy()
    ref = conv_nhwc(torch.from_numpy(x)[None], torch.from_numpy(k),
                    stride=1, pads=((0, 0), (0, 0)))[0, :, :, 0].numpy()
    out["grid_matches"] = bool(np.allclose(y, ref, atol=1e-4))
    out["grid_stats"] = (stats.active_utilization,
                         stats.psum_storage_fraction)
    # C=1 occupies 1 of 6 PE matrices; §5.1's 83.3% counts the active matrix
    print(f"3. PE-grid 3×3 conv matches a plain conv: "
          f"{out['grid_matches']}; "
          f"active-matrix utilization {stats.active_utilization*100:.1f}% "
          f"(paper §5.1: 83.3%), "
          f"stored psums {stats.psum_storage_fraction*100:.0f}% (paper: 11%)")

    # 4 — whole-CNN analysis (§6) -------------------------------------------
    perf = run_network("vgg16")
    out["vgg16"] = (perf.mean_layer_utilization, perf.throughput_gops_paper,
                    perf.latency_ms)
    print(f"4. VGG16 on NeuroMAX: util {perf.mean_layer_utilization*100:.1f}%"
          f" (paper 95%), {perf.throughput_gops_paper:.1f} GOPS (paper "
          f"307.8), latency {perf.latency_ms:.1f} ms (paper 240.23)")

    # 5 — the kernel op -----------------------------------------------------
    x = torch.as_tensor(rng.normal(size=(4, 256)).astype(np.float32),
                        device=device)
    qt = quantize_tensor(torch.as_tensor(
        (rng.normal(size=(256, 128)) * 0.05).astype(np.float32),
        device=device))
    y = ops.log_matmul(x, qt)
    y_ref = x @ qt.dequantize(torch.float32)
    err = float((y - y_ref).abs().max())
    out["log_matmul_err"] = err
    print(f"5. kernels.ops.log_matmul (decode next to the multiply, on "
          f"{device.type}): max|Δ| vs dequant matmul = {err:.2e}")
    print("done.")
    return out


if __name__ == "__main__":
    main()
