"""Fig. 1 — linear vs log quantization quality.  The twin of the JAX
package's `benchmarks/fig1_quant.py`, over the port's `core/logquant.py`
and `models/cnn.py`.

    python -m repro_torch.benchmarks.run --only fig1_quant       # the card
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig1_quant \
        --device cpu

The paper shows weight histograms for VGG16/SqueezeNet under 1.5-bit
linear, 5.0-bit log (base 2) and 5.1-bit log (base √2), and reports VGG16
top-1 dropping ≈3.5 pts under base-√2 vs ≈10 pts under base-2.  With no
pretrained weights, the claim is reproduced as a trend in two forms:
  1. quantization SNR of weight-like tensors (normal, heavy-tailed) under
     the three schemes, on the JAX bench's numpy draws;
  2. logit fidelity of a random-init VGG16 forward under fake-quant
     weights (`logit_fidelity`): base-√2 must sit closer to fp32 than
     base-2.  At the JAX bench's size by default (width 0.25, 32 px, 100
     classes, 4 images); ``width_mult``, ``img``, ``n_classes`` and
     ``batch`` set another.

The forwards run in fp32 (cuDNN's TF32 off inside them).  Writes
``BENCH_torch_fig1_quant.json`` (`common.write_json`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.logquant import (LogQuantConfig, linear_quantize,
                                       log_dequantize, log_quantize,
                                       quantization_snr_db)
from repro_torch.models.cnn import CNNS, make_cnn

from .common import card_name, fmt_table, write_json

SCHEMES = {
    "linear Q1.2 (1.5b eff)": ("linear", dict(int_bits=2, frac_bits=2)),
    "log base-2  (5.0b)": ("log", LogQuantConfig(frac_bits=0,
                                                 per_channel=False)),
    "log base-√2 (5.1b)": ("log", LogQuantConfig(frac_bits=1,
                                                 per_channel=False)),
}
BASE2, SQRT2 = "log base-2  (5.0b)", "log base-√2 (5.1b)"
WIDTH_MULT, IMG, N_CLASSES, BATCH = 0.25, 32, 100, 4   # the JAX bench's
PARAM_SEED, X_SEED = 1, 2


def _quantize(w: torch.Tensor, scheme) -> torch.Tensor:
    kind, cfg = scheme
    if kind == "linear":
        scale = float(w.abs().max()) or 1.0
        return linear_quantize(w / scale, **cfg) * scale
    packed, s = log_quantize(w, cfg)
    return log_dequantize(packed, s, cfg)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


@torch.no_grad()
def logit_fidelity(params, x: torch.Tensor, device=None) -> dict:
    """{scheme: correlation of VGG16's logits under the scheme's
    fake-quant weights (every leaf of ≥ 2 dims) with the fp32 logits}."""
    device = resolve_device(device)
    apply = CNNS["vgg16"][1]
    x = x.to(device)
    # cuDNN without TF32: the JAX bench's forwards are fp32
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        ref = apply(params, x).double().cpu().numpy().ravel()
        fidelity = {}
        for name, scheme in SCHEMES.items():
            qparams = _tree_map(
                lambda w: _quantize(w, scheme) if w.ndim >= 2 else w, params)
            out = apply(qparams, x).double().cpu().numpy().ravel()
            fidelity[name] = float(np.corrcoef(ref, out)[0, 1])
    return fidelity


def snr_rows(device=None) -> list[dict]:
    """Part 1: the SNR rows, on the JAX bench's draws
    (`np.random.default_rng(0)`, the same two distributions)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    dists = {
        "normal*0.05": rng.normal(size=65536).astype(np.float32) * 0.05,
        "laplace": rng.laplace(size=65536).astype(np.float32) * 0.03,
    }
    rows = []
    for name, scheme in SCHEMES.items():
        row = {"scheme": name}
        for dname, w in dists.items():
            wq = _quantize(torch.as_tensor(w, device=device), scheme)
            row[f"snr_{dname}_db"] = round(quantization_snr_db(w, wq), 2)
        rows.append(row)
    return rows


def run(device=None, root=None, *, width_mult=WIDTH_MULT, img=IMG,
        n_classes=N_CLASSES, batch=BATCH) -> dict:
    device = resolve_device(device)
    rows = snr_rows(device)
    snr = {r["scheme"]: r["snr_normal*0.05_db"] for r in rows}
    params, _ = make_cnn("vgg16", PARAM_SEED, n_classes=n_classes,
                         width_mult=width_mult, device=device)
    # drawn on the CPU, so that the images are the same on every device
    gen = torch.Generator().manual_seed(X_SEED)
    x = torch.randn((batch, img, img, 3), generator=gen)
    fidelity = logit_fidelity(params, x, device)
    for row in rows:
        row["vgg16_logit_corr"] = round(fidelity[row["scheme"]], 4)

    print(fmt_table(rows, list(rows[0])))
    s2, ss2 = snr[BASE2], snr[SQRT2]
    ok = ss2 > s2 + 4.0 and fidelity[SQRT2] > fidelity[BASE2]
    print(f"paper claim (base-√2 ≫ base-2): {'REPRODUCED' if ok else 'FAIL'}"
          f"  (ΔSNR={ss2-s2:+.1f} dB; VGG16 width {width_mult}, {img} px, "
          f"{n_classes} classes, batch {batch}, on {card_name(device)})")
    out = {"rows": rows, "snr_gain_db": ss2 - s2,
           "corr_sqrt2": fidelity[SQRT2], "logit_corr": fidelity, "ok": ok,
           "size": {"width_mult": width_mult, "img": img,
                    "n_classes": n_classes, "batch": batch},
           "device": card_name(device)}
    write_json("BENCH_torch_fig1_quant.json", out, root)
    return out
