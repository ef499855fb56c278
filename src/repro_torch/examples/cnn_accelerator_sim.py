r"""The paper's own workload end to end on the port: a log-quantized CNN
trained with the accelerator's numerics (QAT), served on packed int8 log
codes through the conv kernel, then deployed onto the NeuroMAX dataflow
model for per-layer utilization and latency.

    PYTHONPATH=src python -m repro_torch.examples.cnn_accelerator_sim
    PYTHONPATH=src python -m repro_torch.examples.cnn_accelerator_sim \
        --device cpu

Counterpart of `examples/cnn_accelerator_sim.py`.  It runs on the card
unless ``--device cpu`` is given; on the card every packed conv launches
the hand-written conv kernel (``conv_impl="auto"``), on the CPU its plain
version.  The QAT path's convs are plain `F.conv2d`.  TF32 is off, so both
paths are full fp32: with it on, activation re-quantization flips.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from repro_torch.core.accelerator import NETWORKS, run_network
from repro_torch.core.device import resolve_device
from repro_torch.core.logquant import log_quantize
from repro_torch.models import cnn as tcnn
from repro_torch.serving.quantize import (quantize_cnn_params,
                                          quantized_fraction)

N_CLASSES = 8


def synthetic_batch(device) -> dict:
    """A fixed synthetic 8-class set of 32 images of 32 px: a
    class-dependent frequency pattern (needs actual features, not bias)."""
    r = np.random.default_rng(0)
    y = np.tile(np.arange(N_CLASSES), 4)                     # 32 samples
    x = r.normal(size=(32, 32, 32, 3)).astype(np.float32)
    grid = np.linspace(0, 2 * np.pi, 32)
    for i, yy in enumerate(y):
        x[i, :, :, 0] += 2.0 * np.sin((yy + 1) * grid)[None, :]
    return {"images": torch.as_tensor(x, device=device),
            "labels": torch.as_tensor(y, dtype=torch.int64, device=device)}


def param_leaves(tree) -> list:
    """The tensors of a parameter tree, dict keys in sorted order (the
    order of `jax.tree.leaves`)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def loss_and_grads(apply_fn, params, batch):
    """(loss, accuracy, gradients in `param_leaves` order) of one batch."""
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, aux = tcnn.cnn_loss(apply_fn, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), aux["acc"], grads


def sgd_step(params, mom: list, grads, lr: float) -> None:
    """Clip the gradients to a global norm of 1, then SGD with momentum
    0.9, in place."""
    gn = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = torch.clamp(1.0 / gn, max=1.0)
    with torch.no_grad():
        for p, m, g in zip(param_leaves(params), mom, grads):
            m.mul_(0.9).add_(g * clip)
            p.sub_(lr * m)


def train_quantized_cnn(steps: int = 250, device=None):
    """Tiny SqueezeNet (width 0.25, 8 classes, 32 px) with logq6 fake-quant
    (the accelerator's numerics), fit on `synthetic_batch` with a linear
    learning-rate decay.  Random init from seed 0 on ``device`` (default:
    the card)."""
    device = resolve_device(device)
    params, apply_fn = tcnn.make_cnn("squeezenet", 0, n_classes=N_CLASSES,
                                     width_mult=0.25, quant="logq6",
                                     device=device)
    batch = synthetic_batch(device)
    mom = [torch.zeros_like(t) for t in param_leaves(params)]
    # deterministic cuDNN algorithms: a run on the card is reproducible
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for s in range(steps):
            lr = 0.02 * (1.0 - 0.8 * s / steps)          # linear decay
            loss, acc, grads = loss_and_grads(apply_fn, params, batch)
            sgd_step(params, mom, grads, lr)
            if s % 30 == 0 or s == steps - 1:
                print(f"  step {s:3d}  loss {float(loss):.3f} "
                      f"acc {float(acc)*100:.0f}%")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return float(loss), float(acc), params, apply_fn, batch


@contextlib.contextmanager
def _recording_convs(outs: list):
    """Append every conv output of the model code to ``outs``."""
    conv = tcnn.conv2d

    def recorded(p, x, **kw):
        y = conv(p, x, **kw)
        outs.append(y)
        return y

    tcnn.conv2d = recorded
    try:
        yield outs
    finally:
        tcnn.conv2d = conv


def first_code_difference(apply_fn, params, qparams, images) -> str:
    """Which conv of the packed forward first gives other activation codes
    (its output after ReLU, log-quantized as the next layer sees it) than
    the fake-quant forward, and in how many elements."""
    runs = []
    for p, impl in ((params, None), (qparams, "auto")):
        with _recording_convs([]) as outs, torch.no_grad():
            apply_fn(p, images, conv_impl=impl)
        runs.append(outs)
    for i, (y_fq, y_q) in enumerate(zip(*runs)):
        c_fq = log_quantize(torch.relu(y_fq))[0]
        c_q = log_quantize(torch.relu(y_q))[0]
        n = int((c_fq != c_q).sum())
        if n:
            return (f"conv {i} of {len(runs[0])} (output "
                    f"{tuple(y_q.shape)}) is the first whose codes differ: "
                    f"{n} of {c_q.numel()}")
    return "no conv's output codes differ"


def serve_packed(params, apply_fn, batch) -> dict:
    """Deployed numerics: pack the conv weights to int8 log codes once and
    route every conv through `kernels/ops.conv2d` (the kernel on the card).
    Raises unless the packed logits equal the fake-quant ones within
    1e-3·(max|l| + 1)."""
    with torch.no_grad():
        qparams = quantize_cnn_params(params)
        logits_fq = apply_fn(params, batch["images"])
        logits_q = apply_fn(qparams, batch["images"], conv_impl="auto")
    acc = float((logits_q.argmax(-1) == batch["labels"]).float().mean())
    drift = float((logits_q - logits_fq).abs().max())
    limit = 1e-3 * (float(logits_fq.abs().max()) + 1)
    print(f"  packed {quantized_fraction(qparams)*100:.0f}% of param bytes "
          f"to int8 codes; serving acc {acc*100:.0f}%, "
          f"max logit drift vs fake-quant {drift:.2e} (limit {limit:.2e})")
    # the demo's claim: deployed packed-code numerics == QAT numerics
    if not drift < limit:
        raise AssertionError(
            f"packed logits drift {drift:.3e} >= {limit:.3e}; "
            + first_code_difference(apply_fn, params, qparams,
                                    batch["images"]))
    return {"acc": acc, "drift": drift, "limit": limit}


def dataflow_walk() -> dict:
    """The four paper nets through the dataflow model of the accelerator:
    a Zynq-7020 at 200 MHz, modelled, not measured."""
    out = {}
    for net in NETWORKS:
        perf = run_network(net)
        out[net] = perf
        print(f"  {net:13s} util {perf.mean_layer_utilization*100:5.1f}%  "
              f"{perf.throughput_gops_paper:6.1f} GOPS  "
              f"latency {perf.latency_ms:7.2f} ms  "
              f"DDR {perf.ddr_bytes_log/2**20:6.1f} MiB/inference "
              f"(vs {perf.ddr_bytes_fp16/2**20:.1f} MiB fp16 — "
              f"{perf.ddr_bytes_fp16/perf.ddr_bytes_log:.2f}× saved)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print("1. training SqueezeNet (logq6 fake-quant = accelerator "
          "numerics):")
    loss, acc, params, apply_fn, batch = train_quantized_cnn(device=device)
    if acc <= 0.5:  # QAT-from-scratch on 32 samples is seed-sensitive
        print(f"  (warning: train acc only {acc*100:.0f}% this run)")

    print(f"\n2. serving with packed int8 log codes (kernels/ops.conv2d "
          f"on {device.type}):")
    served = serve_packed(params, apply_fn, batch)
    if not abs(served["acc"] - acc) < 0.2:
        raise AssertionError("packed-weight serving lost the model")

    print("\n3. deploying onto the NeuroMAX grid (dataflow model of the "
          "Zynq-7020 at 200 MHz; modelled figures):")
    dataflow_walk()
    print("\nThe 7-bit log codes cut the modelled DDR traffic ≈2.3× "
          "against fp16.")


if __name__ == "__main__":
    main()
