"""Beyond-paper ablation: base-√2 log gradient compression.  The twin of
the JAX package's `benchmarks/ablation_grad_compress.py`, over the port's
`training/{grad_compress,optimizer}.py`, `data/pipeline.py` and
`models/transformer.lm_loss`.

    python -m repro_torch.benchmarks.run --only ablation_grad_compress
    PYTHONPATH=src python -m repro_torch.benchmarks.run \
        --only ablation_grad_compress --device cpu

Three trainings of the same tiny LM on the same data:
  fp32       — uncompressed gradients (reference)
  log-EF     — 7-bit log-quantized gradients WITH error feedback (ours)
  log-naive  — 7-bit quantization WITHOUT error feedback

Claim: EF keeps convergence at fp32 level while moving 7/32 of the bytes.
Training runs no kernel: the config carries ``attn_impl="blockwise"``, as
`launch/train.py`'s does.  Writes ``BENCH_torch_ablation_grad_compress.json``
(`common.write_json`).
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.models.transformer import init_params, lm_loss
from repro_torch.training.grad_compress import (CompressorConfig,
                                                compress_decompress,
                                                compressor_init,
                                                log_compress_gradients,
                                                wire_bytes_fraction)
from repro_torch.training.optimizer import (OptimizerConfig,
                                            clip_by_global_norm,
                                            make_optimizer, tree_leaves,
                                            tree_map)

from .common import card_name, fmt_table, write_json

STEPS = 60
MODES = ("fp32", "log-EF", "log-naive")
EF_GAP_LIMIT = 0.15   # nats: |final loss of log-EF − fp32's|


def _train(mode: str, params=None, device=None, steps: int = STEPS) \
        -> list[float]:
    """``steps`` steps of ``mode`` from ``params`` (default: the port's
    `init_params(cfg, 0)`, drawn on the CPU so that every device starts
    from the same weights; the tensors are trained in place) → the loss of
    every step.  The step is the JAX bench's: loss and gradients, the
    mode's compression, clipping, AdamW."""
    device = resolve_device(device)
    cfg = get_config("gemma-2b").reduced(      # the JAX bench's reduced LM
        n_layers=2, vocab=256, d_model=64, d_ff=128, head_dim=16,
        attn_impl="blockwise")
    if params is None:
        params = tree_map(lambda t: t.to(device),
                          init_params(cfg, 0, device="cpu"))
    opt = OptimizerConfig(lr=5e-3, warmup_steps=5, total_steps=STEPS,
                          schedule="constant")
    opt_init, opt_update = make_optimizer(opt)
    opt_state = opt_init(params)
    ccfg = CompressorConfig()
    comp_state = compressor_init(params, ccfg)
    loader = ShardedLoader(DataConfig(seq_len=32, global_batch=8, vocab=256,
                                      seed=3))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    losses = []
    for s in range(steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in loader.batch(s).items()}
        with torch.enable_grad():
            loss, _ = lm_loss(params, batch, cfg, xent_chunk=32)
            gs = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda p: next(gs), params)
        if mode == "log-EF":
            grads, comp_state = log_compress_gradients(grads, comp_state,
                                                       ccfg)
        elif mode == "log-naive":
            grads = tree_map(
                lambda g: compress_decompress(g.to(torch.float32))
                if g.numel() >= ccfg.min_size else g, grads)
        grads, _ = clip_by_global_norm(grads, opt.grad_clip)
        params, opt_state = opt_update(grads, opt_state, params)
        losses.append(float(loss.detach()))
    return losses


def run(device=None, root=None) -> dict:
    device = resolve_device(device)
    final, first, secs = {}, {}, {}
    for m in MODES:
        t0 = time.perf_counter()
        losses = _train(m, device=device)
        secs[m] = time.perf_counter() - t0
        final[m] = sum(losses[-10:]) / 10
        first[m] = losses[0]
    rows = [{"mode": m, "final_loss(10-step avg)": round(v, 4),
             "wire_bytes": "1.00×" if m == "fp32"
             else f"{wire_bytes_fraction():.3f}×"} for m, v in final.items()]
    print(fmt_table(rows, list(rows[0])))
    gap_ef = final["log-EF"] - final["fp32"]
    gap_naive = final["log-naive"] - final["fp32"]
    # claim: compressed training matches fp32 at 0.219× wire bytes.  (At
    # this scale even naive quantization converges: the EF-vs-naive
    # separation is the bias-bound property, asserted in
    # tests/test_training.py::test_error_feedback_preserves_mean_signal.)
    ok = abs(gap_ef) < EF_GAP_LIMIT
    print(f"EF gap to fp32: {gap_ef:+.4f} nats (naive: {gap_naive:+.4f}) "
          f"at {wire_bytes_fraction():.3f}× wire bytes: "
          f"{'OK' if ok else 'FAIL'}  ({STEPS} steps a mode on "
          f"{card_name(device)}: "
          + ", ".join(f"{m} {s:.2f} s" for m, s in secs.items()) + ")")
    out = {"rows": rows, "ef_gap": gap_ef, "naive_gap": gap_naive,
           "final_loss": final, "first_loss": first, "seconds": secs,
           "steps": STEPS, "ok": ok, "device": card_name(device)}
    write_json("BENCH_torch_ablation_grad_compress.json", out, root)
    return out
