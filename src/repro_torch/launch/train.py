"""End-to-end training driver.

    python -m repro_torch.launch.train --arch gemma-2b --steps 8      # card
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
        --device cpu

Counterpart of `repro.launch.train` on one device: the card unless
``--device`` names another.  Restart the command after a crash and it
resumes from the latest checkpoint under ``--ckpt-dir``
(`runtime/checkpoint.py`).  The config carries ``attn_impl="blockwise"``
(the JAX package's default), so attention and the RWKV recurrence run
their plain versions, which autograd differentiates: the CUDA kernels
have no backward.  ``--production`` (the production mesh) and a restart
on another device count belong to the multi-device part of the port
(ROADMAP.md queue A, item 17).  On the card the closing lines give the
step time's p50 and p99, tokens/s at the p50 and the peak device memory.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.models import transformer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.monitor import HeartbeatMonitor
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             train)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="gemma-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--production", action="store_true",
                    help="the production mesh (not ported: ROADMAP.md "
                         "queue A, item 17)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true",
                    help="log-quant EF gradient compression (beyond-paper)")
    ap.add_argument("--quant", choices=["none", "logq6"], default="none")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Train as the arguments say → {"history", "step_s": {"p50", "p99",
    "count"}, "tokens_per_s" (at the p50), "peak_bytes" (the card's peak
    allocation, None elsewhere)}."""
    if args.production:
        raise NotImplementedError(
            "--production needs the multi-device mesh, ROADMAP.md queue A, "
            "item 17")
    cfg = dataclasses.replace(get_config(args.arch), attn_impl="blockwise")
    if args.reduced:
        cfg = cfg.reduced()
    if args.quant != "none":
        cfg = dataclasses.replace(cfg, quant=args.quant)

    params = transformer.init_params(cfg, args.seed, device=args.device)
    device = params["final_norm"]["scale"].device
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={device}")

    loader = ShardedLoader(DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab,
        seed=args.seed))

    tcfg = TrainConfig(
        opt=OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                            total_steps=args.steps),
        microbatches=args.microbatches, grad_compress=args.grad_compress,
        log_every=args.log_every,
        xent_chunk=min(512, args.seq))
    loss_fn = lambda p, b: transformer.lm_loss(p, b, cfg,  # noqa: E731
                                               xent_chunk=tcfg.xent_chunk)

    hooks = []
    start_step, state = 0, None
    monitor = HeartbeatMonitor(["host0"])

    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if mgr.latest_step() is not None:
            state, start_step = mgr.restore(init_train_state(params, tcfg))
            params = state["params"]
            print(f"resumed from step {start_step}")
        hooks.append(mgr.hook(args.ckpt_every))

    def progress(step, st, metrics):
        print(f"step {step:5d}  loss {metrics['loss']:.4f}  "
              f"gnorm {metrics['grad_norm']:.3f}  "
              f"wall {metrics['wall_s']:.1f}s")
    hooks.append(progress)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # heartbeats + the step-time histogram are fed from train()'s single
    # per-step event stream (not a separate hook clock)
    registry = obs_metrics.MetricsRegistry()
    state, history = train(loss_fn, params, loader, tcfg,
                           num_steps=args.steps - start_step,
                           start_step=start_step, state=state, hooks=hooks,
                           metrics=registry, monitor=monitor, host="host0")
    if args.ckpt_dir:
        mgr.save(int(state["step"]), state, sync=True)
    print(f"final loss {history[-1]['loss']:.4f} "
          f"(from {history[0]['loss']:.4f})")
    out = {"history": history, "step_s": None, "tokens_per_s": None,
           "peak_bytes": None}
    hist = registry.snapshot()["histograms"].get("train_step_s")
    if hist and hist["count"]:
        rep = monitor.report(int(state["step"]))
        out["step_s"] = {k: hist[k] for k in ("p50", "p99", "count")}
        out["tokens_per_s"] = args.batch * args.seq / hist["p50"]
        print(f"step time p50 {hist['p50']*1e3:.1f}ms p99 "
              f"{hist['p99']*1e3:.1f}ms over {hist['count']} steps "
              f"({out['tokens_per_s']:.0f} tokens/s at the p50); "
              f"stragglers={list(rep.stragglers)} missing={rep.missing}")
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        print(f"peak device memory {out['peak_bytes'] / 1e9:.2f} GB")
    return out


def main(argv=None):
    return run(parse_args(argv))["history"]


if __name__ == "__main__":
    main()
