"""Serving CLI: batched requests through the continuous-batching engine,
on packed log-code weights.

    python -m repro_torch.launch.serve --arch gemma-2b          # on the card
    python -m repro_torch.launch.serve --arch rwkv6-1.6b
    python -m repro_torch.launch.serve --arch recurrentgemma-2b
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --reduced --device cpu

Counterpart of `repro.launch.serve` (the mesh flags wait for ROADMAP.md
queue A, item 17).  Every token arch is served (`--arch`; also
granite-moe-1b-a400m, gemma3-1b, qwen1.5-4b, llama3-405b); the archs fed
with embeddings (musicgen-large, qwen2-vl-2b) are refused.  The weights are
random, from ``--seed``, and are packed by `serving.quantize.quantize_params`
before the engine is built, so on the card every packed dense layer (the
attention projections and dense FFNs) runs on the log_matmul kernel, every
attention call on the attention kernel and every RWKV layer's recurrence
on the wkv6 kernel.  The RG-LRU blocks and the MoE experts keep fp32
weights, as in the JAX package, and run as plain torch ops.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.models import transformer
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.serving.quantize import quantize_params


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions of the kernels)")
    ap.add_argument("--trace-out", default="",
                    help="write the Chrome trace here after the run "
                         "(requires REPRO_TRACE=1 or --telemetry on)")
    ap.add_argument("--metrics-out", default="",
                    help="write engine.metrics_snapshot() JSON here")
    ap.add_argument("--telemetry", choices=["auto", "on", "off"],
                    default="auto")
    return ap.parse_args(argv)


def build_engine(args) -> ServeEngine:
    """Random weights from ``args.seed`` on ``args.device``, packed, behind
    an engine with the arguments' batch, prompt and cache sizes."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = quantize_params(
        transformer.init_params(cfg, args.seed, device=args.device))
    return ServeEngine(cfg, params, EngineConfig(
        max_batch=args.max_batch, max_prompt=args.max_prompt,
        max_len=args.max_len, telemetry=args.telemetry))


def make_requests(args, vocab: int) -> list[Request]:
    """``args.requests`` prompts of 3 to max_prompt/2 - 1 random tokens
    from ``np.random.default_rng(args.seed)``, as `repro.launch.serve`
    draws them."""
    rng = np.random.default_rng(args.seed)
    reqs = []
    for uid in range(args.requests):
        T = int(rng.integers(3, args.max_prompt // 2))
        prompt = rng.integers(1, vocab, size=T).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt,
                            max_new_tokens=args.max_new,
                            temperature=args.temperature, seed=uid))
    return reqs


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(args)
    for req in make_requests(args, engine.cfg.vocab):
        engine.submit(req)

    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s) on {engine.device}  stats={engine.stats}")
    for r in done[: 4]:
        print(f"  req {r.uid}: prompt[:4]={list(r.prompt[:4])} "
              f"→ {r.output[:8]}…")
    snap = engine.metrics_snapshot()
    ttft = snap["engine"]["histograms"].get("serve_ttft_s", {})
    if ttft.get("count"):
        tps = snap["engine"]["histograms"]["serve_tokens_per_s"]
        print(f"  ttft p50 {ttft['p50']*1e3:.1f}ms p99 {ttft['p99']*1e3:.1f}"
              f"ms  per-req tok/s p50 {tps['p50']:.1f}")
    if args.metrics_out:
        d = os.path.dirname(args.metrics_out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True, default=str)
        print(f"  metrics snapshot → {args.metrics_out}")
    if args.trace_out:
        obs_trace.export_chrome_trace(args.trace_out)
        print(f"  chrome trace → {args.trace_out}")
    return done


if __name__ == "__main__":
    main()
