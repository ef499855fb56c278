"""Serve a small model with batched requests through the continuous-
batching engine — mixed prompt lengths, temperature/greedy mix, slot
refill, plus a correctness spot-check against naive decode.

    python -m repro_torch.examples.serve_lm                   # the card
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

Counterpart of `examples/serve_lm.py`: gemma3-1b ``reduced(n_layers=4)``
(local and global layers), the same ten requests (numpy, seed 0), fp
weights from the seed (`run` also takes given weights, e.g. a JAX tree
bridged with `params_from_numpy`).  On the card the engine's attention
runs on the attention kernel.  Greedy decoding equals the JAX engine's on
the same weights; sampled tokens come from another generator.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import transformer
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine


def config():
    return get_config("gemma3-1b").reduced(n_layers=4)  # local+global mix


def run(cfg, params):
    """Serve the ten requests and spot-check one greedy request against
    naive full-forward decode.  Returns (finished requests, whether the
    spot check agreed)."""
    engine = ServeEngine(cfg, params, EngineConfig(
        max_batch=4, max_prompt=32, max_len=64))

    rng = np.random.default_rng(0)
    n_req = 10
    for uid in range(n_req):
        T = int(rng.integers(3, 16))
        prompt = rng.integers(1, cfg.vocab, size=T).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=12,
                              temperature=0.0 if uid % 2 else 0.8,
                              seed=uid))

    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)}/{n_req} requests, {toks} tokens in {dt:.1f}s"
          f" ({toks/dt:.1f} tok/s)  stats={engine.stats}")

    # spot-check one greedy request against naive full-forward decode
    req = next(r for r in done if r.temperature == 0.0)
    device = params["embed"]["table"].device
    toks_ref = list(req.prompt)
    with torch.no_grad():
        for _ in range(len(req.output)):
            h, _, _ = transformer.forward(
                params, torch.tensor([toks_ref], device=device), cfg)
            logits = transformer.logits_fn(params, h[:, -1:], cfg)
            toks_ref.append(int(logits[0, 0].argmax()))
    ok = toks_ref[len(req.prompt):] == req.output
    print(f"greedy request {req.uid} matches naive decode: {ok}")
    return done, ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = config()
    done, ok = run(cfg, transformer.init_params(cfg, 0, device=args.device))
    assert ok
    return done


if __name__ == "__main__":
    main()
