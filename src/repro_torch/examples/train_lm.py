"""End-to-end driver: train a ~100M-param LM for a few hundred steps with
the paper's technique on (logq6 fake-quant weights) and log-compressed
gradients, checkpointing and resuming along the way.

    python -m repro_torch.examples.train_lm [--steps 300] [--params-m 100]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu

Counterpart of `examples/train_lm.py`: a gemma-family config scaled to
~--params-m million parameters, the same model/trainer/checkpoint stack
the launcher uses (`launch/train.py`), on one device (the card unless
``--device`` names another).  Given a ``--ckpt-dir`` that holds a
checkpoint, it resumes from the latest one.  Expect a clear loss drop
(≈10.4 = ln V → ≈3 on the synthetic zipf stream); the run fails unless
the final loss is more than 1.0 under the first.
"""

import argparse
import dataclasses
import tempfile

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.models import transformer
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             train)


def scaled_config(params_m: float):
    """gemma-family config with ≈params_m million parameters, on the plain
    (differentiable) attention."""
    base = get_config("gemma-2b")
    d = 512
    cfg = dataclasses.replace(
        base, n_layers=8, d_model=d, n_heads=8, n_kv_heads=1, head_dim=64,
        d_ff=4 * d, vocab=32_768, quant="logq6", remat=False,
        attn_block_k=256, attn_impl="blockwise")
    # grow width until the analytic count reaches the target
    while cfg.param_count() < params_m * 1e6:
        d += 128
        cfg = dataclasses.replace(cfg, d_model=d, d_ff=4 * d)
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--params-m", type=float, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-compress", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def run(args, params=None):
    """Train (resuming from ``args.ckpt_dir``'s latest checkpoint if it has
    one) and checkpoint at the end.  ``params``: initial weights (default:
    `init_params` from seed 0).  Returns the history."""
    cfg = scaled_config(args.params_m)
    print(f"model: {cfg.param_count()/1e6:.0f}M params, d={cfg.d_model}, "
          f"{cfg.n_layers}L, quant={cfg.quant}")

    if params is None:
        params = transformer.init_params(cfg, 0, device=args.device)
    loader = ShardedLoader(DataConfig(seq_len=args.seq,
                                      global_batch=args.batch,
                                      vocab=cfg.vocab, seed=0))
    tcfg = TrainConfig(
        opt=OptimizerConfig(lr=3e-3, warmup_steps=30,
                            total_steps=args.steps),
        grad_compress=args.grad_compress, log_every=20,
        xent_chunk=min(256, args.seq))
    loss_fn = lambda p, b: transformer.lm_loss(  # noqa: E731
        p, b, cfg, xent_chunk=tcfg.xent_chunk)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=2)
    start, state = 0, None
    if mgr.latest_step() is not None:
        state, start = mgr.restore(init_train_state(params, tcfg))
        print(f"resumed from step {start}")
    hooks = [mgr.hook(every=100),
             lambda s, st, m: print(f"  step {s:4d} loss {m['loss']:.4f} "
                                    f"gnorm {m['grad_norm']:.2f}")]

    state, hist = train(loss_fn, params, loader, tcfg,
                        num_steps=args.steps - start, start_step=start,
                        state=state, hooks=hooks)
    mgr.save(int(state["step"]), state, sync=True)
    print(f"first loss {hist[0]['loss']:.4f} → final {hist[-1]['loss']:.4f}"
          f"  (ckpts in {ckpt_dir})")
    return hist


def main(argv=None):
    hist = run(parse_args(argv))
    assert hist[-1]["loss"] < hist[0]["loss"] - 1.0, "training failed"
    return hist


if __name__ == "__main__":
    main()
