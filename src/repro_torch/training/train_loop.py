"""Training loop: grad-accumulation microbatching, metrics, hooks,
checkpoint integration.  Model-agnostic — works for every assigned arch and
the CNN substrate via a `loss_fn(params, batch) -> (loss, metrics)`.

Counterpart of `repro.training.train_loop` on torch autograd.  Where JAX
jits the step and donates the state's buffers, the port runs the step
eagerly and updates the state's tensors in place (`training.optimizer`);
`train` therefore has no ``jit=`` / ``donate=`` (one program per step, a
CUDA graph, is ROADMAP.md queue A, item 19).  Microbatches accumulate in a
Python loop where JAX scans.  Batches may hold numpy arrays (the loader's)
or tensors; the step moves them to the parameters' device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import sharding
from repro_torch.models.cnn import params_from_numpy
from repro_torch.obs import trace as obs_trace
from .grad_compress import (CompressorConfig, compressor_init,
                            log_compress_gradients)
from .optimizer import (OptimizerConfig, clip_by_global_norm, make_optimizer,
                        tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1            # grad accumulation factor
    grad_compress: bool = False      # log-quant EF compression
    log_every: int = 10
    ckpt_every: int = 0              # 0 = never
    xent_chunk: int = 512


TrainState = dict  # {"params", "opt", "compress", "step"}


def init_train_state(params, cfg: TrainConfig) -> TrainState:
    """The state holds ``params`` themselves, not a copy: the steps update
    them in place."""
    opt_init, _ = make_optimizer(cfg.opt)
    device = tree_leaves(params)[0].device
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.grad_compress:
        state["compress"] = compressor_init(params)
    return state


def _tensor(x, device):
    if isinstance(x, dict):
        return {k: _tensor(v, device) for k, v in x.items()}
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device)


def train_state_from_numpy(tree, device=None) -> TrainState:
    """A train state of numpy arrays (e.g. JAX's, converted with
    ``np.asarray``) → the port's: the params through `params_from_numpy`
    (fp32), every other leaf (optimizer moments and ``count``, the
    compressor's errors, ``step``) with its keys and dtype, on ``device``
    (default: the card)."""
    device = resolve_device(device)

    def leaf(a):
        a = np.array(a)
        if a.dtype.kind == "V":   # bfloat16 of ml_dtypes: exact in fp32
            return torch.as_tensor(a.astype(np.float32),
                                   device=device).to(torch.bfloat16)
        return torch.as_tensor(a, device=device)

    return {k: (params_from_numpy(v, device) if k == "params"
                else tree_map(leaf, v) if isinstance(v, dict) else leaf(v))
            for k, v in tree.items()}


def train_state_to_numpy(state) -> dict:
    """The inverse of `train_state_from_numpy`: every tensor copied to a
    numpy array of its dtype (bf16 as fp32, which holds it exactly)."""
    def leaf(t):
        t = t.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy().copy()
    return tree_map(leaf, state)


def make_train_step(loss_fn: Callable, cfg: TrainConfig):
    """loss_fn(params, microbatch) -> (loss, metrics dict of 0-d tensors).

    The returned step takes (state, batch) where batch leaves have leading
    dim = microbatches × per-micro batch and returns (state, metrics); the
    state's tensors are updated in place.  Under a mesh the state may hold
    DTensors (`launch.steps.state_shardings`); the step runs inside
    `sharding.sharded_region`.  Each microbatch's gradients are
    summed in fp32 before the next runs, so peak activation memory is one
    microbatch.
    """
    _, opt_update = make_optimizer(cfg.opt)
    ccfg = CompressorConfig(enabled=cfg.grad_compress)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = tree_map(lambda p: _or_zeros(next(gs), p), params)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def step(state: TrainState, batch):
        with sharding.sharded_region():
            return _step(state, batch)

    def _step(state: TrainState, batch):
        params = state["params"]
        batch = _tensor(batch, tree_leaves(params)[0].device)
        if cfg.microbatches > 1:
            mb = cfg.microbatches

            def split(x):
                return x.reshape((mb, x.shape[0] // mb) + tuple(x.shape[1:]))
            micro = tree_map(split, batch)
            gsum, loss_sum = None, 0.0
            for i in range(mb):
                loss, _, g = grads_of(params, tree_map(lambda x: x[i], micro))
                g = tree_map(lambda t: t.to(torch.float32), g)
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / mb, gsum)
            loss = loss_sum / mb
            metrics = {}
        else:
            loss, metrics, grads = grads_of(params, batch)

        if cfg.grad_compress:
            grads, new_comp = log_compress_gradients(
                grads, state["compress"], ccfg)

        grads, gnorm = clip_by_global_norm(grads, cfg.opt.grad_clip)
        new_params, new_opt = opt_update(grads, state["opt"], params)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if cfg.grad_compress:
            new_state["compress"] = new_comp
        # a DTensor metric may be a partial sum: its whole value
        out_metrics = {k: sharding.full(v) for k, v in
                       {"loss": loss, "grad_norm": gnorm, **metrics}.items()}
        return new_state, out_metrics

    return step


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(loss_fn, params, loader, cfg: TrainConfig, *, num_steps: int,
          start_step: int = 0, state: TrainState | None = None,
          hooks: list[Callable] | None = None, metrics: Any = None,
          monitor: Any = None, host: str = "host0"):
    """Run `num_steps` steps.  Returns (state, history).

    hooks: callables (step:int, state, metrics:dict) -> None, run on host
    every cfg.log_every steps (checkpointing, straggler heartbeats, …).

    Telemetry: `metrics` (an `obs.metrics.MetricsRegistry`) gets a
    ``train_step_s`` histogram, and `monitor` (a
    `runtime.monitor.HeartbeatMonitor`) gets a ``record(host, step, dt)``
    heartbeat — both fed from the **same per-step wall-time event**, which
    also makes the ``train_step`` trace span, so fleet-health straggler
    detection and the step-time percentiles can never disagree about what
    was measured.  A truthful per-step time needs the card synchronised
    after each step (JAX's ``block_until_ready``), so that happens only
    when a consumer (metrics/monitor/active tracer) is attached.
    """
    state = state if state is not None else init_train_state(params, cfg)
    step_fn = make_train_step(loss_fn, cfg)
    device = tree_leaves(state["params"])[0].device
    step_hist = (metrics.histogram("train_step_s")
                 if metrics is not None else None)

    def emit_step(step, dt_s, t0_ns, dur_ns):
        # the single step-event source feeding every telemetry consumer
        if step_hist is not None:
            step_hist.record(dt_s)
        if monitor is not None:
            monitor.record(host, step, dt_s)
        obs_trace.add_complete("train_step", t0_ns, dur_ns, step=step)

    history = []
    t0 = time.perf_counter()
    for step in range(start_step, start_step + num_steps):
        batch = loader.batch(step) if hasattr(loader, "batch") \
            else next(loader)
        timed = (step_hist is not None or monitor is not None
                 or obs_trace.enabled())
        if timed:
            ts0 = time.perf_counter_ns()
            state, step_metrics = step_fn(state, batch)
            _sync(device)
            dur = time.perf_counter_ns() - ts0
            emit_step(step, dur / 1e9, ts0, dur)
        else:
            state, step_metrics = step_fn(state, batch)
        if cfg.log_every and (step % cfg.log_every == 0
                              or step == start_step + num_steps - 1):
            step_metrics = {k: float(v) for k, v in step_metrics.items()}
            step_metrics["step"] = step
            step_metrics["wall_s"] = time.perf_counter() - t0
            history.append(step_metrics)
            for h in (hooks or []):
                h(step, state, step_metrics)
    return state, history
