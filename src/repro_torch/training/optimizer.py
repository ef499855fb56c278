"""Optimizers on torch tensors: AdamW, SGD(+momentum), LR schedules,
clipping.

Counterpart of `repro.training.optimizer`: the same (init, update) pairs
over parameter trees, with state trees keyed as JAX's (``{"mu", "nu",
"count"}`` and ``{"mom", "count"}``, moments fp32, ``count`` a 0-d int32
tensor) and the same fp32 arithmetic in the same order.  Where JAX returns
new trees into donated buffers, ``update`` writes the new parameters and
moments into the given tensors in place and returns them: at gemma-2b's
2.51 G parameters a second copy of params and moments would not fit beside
the first.  Every value, the learning rate included, stays on the
parameters' device: a step reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"               # adamw | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | constant
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    grad_clip: float = 1.0


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts of tensors) and the
    same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# -------------------------------------------------------------- schedules
def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a 0-d fp32
    tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
            * 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.ones_like(step)
    return cfg.lr * warm * decay


# -------------------------------------------------------------- clipping
def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """→ (grads scaled by min(1, max_norm / norm), norm); new tensors."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


# -------------------------------------------------------------- AdamW
def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _count0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw_init(params):
    return {"mu": tree_map(_zeros_f32, params),
            "nu": tree_map(_zeros_f32, params), "count": _count0(params)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state, params):
    count = state["count"] + 1
    lr = lr_at(cfg, count - 1)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - b1 ** count.to(torch.float32)
    c2 = 1 - b2 ** count.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        step = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.eps))
        p32 = p.to(torch.float32)
        step.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * step)

    tree_map(upd, params, grads, state["mu"], state["nu"])
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}


# -------------------------------------------------------------- SGD
def sgd_init(params):
    return {"mom": tree_map(_zeros_f32, params), "count": _count0(params)}


@torch.no_grad()
def sgd_update(cfg: OptimizerConfig, grads, state, params):
    count = state["count"] + 1
    lr = lr_at(cfg, count - 1)

    def upd(p, g, m):
        m.mul_(cfg.momentum).add_(g.to(torch.float32))
        p32 = p.to(torch.float32)
        p.copy_(p32 - lr * (m + cfg.weight_decay * p32))

    tree_map(upd, params, grads, state["mom"])
    return params, {"mom": state["mom"], "count": count}


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return adamw_init, lambda g, s, p: adamw_update(cfg, g, s, p)
    if cfg.name == "sgd":
        return sgd_init, lambda g, s, p: sgd_update(cfg, g, s, p)
    raise ValueError(cfg.name)
