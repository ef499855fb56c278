"""Step builders shared by train/serve: the step programs plus their
(abstract inputs, shardings) for a given (arch, shape, mesh).

Counterpart of `repro.launch.steps`, with its names and arguments.  The
abstract inputs are tensors on the ``meta`` device
(`configs.base.input_specs`, `transformer.abstract_params`,
`transformer.abstract_cache`), so the builders allocate nothing; the
shardings are trees of `models.sharding.NamedSharding`, and
`models.sharding.place` lays real tensors out by them.  ``fn`` runs
eagerly on the placed tensors (or on plain ones) inside
`sharding.sharded_region`; there is no ``jit``/``donate``: the train step
updates the state's tensors in place, as `training.train_loop` does.
`launch/dryrun.py` and `launch/perf.py` trace these steps on ``meta``
shards over the production meshes.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.models import sharding, transformer
from repro_torch.models.sharding import NamedSharding
from repro_torch.training.optimizer import OptimizerConfig, tree_map
from repro_torch.training.train_loop import TrainConfig, make_train_step


def _ns(mesh, spec):
    return NamedSharding(mesh, tuple(spec))


def batch_shardings(mesh, specs: dict):
    """tokens/labels/mask [B, T] → batch over (pod, data); embeds likewise;
    M-RoPE positions [3, B, T] → batch on axis 1.  Non-divisible dims
    (e.g. long_500k batch 1) fall back to replication."""
    rules = sharding.logical_to_spec
    out = {}
    for name, s in specs.items():
        if name == "positions":
            spec = (None, *rules(("batch",)))
        elif s.ndim == 3:
            spec = (*rules(("batch",)), None, None)
        else:
            spec = (*rules(("batch",)), None)
        out[name] = _ns(mesh, sharding.sanitize_spec(mesh, spec, s.shape))
    return out


def opt_state_shardings(mesh, params_abs, params_sh,
                        opt: OptimizerConfig = OptimizerConfig()):
    """The moments (AdamW's mu/nu, SGD's mom) mirror the param shardings;
    counters replicate."""
    moments = ("mu", "nu") if opt.name == "adamw" else ("mom",)
    return {**{m: params_sh for m in moments}, "count": _ns(mesh, ())}


def state_shardings(mesh, params, opt: OptimizerConfig = OptimizerConfig(),
                    grad_compress: bool = False):
    """The shardings of a train state over ``params`` (real or abstract):
    params and moments by `sharding.param_shardings`, counters replicated,
    the compressor's errors as their params (a 0-d error replicated)."""
    params_sh = sharding.param_shardings(mesh, params)
    state_sh = {"params": params_sh,
                "opt": opt_state_shardings(mesh, params, params_sh, opt),
                "step": _ns(mesh, ())}
    if grad_compress:
        state_sh["compress"] = {"error": sharding.tree_map2(
            lambda p, s: s if p.numel() >= 1024 else _ns(mesh, ()),
            params, params_sh)}
    return state_sh


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------


def build_train_step(cfg, shape_name: str, mesh, *,
                     microbatches: int = 1, grad_compress: bool = False,
                     xent_chunk: int = 512,
                     opt: OptimizerConfig = OptimizerConfig()):
    """Returns (fn, abstract_args, in_shardings).

    fn(state, batch) -> (state, metrics); state = {params, opt, step} (+
    ``compress`` with ``grad_compress``), updated in place.  ``opt`` picks
    the optimizer (JAX's builder always takes its default AdamW)."""
    sharding.set_mesh(mesh)
    step_kind, specs = input_specs(cfg, shape_name)
    assert step_kind == "train", shape_name

    tcfg = TrainConfig(opt=opt, microbatches=microbatches,
                       grad_compress=grad_compress, xent_chunk=xent_chunk)
    loss_fn = lambda p, b: transformer.lm_loss(p, b, cfg,  # noqa: E731
                                               xent_chunk=xent_chunk)
    fn = make_train_step(loss_fn, tcfg)

    params_abs = transformer.abstract_params(cfg)
    if cfg.param_dtype != torch.float32:  # §Perf params_bf16 variant
        params_abs = tree_map(
            lambda p: _meta(p.shape, cfg.param_dtype)
            if p.is_floating_point() else p, params_abs)
    f32 = lambda p: _meta(p.shape, torch.float32)  # noqa: E731
    moments = ("mu", "nu") if opt.name == "adamw" else ("mom",)
    opt_abs = {**{m: tree_map(f32, params_abs) for m in moments},
               "count": _meta((), torch.int32)}
    state_abs = {"params": params_abs, "opt": opt_abs,
                 "step": _meta((), torch.int32)}
    if grad_compress:
        state_abs["compress"] = {"error": tree_map(
            lambda p: _meta(p.shape if p.numel() >= 1024 else (),
                            torch.float32), params_abs)}

    state_sh = state_shardings(mesh, params_abs, opt, grad_compress)
    batch_abs = specs
    batch_sh = batch_shardings(mesh, specs)
    return fn, (state_abs, batch_abs), (state_sh, batch_sh)


def _serving_params_abs(cfg):
    """Abstract params for serving steps: packed 6-bit codes when the
    config carries the paper's quant (decode is weight-HBM-bound; the
    packed form is the technique's serving win)."""
    params_abs = transformer.abstract_params(cfg)
    if cfg.quant == "logq6":
        from repro_torch.serving.quantize import quantize_params
        return quantize_params(params_abs)
    return params_abs


def _cache_shardings(cfg, mesh, B, S, cache_dtype):
    cache_abs = transformer.abstract_cache(cfg, B, S, cache_dtype)
    dp = sharding.mesh_shape(mesh).get("data", 1) \
        * sharding.mesh_shape(mesh).get("pod", 1)
    cache_sh = sharding.tree_map2(
        lambda spec, leaf: _ns(mesh, sharding.sanitize_spec(
            mesh, spec, getattr(leaf, "shape", ()))),
        sharding.cache_specs(cache_abs, B, dp), cache_abs)
    return cache_abs, cache_sh


def _device(table):
    """The device of the params' storage: a DTensor's local shard's (the
    ``meta`` device in the dry run), not its mesh's device type."""
    return (table.to_local() if sharding.is_sharded(table) else table).device


def build_prefill_step(cfg, shape_name: str, mesh, *,
                       cache_dtype=torch.bfloat16):
    """fn(params, inputs_dict) -> (last_hidden, cache).  The cache is made
    inside the step, as in JAX.  When the params are DTensors it is laid
    out by the decode step's cache shardings, and each rank makes only its
    own shard of each leaf (`sharding.zeros`)."""
    sharding.set_mesh(mesh)
    step_kind, specs = input_specs(cfg, shape_name)
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    # the cache's layout by batch, made outside the step: its abstract
    # leaves are meta tensors at the global shapes
    layouts = {}

    def layout(b):
        if b not in layouts:
            cache_abs, cache_sh = _cache_shardings(cfg, mesh, b, S,
                                                   cache_dtype)
            layouts[b] = ({**cache_abs, "index": 0}, cache_sh)
        return layouts[b]
    if mesh is not None:
        layout(B)

    def step(params, batch):
        inputs = batch["tokens"] if cfg.embed_inputs else batch["embeds"]
        Bi = inputs.shape[0]
        table = params["embed"]["table"]
        if sharding.is_sharded(table):
            cache = sharding.zeros(*layout(Bi), _device(table))
        else:
            cache = transformer.init_cache(cfg, Bi, S, cache_dtype,
                                           device=_device(table))
        with sharding.sharded_region():
            return transformer.prefill(params, inputs, cfg, cache,
                                       positions=batch.get("positions"))

    params_abs = _serving_params_abs(cfg)
    params_sh = sharding.param_shardings(mesh, params_abs)
    batch_sh = batch_shardings(mesh, specs)
    return step, (params_abs, specs), (params_sh, batch_sh)


def build_decode_step(cfg, shape_name: str, mesh, *,
                      cache_dtype=torch.bfloat16):
    """fn(params, cache, batch) -> (logits, cache').  One new token against
    a seq_len-deep cache — the assigned decode_*/long_* cells."""
    sharding.set_mesh(mesh)
    step_kind, specs = input_specs(cfg, shape_name)
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]

    def step(params, cache, batch):
        inputs = batch["tokens"] if cfg.embed_inputs else batch["embeds"]
        if sharding.is_sharded(cache["index"]):  # a replicated scalar
            cache = {**cache, "index": cache["index"].to_local()}
        with sharding.sharded_region():
            return transformer.decode_step(params, inputs, cfg, cache,
                                           positions=batch.get("positions"))

    params_abs = _serving_params_abs(cfg)
    cache_abs, cache_sh = _cache_shardings(cfg, mesh, B, S, cache_dtype)
    params_sh = sharding.param_shardings(mesh, params_abs)
    batch_sh = batch_shardings(mesh, specs)
    return step, (params_abs, cache_abs, specs), \
        (params_sh, cache_sh, batch_sh)


def build_step(cfg, shape_name: str, mesh, **kw):
    kind = SHAPES[shape_name]["step"]
    if kind == "train":
        return "train", build_train_step(cfg, shape_name, mesh, **kw)
    if kind == "prefill":
        return "prefill", build_prefill_step(cfg, shape_name, mesh)
    return "decode", build_decode_step(cfg, shape_name, mesh)
