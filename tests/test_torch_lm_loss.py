"""The port's training loss (`repro_torch.models.transformer.lm_loss`, its
`chunked_xent` and the embedding-input forward) and its autograd gradients
against `jax.value_and_grad` of the JAX package's `lm_loss`, on the same
weights (a JAX tree bridged with `params_from_numpy`) and the same batch
(numpy, from a seed).

Seven reduced archs, fp32 activations: gemma-2b, gemma3-1b (local and
global layers; one rep of its 6-layer pattern), recurrentgemma-2b,
rwkv6-1.6b, granite-moe-1b-a400m (router aux loss included), musicgen-large
and qwen2-vl-2b (embeddings and [3, B, T] M-RoPE positions), each with fp
weights and with ``quant="logq6"`` (straight-through fake-quant).  A
masked batch whose length is not a multiple of the xent chunk.  The
loss agrees within 1e-5 relative and every leaf's gradient within
1e-4·(max|g|+1).  The port runs with ``attn_impl="blockwise"``, the
trainer's setting, which also routes its RWKV layers to the chunked WKV.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ["gemma-2b", "gemma3-1b", "recurrentgemma-2b", "rwkv6-1.6b",
         "granite-moe-1b-a400m", "musicgen-large", "qwen2-vl-2b"]
B, T, CHUNK = 2, 12, 8
REL = 1e-4


def cfgs(arch, **over):
    """The reduced config in both packages (gemma3-1b: one rep of its
    pattern); the port's on the trainer's blockwise dispatch."""
    if arch == "gemma3-1b":
        over.setdefault("n_layers", len(jget(arch).layer_pattern))
    return jget(arch).reduced(**over), dataclasses.replace(
        tget(arch).reduced(**over), attn_impl="blockwise")


def batch(cfg, seed=1, b=B, t=T):
    """A numpy batch for ``cfg``: tokens or embeddings, labels, a mask with
    about a fifth of the positions off, and M-RoPE positions where the
    config has them."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, size=(b, t)).astype(np.int32),
           "mask": (rng.random((b, t)) > 0.2).astype(np.float32)}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab,
                                     size=(b, t)).astype(np.int32)
    else:
        out["embeds"] = rng.normal(size=(b, t, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope_sections is not None:
        out["positions"] = rng.integers(0, 64, size=(3, b, t)).astype(
            np.int32)
    return out


def flat(tree, prefix=""):
    """{"a/b": leaf} over nested dicts, in sorted key order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def port_grads(tp, b, cfg, chunk=CHUNK):
    """(loss, metrics, {path: grad}) of the port's lm_loss."""
    leaves = flat(tp)
    for p in leaves.values():
        p.requires_grad_(True)
    loss, metrics = tt.lm_loss(tp, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, cfg,
                               xent_chunk=chunk)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), metrics, {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(leaves.items(), gs)}


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(cfg, chunk):
    return jax.jit(jax.value_and_grad(
        lambda p, bb: jt.lm_loss(p, bb, cfg, xent_chunk=chunk), has_aux=True))


def jax_grads(jp, b, cfg, chunk=CHUNK):
    (loss, metrics), g = _jax_grad_fn(cfg, chunk)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    return loss, metrics, {k: np.asarray(v) for k, v in flat(g).items()}


@pytest.mark.parametrize("quant", [None, "logq6"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch, quant):
    cj, ct = cfgs(arch, quant=quant)
    jp = jt.init_params(cj, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    b = batch(cj)
    lj, mj, gj = jax_grads(jp, b, cj)
    lt, mt, gt = port_grads(tp, b, ct)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]),
                                   rtol=1e-5, atol=1e-7)
    if cj.is_moe:
        assert float(mj["aux"]) > 0
    assert gt.keys() == gj.keys()
    for k, want in gj.items():
        np.testing.assert_allclose(
            gt[k].numpy(), want, rtol=REL,
            atol=REL * (np.abs(want).max() + 1), err_msg=f"{arch} {k}")
