"""The port's CNNs (`repro_torch.models.cnn`) against the JAX package's, on
the same weights (a JAX parameter tree bridged with `params_from_numpy`).

The nets run at `CNNConfig().reduced()` sizes on the CPU; the port's
``conv_impl="cuda"`` goes through the kernel's wrapper, which runs its plain
version for a CPU tensor.  Tolerances are `test_cnn.py:106`'s.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.neuromax_cnn import CONFIG  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.serving.quantize import (quantize_cnn_params,  # noqa: E402
                                          quantized_fraction)

RED = CONFIG.reduced()
CONVS_PER_NET = {"vgg16": 13, "mobilenet_v1": 27, "resnet34": 36,
                 "squeezenet": 26}


def _bridge(params):
    return tcnn.params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")


def _jit_logits(apply, params, x):
    """JAX logits, jitted (eager JAX takes tens of seconds here); the
    params are closed over so ResNet's int strides stay static."""
    return np.asarray(jax.jit(lambda xx: apply(params, xx))(jnp.asarray(x)))


def _images(seed, b, img):
    return np.random.default_rng(seed).normal(
        size=(b, img, img, 3)).astype(np.float32)


@pytest.mark.parametrize("quant", ["logq6", None])
@pytest.mark.parametrize("name", sorted(tcnn.CNNS))
def test_logits_match_jax_blockwise(name, quant):
    """All four nets, on bridged weights, against JAX ``conv_impl=
    "blockwise"``: the port's blockwise, its kernel route (plain on the
    CPU) on natural codes, and on codes packed at load the way the chip
    run packs them (``lane_packed`` depthwise, ``conv_taps`` elsewhere)."""
    params, apply_j = jcnn.make_cnn(name, jax.random.PRNGKey(6),
                                    n_classes=RED.n_classes,
                                    width_mult=RED.width_mult, quant=quant,
                                    conv_impl="blockwise")
    x = _images(7, 2, RED.img)
    lj = _jit_logits(apply_j, params, x)
    tparams = _bridge(params)
    packed = quantize_cnn_params(tparams, conv_layout="lane_packed")
    apply_t = functools.partial(tcnn.CNNS[name][1], quant=quant)
    xt = torch.from_numpy(x)
    tol = 1e-3 * (np.abs(lj).max() + 1)
    with torch.no_grad():
        outs = {"blockwise": apply_t(tparams, xt, conv_impl="blockwise"),
                "cuda": apply_t(tparams, xt, conv_impl="cuda"),
                "cuda, packed at load": apply_t(packed, xt,
                                                conv_impl="cuda")}
    for route, lt in outs.items():
        assert lt.shape == (2, RED.n_classes), route
        np.testing.assert_allclose(lt.numpy(), lj, atol=tol, err_msg=route)


@pytest.mark.parametrize("quant", ["logq6", None])
@pytest.mark.parametrize("name", ["mobilenet_v1", "resnet34"])
def test_float_conv_path_matches_jax(name, quant):
    """``conv_impl=None``: the fake-quant float conv of the QAT path."""
    params, apply_j = jcnn.make_cnn(name, jax.random.PRNGKey(2),
                                    n_classes=RED.n_classes,
                                    width_mult=RED.width_mult, quant=quant)
    x = _images(3, 2, RED.img)
    lj = _jit_logits(apply_j, params, x)
    with torch.no_grad():
        lt = tcnn.CNNS[name][1](_bridge(params), torch.from_numpy(x),
                                quant=quant)
    np.testing.assert_allclose(lt.numpy(), lj,
                               atol=1e-3 * (np.abs(lj).max() + 1))


def test_vgg16_matches_jax_fused_pallas_interpret():
    """As `test_cnn.py:94-106`: VGG-16 at 16 px through JAX's fused Pallas
    kernel in interpret mode, against the port's kernel route."""
    params, apply_fz = jcnn.make_cnn("vgg16", jax.random.PRNGKey(12),
                                     n_classes=10, width_mult=0.25,
                                     quant="logq6", conv_impl="pallas",
                                     interpret=True)
    x = _images(13, 1, 16)
    lz = _jit_logits(apply_fz, params, x)
    packed = quantize_cnn_params(_bridge(params), conv_layout="lane_packed")
    with torch.no_grad():
        lt = tcnn.vgg16_apply(packed, torch.from_numpy(x), quant="logq6",
                              conv_impl="cuda")
    np.testing.assert_allclose(lt.numpy(), lz,
                               atol=1e-3 * (np.abs(lz).max() + 1))


@pytest.fixture(scope="module")
def jax_traces():
    return {name: jcnn.trace_conv_shapes(name) for name in jcnn.CNNS}


@pytest.mark.parametrize("name", sorted(tcnn.CNNS))
def test_trace_conv_shapes_match_jax(name, jax_traces):
    recs = tcnn.trace_conv_shapes(name)
    assert len(recs) == CONVS_PER_NET[name]
    assert recs == jax_traces[name]


def test_zoo_conv_shapes_match_jax(jax_traces, monkeypatch):
    zoo = tcnn.zoo_conv_shapes()
    assert len(zoo) == 61
    monkeypatch.setattr(jcnn, "trace_conv_shapes",
                        lambda name, **kw: jax_traces[name])
    assert zoo == jcnn.zoo_conv_shapes()


def test_params_from_numpy_keeps_structure_and_strides():
    params, _ = jcnn.make_cnn("resnet34", jax.random.PRNGKey(0),
                              n_classes=4, width_mult=0.125)
    tparams = _bridge(params)  # np.asarray turns each stride into a 0-d array
    stage = tparams["stages"][1]
    assert isinstance(stage, list) and isinstance(stage[0], tuple)
    strides = [st for s in tparams["stages"] for _, st in s]
    assert strides == [st for s in params["stages"] for _, st in s]
    assert all(type(st) is int for st in strides)
    w = tparams["stem"]["w"]
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    np.testing.assert_array_equal(w.numpy(), np.asarray(params["stem"]["w"]))


def test_packed_at_load_matches_on_the_fly():
    params, apply = tcnn.make_cnn("mobilenet_v1", 8, n_classes=10,
                                  width_mult=0.25, quant="logq6",
                                  conv_impl="blockwise", device="cpu")
    x = torch.from_numpy(_images(9, 2, 32))
    with torch.no_grad():
        for layout in (None, "conv_taps", "lane_packed"):
            q = quantize_cnn_params(params, conv_layout=layout)
            assert quantized_fraction(q) > 0.5
            assert torch.equal(apply(q, x), apply(params, x))


def test_cnn_loss_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4, 0])
    lj, aj = jcnn.cnn_loss(lambda p, x: x, None,
                           {"images": jnp.asarray(logits),
                            "labels": jnp.asarray(labels)})
    lt, at = tcnn.cnn_loss(lambda p, x: x, None,
                           {"images": torch.from_numpy(logits),
                            "labels": torch.from_numpy(labels)})
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    assert float(at["acc"]) == pytest.approx(float(aj["acc"]))


def test_qat_train_step_reduces_loss():
    """Straight-through fake-quant trains: a few SGD steps on SqueezeNet."""
    params, apply = tcnn.make_cnn("squeezenet", 4, n_classes=4,
                                  width_mult=0.25, quant="logq6",
                                  device="cpu")
    leaves = [t for blk in [params["stem"], params["final"],
                            *(c for f in params["fires"] for c in f.values())]
              for t in blk.values()]
    for t in leaves:
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(5)
    batch = {"images": torch.randn((8, 32, 32, 3), generator=g),
             "labels": torch.arange(8) % 4}
    losses = []
    for _ in range(6):
        loss, _ = tcnn.cnn_loss(apply, params, batch)
        losses.append(float(loss.detach()))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, gr in zip(leaves, grads):
                t -= 0.05 * gr
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
