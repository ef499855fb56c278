"""The port's log quantizer (`repro_torch.core.logquant`) and CNN weight
packing (`repro_torch.serving.quantize`) against the JAX package.

Packed int8 codes must equal JAX's byte for byte.  The one allowed
exception: `log2` may differ by one ulp between the two libraries
(`repro/core/logquant.py:114`), so a code may differ only where
``2·log2(|x|/scale)`` lies within 1e-5 of a half-step boundary.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import logquant as jlq  # noqa: E402
from repro.serving import quantize as jquant  # noqa: E402
from repro_torch.core import logquant as tlq  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.serving import quantize as tquant  # noqa: E402


def _values(rng, shape):
    """Normal values spread over six decades, with exact zeros."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 3, size=shape)
    x[rng.random(size=shape) < 0.05] = 0.0
    return x.astype(np.float32)


def _assert_codes_match(x, packed_j, packed_t, scale, cfg):
    """Codes equal, except on a half-step boundary (one-ulp log2)."""
    pj, pt = np.asarray(packed_j), np.asarray(packed_t)
    bad = pj != pt
    if bad.any():
        mag = np.abs(x.astype(np.float64)) / np.asarray(scale, np.float64)
        steps = np.log2(mag[bad]) * cfg.steps
        off = np.abs(steps - np.floor(steps) - 0.5)
        assert np.all(off < 1e-5), (pj[bad], pt[bad], off)


@pytest.mark.parametrize("per_channel,shape", [
    (True, (3, 3, 8, 16)), (True, (64, 32)), (False, (5, 7, 9)),
])
def test_log_quantize_codes_match_jax(per_channel, shape):
    cfg_j = jlq.LogQuantConfig(per_channel=per_channel)
    cfg_t = tlq.LogQuantConfig(per_channel=per_channel)
    x = _values(np.random.default_rng(0), shape)
    pj, sj = jlq.log_quantize(jnp.asarray(x), cfg_j)
    pt, st = tlq.log_quantize(torch.from_numpy(x), cfg_t)
    assert pt.dtype == torch.int8 and tuple(pt.shape) == shape
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    _assert_codes_match(x, pj, pt.numpy(), np.asarray(sj), cfg_t)
    # unpack agrees field by field
    for a, b in zip(jlq.unpack(pj, cfg_j), tlq.unpack(pt, cfg_t)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_log_dequantize_and_fake_quant_match_jax():
    x = _values(np.random.default_rng(1), (6, 10))
    pj, sj = jlq.log_quantize(jnp.asarray(x))
    pt, st = tlq.log_quantize(torch.from_numpy(x))
    dj = np.asarray(jlq.log_dequantize(pj, sj, dtype=jnp.float32))
    dt = tlq.log_dequantize(pt, st).numpy()
    # XLA's CPU exp2 is up to ~1.01e-6 relative off at large negative
    # exponents; the port's decode is exact
    np.testing.assert_allclose(dt, dj, rtol=2e-6, atol=0)
    fj = np.asarray(jlq.fake_log_quant(jnp.asarray(x)))
    ft = tlq.fake_log_quant(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ft, fj, rtol=2e-6, atol=0)


def test_fake_log_quant_straight_through_gradient():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_values(rng, (4, 8))).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    (tlq.fake_log_quant(x) * g).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), g.numpy())


def test_linear_quantize_and_snr_match_jax():
    x = np.random.default_rng(3).normal(size=(100,)).astype(np.float32) * 4
    lj = np.asarray(jlq.linear_quantize(jnp.asarray(x), 4, 3))
    lt = tlq.linear_quantize(torch.from_numpy(x), 4, 3).numpy()
    np.testing.assert_array_equal(lt, lj)
    assert tlq.quantization_snr_db(x, lt) == jlq.quantization_snr_db(x, lj)


def test_quantized_tensor_round_trip():
    x = torch.from_numpy(_values(np.random.default_rng(4), (3, 3, 4, 8)))
    qt = tlq.quantize_tensor(x)
    assert qt.shape == (3, 3, 4, 8) and qt.layout is None
    np.testing.assert_array_equal(
        tlq.dequantize_tensor(qt, torch.float32).numpy(),
        tlq.log_dequantize(qt.packed, qt.scale).numpy())
    assert "QuantizedTensor(shape=(3, 3, 4, 8)" in repr(qt)


def _walk_pairs(a, b):
    """Yield (jax leaf, torch leaf) pairs of two same-structured trees."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            yield from _walk_pairs(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            yield from _walk_pairs(u, v)
    else:
        yield a, b


def _cnn_tree(rng):
    """A small tree shaped like the zoo's: a dense stem, a depthwise +
    pointwise pair, a ResNet-style ``(block, stride)`` tuple, a dense head."""
    def conv(k, cin_g, cout):
        return {"w": rng.normal(size=(k, k, cin_g, cout)).astype(np.float32),
                "b": rng.normal(size=(cout,)).astype(np.float32)}
    return {"stem": conv(3, 3, 8),
            "pairs": [{"dw": conv(3, 1, 8), "pw": conv(1, 8, 16)}],
            "stages": [[({"c1": conv(3, 16, 16)}, 2)]],
            "head": {"w": rng.normal(size=(16, 10)).astype(np.float32)}}


@pytest.mark.parametrize("conv_layout", [None, "conv_taps", "lane_packed"])
def test_quantize_cnn_params_bytes_match_jax(conv_layout):
    """Every packed leaf (dense, 1x1 and depthwise kernels) equals the JAX
    package's: codes byte for byte, scales, shape, layout and layout
    metadata; the other leaves (and the stride ints) pass through."""
    tree = _cnn_tree(np.random.default_rng(5))
    qj = jquant.quantize_cnn_params(
        jax.tree.map(lambda v: jnp.asarray(v) if isinstance(v, np.ndarray)
                     else v, tree), conv_layout=conv_layout)
    qt = tquant.quantize_cnn_params(tcnn.params_from_numpy(tree, "cpu"),
                                    conv_layout=conv_layout)
    layouts = set()
    n_packed = 0
    for a, b in _walk_pairs(qj, qt):
        if isinstance(a, jlq.QuantizedTensor):
            assert isinstance(b, tlq.QuantizedTensor)
            assert (b.shape, b.layout, b.layout_meta) == (
                tuple(a.shape), a.layout,
                None if a.layout_meta is None else tuple(a.layout_meta))
            np.testing.assert_array_equal(b.packed.numpy(),
                                          np.asarray(a.packed))
            np.testing.assert_array_equal(b.scale.numpy(),
                                          np.asarray(a.scale))
            np.testing.assert_allclose(
                b.dequantize(torch.float32).numpy(),
                np.asarray(a.dequantize(jnp.float32)), rtol=2e-6, atol=0)
            layouts.add(b.layout)
            n_packed += 1
        elif isinstance(a, int):
            assert type(b) is int and b == a
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert n_packed == 4
    want = {None: {None}, "conv_taps": {"conv_taps"},
            "lane_packed": {"conv_taps", "lane_packed"}}[conv_layout]
    assert layouts == want
    assert tquant.quantized_fraction(qt) == pytest.approx(
        jquant.quantized_fraction(qj), rel=1e-12)


def test_quantize_cnn_params_rejects_unknown_layout():
    with pytest.raises(ValueError, match="conv_layout"):
        tquant.quantize_cnn_params({}, conv_layout="nchw")
