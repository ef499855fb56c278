"""The port's explicit-im2col conv route (``impl="cuda_im2col"``:
`repro_torch.kernels.log_conv2d.log_conv2d_im2col` onto `log_matmul_cuda`)
against the JAX package's ``impl="pallas_im2col"`` (`log_conv2d_pallas`
onto `log_matmul_pallas`), which runs here in interpret mode, as
`tests/test_conv2d.py:55` runs it.

On a CPU tensor the route's product is the plain `ref_log_matmul`, so these
tests hold the route's patches, block-diagonal codes and layouts against
JAX's; the kernel itself is held against the plain version on the card
(`chip_smoke.py` phase 25, and the test marked ``cuda`` in
`tests/test_torch_log_matmul.py`).  Also: the route's traffic model against
JAX's formula, and the rows of each launch of the kernel at an im2col
conv's M.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.neuromax_cnn import CONFIG  # noqa: E402
from repro.core.logquant import quantize_tensor as jquantize  # noqa: E402
from repro.kernels import log_conv2d as jlc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core.logquant import QuantizedTensor  # noqa: E402
from repro_torch.core.logquant import quantize_tensor as tquantize  # noqa: E402
from repro_torch.benchmarks.conv_kernels import _layer_cases  # noqa: E402
from repro_torch.kernels import log_conv2d as tlc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.log_matmul import (  # noqa: E402
    _GRID_YZ_MAX, log_matmul_geometry, log_matmul_row_chunks)
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.serving.quantize import quantize_cnn_params  # noqa: E402

RED = CONFIG.reduced()
# per output element: |port - JAX| ≤ REL · Σ|x|·|dec(w)|·scale, the 2e-6
# relative the tests allow against JAX's decode (XLA's CPU `exp2` is up to
# 1.01e-6 off the exact 2^(code/2)); the two sum in other orders
REL = 2e-6

SHAPES = [  # B, H, W, C, K, P, stride, padding, groups (test_conv2d.py:32)
    (2, 8, 8, 5, 3, 7, 1, "SAME", 1),
    (1, 9, 7, 4, 3, 6, 2, "SAME", 1),     # strided
    (2, 8, 8, 6, 3, 6, 1, "VALID", 6),    # depthwise
    (1, 10, 10, 4, 1, 8, 1, "VALID", 1),  # 1x1
    (1, 8, 8, 6, 3, 4, 2, "SAME", 2),     # grouped, stride 2
    (1, 8, 8, 3, 5, 4, 2, 2, 1),          # K=5, int padding
    (1, 8, 8, 3, 3, 5, 1, ((1, 2), (0, 1)), 1),  # explicit pairs
    (1, 9, 7, 12, 3, 8, 2, "SAME", 4),    # cin_g=3 (test_conv2d.py:89)
    (1, 8, 8, 6, 3, 12, 1, "SAME", 6),    # depthwise, multiplier 2
]


def _inputs(seed, B, H, W, C, K, P, groups):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = rng.normal(size=(K, K, C // groups, P)).astype(np.float32)
    return x, w


def _layouts(qt, groups):
    """The packed codes in each layout `quantize_cnn_params` can bake."""
    K, _, cin_g, P = qt.shape
    out = {"natural": qt,
           "conv_taps": QuantizedTensor(qt.packed.reshape(K * K, cin_g, P),
                                        qt.scale, qt.cfg, qt.shape,
                                        layout="conv_taps")}
    lp = tlc.lane_pack_geometry(groups, cin_g)
    if lp["g_b"] > 1:
        codes = tlc.lane_pack_codes(qt.packed, groups, lp["g_b"],
                                    lp["cin_lane"])
        out["lane_packed"] = QuantizedTensor(
            codes, qt.scale.reshape(-1), qt.cfg, qt.shape,
            layout="lane_packed",
            layout_meta=(lp["g_b"], lp["cin_lane"], groups))
    return out


@pytest.mark.parametrize("B,H,W,C,K,P,stride,padding,groups", SHAPES)
def test_im2col_route_matches_jax_pallas_im2col(B, H, W, C, K, P, stride,
                                                padding, groups):
    x, w = _inputs(0, B, H, W, C, K, P, groups)
    kw = dict(stride=stride, padding=padding, groups=groups)
    qj = jquantize(jnp.asarray(w))
    qt = tquantize(torch.from_numpy(w))
    np.testing.assert_array_equal(qt.packed.numpy(), np.asarray(qj.packed))
    yj = np.asarray(jops.conv2d(jnp.asarray(x), qj, impl="pallas_im2col",
                                interpret=True, **kw))
    pads = tlc.normalize_padding(padding, K, stride, H, W)
    w_abs = (tlc.decode_codes(qt.packed) * qt.scale.reshape(-1)).abs()
    bound = REL * tlc.conv_nhwc(torch.from_numpy(np.abs(x)), w_abs,
                                stride=stride, pads=pads,
                                groups=groups).numpy()
    xt = torch.from_numpy(x)
    layouts = _layouts(qt, groups)
    assert ("lane_packed" in layouts) == (groups > 1)
    for name, q in layouts.items():
        y = tops.conv2d(xt, q, impl="cuda_im2col", **kw)
        assert y.dtype == torch.float32 and tuple(y.shape) == yj.shape, name
        err = np.abs(y.numpy() - yj)
        assert (err <= bound).all(), (name, float((err - bound).max()))


def test_im2col_route_keeps_bf16_patches_and_out_dtype():
    """Patches stay in x's dtype and the output is in ``out_dtype``, as in
    JAX; the route's result equals `log_conv2d_ref` on the same input."""
    x, w = _inputs(3, 1, 8, 8, 4, 3, 6, 1)
    qt = tquantize(torch.from_numpy(w))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = tops.conv2d(xb, qt, impl="cuda_im2col")
    assert y.dtype == torch.bfloat16
    y32 = tlc.log_conv2d_im2col(xb, qt.packed, qt.scale,
                                out_dtype=torch.float32)
    assert y32.dtype == torch.float32
    want = tlc.log_conv2d_ref(xb.float(), qt.packed, qt.scale)
    torch.testing.assert_close(y32, want, rtol=0, atol=0)
    assert tops.conv2d(torch.from_numpy(x), qt, impl="cuda_im2col",
                       out_dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(tcnn.CNN_ZOO))
def test_nets_match_jax_pallas_im2col(name, monkeypatch):
    """The four nets at `CNNConfig().reduced()` size, logq6, on bridged
    weights packed as the chip run packs them (``lane_packed`` depthwise,
    ``conv_taps`` elsewhere), with ``conv_impl="cuda_im2col"``, against
    JAX's nets with ``conv_impl="pallas_im2col"`` in interpret mode
    (jitted: about 20 s a net here).  Tolerance `test_cnn.py:106`'s."""
    params, apply_j = jcnn.make_cnn(name, jax.random.PRNGKey(6),
                                    n_classes=RED.n_classes,
                                    width_mult=RED.width_mult, quant="logq6",
                                    conv_impl="pallas_im2col",
                                    interpret=True)
    x = np.random.default_rng(7).normal(
        size=(2, RED.img, RED.img, 3)).astype(np.float32)
    lj = np.asarray(jax.jit(lambda xx: apply_j(params, xx))(jnp.asarray(x)))
    tparams = tcnn.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    packed = quantize_cnn_params(tparams, conv_layout="lane_packed")
    apply_t = functools.partial(tcnn.CNN_ZOO[name][1], quant="logq6",
                                conv_impl="cuda_im2col")
    calls = []
    conv = tops.conv2d

    def spy(*a, **k):
        calls.append(k["impl"])
        return conv(*a, **k)
    monkeypatch.setattr(tops, "conv2d", spy)
    with torch.no_grad():
        lt = apply_t(packed, torch.from_numpy(x))
    assert calls == ["cuda_im2col"] * {"vgg16": 13, "mobilenet_v1": 27,
                                       "resnet34": 36, "squeezenet": 26}[name]
    np.testing.assert_allclose(lt.numpy(), lj,
                               atol=1e-3 * (np.abs(lj).max() + 1))


@pytest.mark.parametrize("img", [224, 32])
def test_pallas_im2col_bytes_equal_jax(img):
    """JAX's ``pallas_im2col`` formula, on the conv bench's layers at batch
    4, gives the same bytes in both packages."""
    for _, spec, groups in _layer_cases(img):
        kw = dict(stride=spec.stride, padding=spec.pad, groups=groups)
        shape = (4, spec.H, spec.W, spec.C, spec.K, spec.P)
        want = jlc.conv_traffic_bytes("pallas_im2col", *shape, **kw)
        got = tlc.conv_traffic_bytes("pallas_im2col", *shape, **kw)
        assert got == want, spec.name


def test_cuda_im2col_bytes_count_the_routes_reads():
    """``cuda_im2col``: K² tap reads of x and the patches' write, the
    kernel's reads of the patches once per 128-column tile and of the
    block-diagonal codes once per 8-row tile, the scale and y once; at a
    small M the kernel's split-K partials and tickets besides."""
    C, K, Cout, groups = 8, 3, 160, 4
    for B, H, stride in ((4, 32, 1), (2, 9, 2)):
        got = tlc.conv_traffic_bytes("cuda_im2col", B, H, H, C, K, Cout,
                                     stride=stride, groups=groups)
        M = B * (-(-H // stride)) ** 2
        g = log_matmul_geometry(M, K * K * C, Cout)
        assert (g["m_tiles"], g["n_tiles"]) == (-(-M // 8), 2)
        assert got["act"] == M * K * K * C * 4 * (2 + 2)
        assert got["w"] == K * K * C * Cout * g["m_tiles"] + 4 * Cout
        part = 0 if g["splits"] == 1 else (
            2 * g["splits"] * M * Cout * 4
            + g["m_tiles"] * 2 * (8 * g["splits"] + 4))
        assert (g["splits"] == 1) == (B == 4)
        assert got["partials"] == part
        assert got["out"] == M * Cout * 4 + part


@pytest.mark.parametrize("M,chunks", [
    (1, 1), (4, 1), (5, 1), (401_408, 1),        # VGG-16 at batch 8
    (_GRID_YZ_MAX * 8, 1), (_GRID_YZ_MAX * 8 + 1, 2),
    (551_936, 2),                                 # VGG-16 at batch 11
    (3 * _GRID_YZ_MAX * 8 + 5, 4)])
def test_row_chunks_cover_m_in_launchable_tiles(M, chunks):
    """The rows of each launch: as few launches as the grid allows, whole
    row tiles of near-equal size covering ``[0, M)`` in order, each within
    the grid's 65,535 row tiles and with one share of K at conv sizes."""
    K, N = 576, 64
    got = log_matmul_row_chunks(M, K, N)
    assert len(got) == chunks
    assert got[0][0] == 0 and got[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    bm = log_matmul_geometry(M, K, N)["bm"]
    sizes = [r1 - r0 for r0, r1 in got]
    assert all(s % bm == 0 for s in sizes[:-1])
    assert max(sizes) - min(sizes) <= bm * (len(sizes) + 1)
    for r0, r1 in got:
        g = log_matmul_geometry(r1 - r0, K, N)
        assert g["bm"] == bm and g["m_tiles"] <= _GRID_YZ_MAX
        if r1 - r0 > 10_000:
            assert g["splits"] == 1


def test_jax_im2col_name_is_unknown_to_the_port():
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="unknown conv2d impl"):
        tops.conv2d(x, torch.zeros(3, 3, 2, 2), impl="pallas_im2col")
    assert tops.resolve_impl("conv2d", "cuda_im2col",
                             torch.device("cuda")) == "cuda_im2col"
    assert tops.resolve_impl("conv2d", "auto", torch.device("cuda")) == "cuda"
