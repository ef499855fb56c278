"""The port's PE-grid oracle (`repro_torch.core.pe_grid`) against the JAX
package's (`repro.core.pe_grid`) on the same numpy inputs: float and log
modes, 3×3 (strides 1 and 2), depthwise and 1×1, each against both of the
JAX grid's paths (vectorised and per-cycle; the per-cycle loops are the
reference).  GridStats must be equal field by field, the integer psums of a
matrix bit for bit, and y within 1e-6·(max|y|+1) (the float64 sum over
channel groups may run in another order); the grid is also held against the
port's own blockwise conv within `tests/test_conv2d.py`'s `_grid_tol`."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")

from repro.core import pe_grid as jpg  # noqa: E402
from repro_torch.core import pe_grid as tpg  # noqa: E402
from repro_torch.core.logmath import LogPEThread  # noqa: E402
from repro_torch.core.logquant import (LogQuantConfig,  # noqa: E402
                                       log_dequantize, log_quantize,
                                       quantize_tensor)
from repro_torch.kernels.log_conv2d import log_conv2d_blockwise  # noqa: E402

CFG = LogQuantConfig(per_channel=False)
# (mode, whether the JAX reference grid runs vectorised or per cycle)
MODES = [(m, v) for m in ("float", "log") for v in (True, False)]
# H, W, C, P, stride, from tests/test_pe_grid.py and test_conv2d.py; few
# distinct shapes, since the JAX grid compiles its quantizer for each
CONV_SHAPES = [(12, 6, 1, 1, 1), (12, 6, 1, 1, 2), (18, 10, 7, 3, 1),
               (12, 10, 6, 4, 1), (12, 10, 6, 4, 2), (13, 11, 13, 3, 2)]
DW_SHAPES = [(10, 9, 5, 1), (10, 9, 5, 2)]
PW_SHAPES = [(6, 6, 6, 6), (9, 8, 40, 5)]


def _grid(mode, **kw):
    return tpg.PEGrid(mode=mode, device="cpu", **kw)


def _jgrid(mode, vectorized=True):
    """The JAX package's grid: vectorised, or its per-cycle loops (one
    matrix cycle, or one thread, a Python call)."""
    return jpg.PEGrid(mode=mode, vectorized=vectorized)


def _inputs(seed, xshape, wshape, zeros=0.2):
    """|normal| activations (a share of exact zeros, which gate threads) and
    normal weights."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=xshape)).astype(np.float32)
    x[rng.random(xshape) < zeros] = 0.0
    return x, rng.normal(size=wshape).astype(np.float32)


def _same(got, want):
    y, stats = got
    y_j, stats_j = want
    assert y.dtype == torch.float32 and tuple(y.shape) == y_j.shape
    assert dataclasses.asdict(stats) == dataclasses.asdict(stats_j)
    err = float(np.abs(y.numpy() - y_j).max())
    assert err <= 1e-6 * (float(np.abs(y_j).max()) + 1), err


@pytest.mark.parametrize("mode,jax_vectorized", MODES)
@pytest.mark.parametrize("H,W,C,P,stride", CONV_SHAPES)
def test_conv3x3_matches_jax(mode, jax_vectorized, H, W, C, P, stride):
    x, w = _inputs(H * W + C, (H, W, C), (3, 3, C, P))
    _same(_grid(mode).conv2d(x, w, stride=stride),
          _jgrid(mode, jax_vectorized).conv2d(x, w, stride=stride))


@pytest.mark.parametrize("mode,jax_vectorized", MODES)
@pytest.mark.parametrize("H,W,C,stride", DW_SHAPES)
def test_depthwise_matches_jax(mode, jax_vectorized, H, W, C, stride):
    x, w = _inputs(H + W + C, (H, W, C), (3, 3, C))
    _same(_grid(mode).conv2d_depthwise(x, w, stride=stride),
          _jgrid(mode, jax_vectorized).conv2d_depthwise(x, w, stride=stride))


@pytest.mark.parametrize("mode,jax_vectorized", MODES)
@pytest.mark.parametrize("H,W,C,P", PW_SHAPES)
def test_conv1x1_matches_jax(mode, jax_vectorized, H, W, C, P):
    x, w = _inputs(H * C + P, (H, W, C), (C, P))
    _same(_grid(mode).conv2d_1x1(x, w),
          _jgrid(mode, jax_vectorized).conv2d_1x1(x, w))


@pytest.mark.parametrize("kind", ["conv", "depthwise", "1x1"])
def test_chunks_carry_the_shift_register(monkeypatch, kind):
    """With chunks of a few hundred thread products the vectorised path
    walks bands, channel groups, filters and pixels in many steps; the
    boundary psums carried from one band chunk to the next keep y and
    GridStats those of the JAX package."""
    monkeypatch.setattr(tpg, "CHUNK", 700)
    if kind == "conv":
        H, W, C, P, stride = CONV_SHAPES[-1]
        x, w = _inputs(H * W + C, (H, W, C), (3, 3, C, P))
        got = _grid("log").conv2d(x, w, stride=stride)
        want = _jgrid("log").conv2d(x, w, stride=stride)
    elif kind == "depthwise":
        H, W, C, stride = DW_SHAPES[-1]
        x, w = _inputs(H + W + C, (H, W, C), (3, 3, C))
        got = _grid("log").conv2d_depthwise(x, w, stride=stride)
        want = _jgrid("log").conv2d_depthwise(x, w, stride=stride)
    else:
        H, W, C, P = PW_SHAPES[-1]
        x, w = _inputs(H * C + P, (H, W, C), (C, P))
        got = _grid("log").conv2d_1x1(x, w)
        want = _jgrid("log").conv2d_1x1(x, w)
    _same(got, want)


def _codes(t):
    packed, _ = log_quantize(torch.from_numpy(t), CFG)
    from repro_torch.core.logquant import unpack
    code, sign, _ = unpack(packed, CFG)
    return code.to(torch.int64), sign.to(torch.int64)


@pytest.mark.parametrize("frac_bits,out_frac_bits", [(1, 12), (1, 16),
                                                     (2, 16)])
def test_matrix_psums_bit_exact(frac_bits, out_frac_bits):
    """`PEMatrix.cycle_psums_batch` (many matrices at once): integer psums
    equal bit for bit to the JAX package's batch path and, matrix by
    matrix, to its per-scalar `cycle_psums` (one thread call a product)."""
    from repro.core.logmath import LogPEThread as JThread
    x, w = _inputs(7, (9, 6, 3), (9, 3, 3))
    x[0] = 0.0
    xc, _ = _codes(x)
    wc, ws = _codes(w)
    tm = tpg.PEMatrix("log", LogPEThread(frac_bits, out_frac_bits,
                                         device="cpu"))
    jm = jpg.PEMatrix("log", JThread(frac_bits, out_frac_bits))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    batch = tm.cycle_psums_batch(xt, wt, window_codes=xc, w_codes=wc,
                                 w_signs=ws)
    assert batch.dtype == torch.int64 and tuple(batch.shape) == (9, 6, 3)
    np.testing.assert_array_equal(
        batch.numpy(), jm.cycle_psums_batch(x, w, window_codes=xc.numpy(),
                                            w_codes=wc.numpy(),
                                            w_signs=ws.numpy()))
    for i in range(9):
        np.testing.assert_array_equal(
            batch[i].numpy(), jm.cycle_psums(x[i], w[i],
                                             window_codes=xc[i].numpy(),
                                             w_codes=wc[i].numpy(),
                                             w_signs=ws[i].numpy()))
    # leading dims broadcast: one weight block for many windows
    np.testing.assert_array_equal(
        tm.cycle_psums_batch(xt, wt[0], window_codes=xc, w_codes=wc[0],
                             w_signs=ws[0]).numpy(),
        jm.cycle_psums_batch(x, np.broadcast_to(w[0], w.shape),
                             window_codes=xc.numpy(),
                             w_codes=np.broadcast_to(wc[0].numpy(), w.shape),
                             w_signs=np.broadcast_to(ws[0].numpy(),
                                                     w.shape)))
    # float mode: the 18 psums of a matrix in float64 (the JAX grid hands
    # its matrices float64 windows)
    fm = tpg.PEMatrix("float", tm.thread)
    np.testing.assert_allclose(
        fm.cycle_psums_batch(xt, wt).numpy(),
        jpg.PEMatrix("float", jm.thread).cycle_psums_batch(
            x.astype(np.float64), w), rtol=1e-12, atol=1e-12)


def test_paper_fig5_counts():
    """§5.1 (`test_pe_grid.py`): 12×6 input, 3×3 s1 → 8 cycles, 360 MACs,
    83.3 % matrix util, 12 stored psums of 8 × 18."""
    x = np.random.default_rng(0).normal(size=(12, 6, 1)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(3, 3, 1, 1)).astype(np.float32)
    y, stats = _grid("float").conv2d(x, w)
    assert tuple(y.shape) == (10, 4, 1)
    assert stats.cycles == 8
    assert stats.useful_macs == 360
    assert abs(stats.active_utilization - 45 / 54) < 1e-9
    assert stats.stored_psums == 12
    assert stats.psum_storage_fraction <= 3 / 18 + 1e-9


def test_paper_1x1_counts():
    """§5.2 (`test_pe_grid.py`): 6×6×6 input, 6 1×1×6 filters → 12 cycles,
    100 % util."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 6, 6)).astype(np.float32)
    w = rng.normal(size=(6, 6)).astype(np.float32)
    y, stats = _grid("float").conv2d_1x1(x, w)
    np.testing.assert_allclose(y.numpy(),
                               (x.reshape(36, 6) @ w).reshape(6, 6, 6),
                               rtol=1e-4)
    assert stats.cycles == 12
    assert stats.useful_macs == 1296
    assert abs(stats.active_utilization - 1.0) < 1e-9


def _deq(t):
    packed, scale = log_quantize(torch.from_numpy(t), CFG)
    return log_dequantize(packed, scale, CFG)


def _grid_tol(y):
    # tests/test_conv2d.py: per-product LUT rounding at out_frac_bits=16
    return 5e-3 * float(y.abs().max() + 1)


@pytest.mark.parametrize("kind,stride", [("conv", 1), ("conv", 2),
                                         ("depthwise", 1),
                                         ("depthwise", 2), ("1x1", 1)])
def test_grid_matches_port_blockwise_conv(kind, stride):
    """`test_conv2d.py`'s kernel-vs-grid checks on the port: the grid in
    log mode against `log_conv2d_blockwise` on the dequantized x and the
    packed per-tensor weights (the codes the grid's threads see)."""
    grid = _grid("log", quant_cfg=CFG, out_frac_bits=16)
    if kind == "conv":
        x, w = _inputs(11, (12, 10, 6), (3, 3, 6, 4), zeros=0.0)
        y_grid, stats = grid.conv2d(x, w, stride=stride)
        w4, groups = w, 1
    elif kind == "depthwise":
        x, w = _inputs(12, (10, 9, 5), (3, 3, 5), zeros=0.0)
        y_grid, stats = grid.conv2d_depthwise(x, w, stride=stride)
        w4, groups = w[:, :, None, :], 5
    else:
        x, w = _inputs(13, (9, 8, 20), (20, 6), zeros=0.0)
        y_grid, stats = grid.conv2d_1x1(x, w)
        w4, groups = w[None, None], 1
    assert stats.cycles > 0
    qt = quantize_tensor(torch.from_numpy(np.ascontiguousarray(w4)), CFG)
    y_k = log_conv2d_blockwise(_deq(x)[None], qt.packed, qt.scale, CFG,
                               stride=stride, padding="VALID",
                               groups=groups)[0]
    assert y_k.shape == y_grid.shape
    assert float((y_k - y_grid).abs().max()) <= _grid_tol(y_grid)


def test_log_mode_needs_one_scale_per_tensor():
    grid = _grid("log", quant_cfg=LogQuantConfig(per_channel=True))
    x, w = _inputs(1, (6, 6, 2), (3, 3, 2, 1))
    with pytest.raises(ValueError, match="per_channel=False"):
        grid.conv2d(x, w)
