"""The port's log_matmul (`repro_torch.kernels`) against the JAX package's.

On the CPU, `ops.log_matmul` on each route ("cuda", whose wrapper runs the
plain `ref_log_matmul` for a CPU tensor, "blockwise" and "ref") is held
against `log_matmul_pallas(interpret=True)` and JAX's `ref_log_matmul` on
the shapes of `tests/test_kernels_log_matmul.py`: fp32 within 1e-5 (rtol
and atol; JAX's CPU `exp2` decode is up to ~1e-6 relative off the exact
one), bf16 within 3e-2 (one bf16 rounding of the output apart from
summation order).  The CPU tests of `log_matmul_geometry` check the
kernel's launch shape at every dense-layer shape of gemma-2b and
rwkv6-1.6b.  The test marked ``cuda`` holds the hand-written kernel
against its plain version; it runs only where there is a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
try:  # the machine with the card has no JAX: only the cuda test runs there
    import jax.numpy as jnp
    from repro.core import logquant as jlq
    from repro.kernels import ops as jops
    from repro.kernels.log_matmul import log_matmul_pallas
    from repro.kernels.ref import ref_log_matmul as jref
except ImportError:
    jnp = None

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import logquant as tlq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.log_conv2d import decode_codes  # noqa: E402
from repro_torch.kernels.log_matmul import (  # noqa: E402
    STAGE_ROWS, log_matmul_cuda, log_matmul_geometry)
from repro_torch.kernels.ref import ref_log_matmul  # noqa: E402
from repro_torch.serving.quantize import quantize_params  # noqa: E402

SHAPES = [  # m, k, n (test_kernels_log_matmul.py:24)
    (128, 128, 128),     # exactly one block
    (256, 384, 128),     # multi-block k
    (64, 128, 256),      # m smaller than block
    (130, 257, 129),     # ragged
    (8, 512, 64),        # skinny decode-like
]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _reference_package(request):
    if jnp is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _mk(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    return x, w


def _assert_codes_match(x, packed_j, packed_t, scale, cfg):
    """Codes equal, except on a half-step boundary, where `log2` may differ
    by one ulp between the two libraries."""
    pj, pt = np.asarray(packed_j), np.asarray(packed_t)
    bad = pj != pt
    if bad.any():
        mag = np.abs(x.astype(np.float64)) / np.asarray(scale, np.float64)
        steps = np.log2(np.broadcast_to(mag, x.shape)[bad]) * cfg.steps
        off = np.abs(steps - np.floor(steps) - 0.5)
        assert np.all(off < 1e-5), (pj[bad], pt[bad], off)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_log_matmul_matches_jax(m, k, n, dtype):
    x, w = _mk(m, k, n)
    packed, scale = jlq.log_quantize(jnp.asarray(w))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = {"pallas": log_matmul_pallas(xj, packed, scale, interpret=True),
            "ref": jref(xj, packed, scale)}
    qt = tlq.QuantizedTensor(torch.from_numpy(np.asarray(packed)),
                             torch.from_numpy(np.asarray(scale)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = TOL[dtype]
    for impl in ("cuda", "blockwise", "ref"):
        got = tops.log_matmul(xt, qt, impl=impl)
        assert got.dtype == xt.dtype and tuple(got.shape) == (m, n)
        for name, y in want.items():
            np.testing.assert_allclose(
                got.to(torch.float32).numpy(), np.asarray(y, np.float32),
                rtol=tol, atol=tol, err_msg=f"{impl} vs JAX {name}")


def test_nd_batch_input_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 32)) * 0.2).astype(np.float32)
    want = np.asarray(jops.log_matmul(jnp.asarray(x),
                                      jlq.quantize_tensor(jnp.asarray(w)),
                                      impl="pallas", interpret=True))
    qt = tlq.quantize_tensor(torch.from_numpy(w))
    for impl in ("cuda", "blockwise", "auto"):
        got = tops.log_matmul(torch.from_numpy(x), qt, impl=impl)
        assert tuple(got.shape) == (2, 3, 32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_channel,shape", [
    (True, (128, 128)), (True, (257, 129)), (False, (96, 32)),
])
def test_quantize_tensor_codes_match_jax(per_channel, shape):
    rng = np.random.default_rng(4)
    w = (rng.normal(size=shape) * 0.1).astype(np.float32)
    cfg_t = tlq.LogQuantConfig(per_channel=per_channel)
    qj = jlq.quantize_tensor(jnp.asarray(w),
                             jlq.LogQuantConfig(per_channel=per_channel))
    qt = tlq.quantize_tensor(torch.from_numpy(w), cfg_t)
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    _assert_codes_match(w, qj.packed, qt.packed.numpy(), np.asarray(qj.scale),
                        cfg_t)


def test_wrapper_checks_and_cpu_route():
    """On a CPU tensor the wrapper is its plain version; it refuses what
    the kernel does not take, whatever the device."""
    x, w = _mk(5, 40, 24, seed=6)
    qt = tlq.quantize_tensor(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    before = log_matmul_cuda.launches
    got = log_matmul_cuda(xt, qt.packed, qt.scale)
    assert log_matmul_cuda.launches == before  # no kernel ran
    assert torch.equal(got, ref_log_matmul(xt, qt.packed, qt.scale))
    with pytest.raises(ValueError, match="contiguous int8"):
        log_matmul_cuda(xt, qt.packed.t().contiguous().t(), qt.scale)
    with pytest.raises(ValueError, match="x \\[M, K\\]"):
        log_matmul_cuda(xt[:, :8], qt.packed, qt.scale)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        log_matmul_cuda(xt.double(), qt.packed, qt.scale)


def _dense_kn(arch: str) -> set:
    """(K, N) of every dense product of one layer of ``arch``: attention
    and GeGLU for gemma-2b, time-mix and channel-mix for rwkv6-1.6b."""
    c = get_config(arch)
    d, f = c.d_model, c.d_ff
    if arch == "rwkv6-1.6b":   # wr wk wv wg wo cr; ck; cv
        return {(d, d), (d, f), (f, d)}
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return {(d, q), (d, kv), (q, d), (d, f), (f, d)}   # wq wk/wv wo w1/w3 w2


LM_KN = sorted(_dense_kn("gemma-2b") | _dense_kn("rwkv6-1.6b"))


def test_lm_dense_shapes():
    """The shapes the geometry tests cover are the LMs' own."""
    assert LM_KN == [(2048, 256), (2048, 2048), (2048, 7168),
                     (2048, 16384), (7168, 2048), (16384, 2048)]


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n", LM_KN)
def test_geometry_covers_k_and_fills_the_card(m, k, n):
    """The shares cover K exactly, none is empty, each is whole stages;
    the launch comes near two blocks per SM (at least 1.5) unless K has
    no more stages to share out."""
    n_sm = 132
    g = log_matmul_geometry(m, k, n, n_sm)
    rows = STAGE_ROWS[g["bm"]]
    assert g["bm"] == (4 if m <= 4 else 8)
    assert g["m_tiles"] * g["bm"] >= m > (g["m_tiles"] - 1) * g["bm"]
    assert g["n_tiles"] * g["bn"] >= n > (g["n_tiles"] - 1) * g["bn"]
    assert g["k_per_split"] % rows == 0
    assert (g["splits"] - 1) * g["k_per_split"] < k <= \
        g["splits"] * g["k_per_split"]
    assert g["blocks"] == g["m_tiles"] * g["n_tiles"] * g["splits"]
    assert g["blocks"] >= 1.5 * n_sm or g["splits"] == -(-k // rows)
    assert g["blocks"] <= 3 * n_sm or g["splits"] == 1


@pytest.mark.parametrize("m,k,n", [(1, 1, 128), (4, 1, 7), (4, 63, 2048),
                                   (4, 129, 2048), (33, 4097, 300),
                                   (130, 257, 129), (8, 16384, 16384)])
def test_geometry_edge_shapes(m, k, n):
    """Ragged and extreme shapes: K = 1, K under one stage, many tiles."""
    g = log_matmul_geometry(m, k, n)
    assert g["splits"] >= 1 and g["k_per_split"] >= 1
    assert (g["splits"] - 1) * g["k_per_split"] < k <= \
        g["splits"] * g["k_per_split"]
    with pytest.raises(ValueError, match="empty"):
        log_matmul_geometry(0, k, n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """The hand-written kernel against `ref_log_matmul` on the card: the
    decode table bit for bit through a 1 x 128 product, the sweep shapes,
    K on either side of a share boundary, K = 1 and K = 16384, M from 1 to
    32, and a slice of a stacked code array, in fp32 and bf16; two calls
    on the same inputs give the same bits."""
    dev = cuda_device
    codes = torch.arange(128, dtype=torch.int8, device=dev).reshape(1, 128)
    y = log_matmul_cuda(torch.ones((1, 1), device=dev), codes,
                        torch.ones(128, device=dev))
    assert torch.equal(y.reshape(-1).view(torch.int32),
                       decode_codes(codes).reshape(-1).view(torch.int32))
    stack = quantize_params({"w1": torch.randn(3, 64, 48, device=dev)})["w1"]
    cases = []
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    kps = log_matmul_geometry(4, 2048, 2048, n_sm)["k_per_split"]
    edges = [(4, kps + d, 2048) for d in (-1, 0, 1)] + [
        (4, 1, 2048), (4, 16384, 2048), (1, 2048, 256)]
    edges += [(m, 2048, 512) for m in (1, 4, 5, 8, 16, 32)]
    for m, k, n in SHAPES + [(1, 33, 7)] + edges:
        x, w = _mk(m, k, n)
        qt = tlq.quantize_tensor(torch.from_numpy(w).to(dev))
        cases.append((x, qt.packed, qt.scale))
    assert stack.packed[1].is_contiguous()  # a rep's codes: read in place
    cases.append((_mk(4, 64, 1)[0], stack.packed[1], stack.scale[1]))
    for x, packed, scale in cases:
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 8e-3)):
            xt = torch.from_numpy(x).to(dev, dtype)
            want = ref_log_matmul(xt, packed, scale)
            before = log_matmul_cuda.launches
            got = log_matmul_cuda(xt, packed, scale)
            torch.cuda.synchronize()
            assert log_matmul_cuda.launches == before + 1
            again = log_matmul_cuda(xt, packed, scale)
            assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                        else torch.int32),
                               again.view(torch.int16 if dtype ==
                                          torch.bfloat16 else torch.int32))
            assert got.dtype == dtype and got.shape == want.shape
            tol = rel * (float(want.float().abs().max()) + 1)
            assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_kernel_at_im2col_rows(cuda_device):
    """An im2col conv's product above the grid's 524,280 rows (VGG-16's
    first conv at batch 11, 224 px: 551,936 rows) runs as two launches of
    whole row tiles and matches `ref_log_matmul`."""
    dev = cuda_device
    x, w = _mk(551_936, 27, 64)
    qt = tlq.quantize_tensor(torch.from_numpy(w).to(dev))
    xt = torch.from_numpy(x).to(dev)
    before = log_matmul_cuda.launches
    got = log_matmul_cuda(xt, qt.packed, qt.scale)
    torch.cuda.synchronize()
    assert log_matmul_cuda.launches == before + 2
    want = ref_log_matmul(xt, qt.packed, qt.scale)
    tol = 1e-4 * (float(want.abs().max()) + 1)
    assert float((got - want).abs().max()) <= tol
