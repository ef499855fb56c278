"""`relu_q`'s log requantization (`repro_torch.models.cnn.relu_q`), its
signed counterpart `log_q`, and their CUDA kernel
(`repro_torch.kernels.log_requant`, ``relu=False`` for a signed map).

On the CPU: which calls take the plain ops and how they are counted; the
kernel's launch shape and walk over a map, in plain Python; and a plain
emulation of the kernel's order of operations (`_emulate`, a test helper)
held against the port's plain ops bit for bit and against the JAX
package's `fake_log_quant` at `test_torch_logquant.py`'s tolerance.  The
tests marked ``cuda`` hold the kernel itself against the plain ops on the
card, bit for bit, on every `relu_q` input of the four nets; they run only
where there is a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
try:  # the machine with the card has no JAX: only the cuda tests run there
    import jax
    import jax.numpy as jnp
    from repro.core import logquant as jlq
except ImportError:
    jax = None

from repro_torch.core import logquant as tlq  # noqa: E402
from repro_torch.kernels import log_requant as lr  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.obs.metrics import REGISTRY  # noqa: E402

CFG = tlq.DEFAULT
CHANNELS = (3, 8, 64, 130)
# relu_q calls of one forward (tests/test_torch_cnn_spans.py's PLAN)
REQUANTS = {"vgg16": 13, "mobilenet_v1": 27, "resnet34": 33,
            "squeezenet": 26}


def _calls(path: str, name: str = "requant_calls") -> int:
    return REGISTRY.counter(name, path=path).value


def _signed_calls(path: str) -> int:
    return _calls(path, "requant_signed_calls")


def _map(seed: int, C: int, shape=(2, 5, 7)) -> np.ndarray:
    """An NHWC map of values over six decades with the inputs a
    requantization has to get right: channel 0 all zero, channel 1
    negative only, channel 2 (where C > 3) values on the half-step
    boundaries sqrt(2)^(k + 1/2) * scale below its max, negative zeros
    and positive denormals everywhere else."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (C,)) * 10.0 ** rng.uniform(-3, 3,
                                                           shape + (C,))
    x = x.reshape(-1, C)
    rows = x.shape[0]
    x[rng.random(size=x.shape) < 0.05] = -0.0
    x[5::11, 2:] = 1e-40 * (1 + rng.random(size=x[5::11, 2:].shape))
    x[:, 0] = 0.0
    x[:, 1:2] = -np.abs(x[:, 1:2]) - 1e-3
    if C > 3:
        scale = 3.7
        k = -(np.arange(rows - 1) % 62) - 1
        x[0, 2] = scale
        x[1:, 2] = scale * 2.0 ** ((k + 0.5) / 2)
    return x.astype(np.float32).reshape(shape + (C,))


def _emulate(x: torch.Tensor, cfg=CFG, relu=True):
    """The kernel's operations, in its order, in plain torch: the max of
    max(x, 0) (of |x| with ``relu=False``) per channel as a signed max over
    the float bits from a zeroed buffer, then one pass, which negates the
    value of a negative x and sets its code's sign bit when signed →
    (values, packed int8 codes)."""
    C = x.shape[-1]
    v = torch.maximum(x, torch.zeros(())) if relu else x.abs()
    bits = v.reshape(-1, C).view(torch.int32).amax(0).clamp_min(0)
    s = bits.view(torch.float32)
    scale = torch.where(s > 0, s, torch.ones(()))
    code = torch.round(torch.log2(torch.maximum(
        v / scale, torch.tensor(1e-38, dtype=torch.float32))) * cfg.steps)
    code = torch.clamp(code, cfg.code_min, 0)
    zero = v == 0
    y = torch.where(zero, torch.zeros(()),
                    torch.exp2(code * (1.0 / cfg.steps)) * scale)
    biased = torch.where(zero, 0, code.to(torch.int32) + cfg.bias)
    if not relu:
        neg = x < 0
        y = torch.where(neg, -y, y)
        biased = torch.where(neg, biased | (cfg.bias + 1), biased)
    return y, biased.to(torch.int8)


def _bits(t):
    return t.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# which path a call takes, and its count
# ---------------------------------------------------------------------------

PLAIN_CASES = {
    "cpu": (torch.float32, CFG, False),
    "grad": (torch.float32, CFG, True),
    "per_tensor": (torch.float32, tlq.LogQuantConfig(per_channel=False),
                   False),
    "bf16": (torch.bfloat16, CFG, False),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_relu_q_takes_the_plain_ops_and_counts_them(case):
    dtype, cfg, grad = PLAIN_CASES[case]
    x = torch.from_numpy(_map(1, 8)).to(dtype).requires_grad_(grad)
    assert not lr.kernel_takes(x, cfg)
    plain, cuda = _calls("plain"), _calls("cuda")
    y = tcnn.relu_q(x, "logq6", cfg)
    assert (_calls("plain"), _calls("cuda")) == (plain + 1, cuda)
    want = tlq.fake_log_quant(torch.relu(x), cfg)
    assert y.dtype == want.dtype and torch.equal(
        y.detach().view(torch.int16 if dtype == torch.bfloat16
                        else torch.int32),
        want.detach().view(torch.int16 if dtype == torch.bfloat16
                           else torch.int32))
    if grad:   # the straight-through backward of the QAT path
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
        (y * g).sum().backward()
        assert torch.equal(x.grad, torch.where(x > 0, g, torch.zeros(())))


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_log_q_takes_the_plain_ops_and_counts_them_signed(case):
    dtype, cfg, grad = PLAIN_CASES[case]
    x = torch.from_numpy(_map(2, 8)).to(dtype).requires_grad_(grad)
    assert not lr.kernel_takes(x, cfg)
    before = [_calls(p) for p in ("plain", "cuda")]
    plain, cuda = _signed_calls("plain"), _signed_calls("cuda")
    y = tcnn.log_q(x, "logq6", cfg)
    assert (_signed_calls("plain"), _signed_calls("cuda")) == (plain + 1,
                                                              cuda)
    assert [_calls(p) for p in ("plain", "cuda")] == before
    want = tlq.fake_log_quant(x, cfg)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(y.detach().view(view), want.detach().view(view))
    assert bool((y < 0).any())   # the signs are kept
    if grad:   # straight through, everywhere
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
        (y * g).sum().backward()
        assert torch.equal(x.grad, g)


def test_log_q_without_quant_is_the_identity_and_not_counted():
    x = torch.from_numpy(_map(5, 8))
    before = (_signed_calls("plain"), _signed_calls("cuda"))
    assert tcnn.log_q(x) is x
    assert (_signed_calls("plain"), _signed_calls("cuda")) == before


def test_relu_q_without_quant_is_a_relu_and_not_counted():
    x = torch.from_numpy(_map(3, 8))
    before = (_calls("plain"), _calls("cuda"))
    assert torch.equal(tcnn.relu_q(x), torch.relu(x))
    assert (_calls("plain"), _calls("cuda")) == before


def test_wrapper_runs_the_plain_version_on_the_cpu_and_refuses_grad():
    x = torch.from_numpy(_map(4, 64))
    y, codes = lr.log_requant_cuda(x, codes=True)
    assert torch.equal(_bits(y), _bits(tlq.fake_log_quant(torch.relu(x))))
    assert torch.equal(codes, tlq.log_quantize(torch.relu(x))[0])
    with pytest.raises(RuntimeError, match="no backward"):
        lr.log_requant_cuda(x.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="per channel"):
        lr.log_requant_cuda(x, tlq.LogQuantConfig(per_channel=False))
    with pytest.raises(ValueError, match="contiguous float32"):
        lr.log_requant_cuda(x.transpose(1, 2))


def test_wrapper_runs_the_signed_plain_version_on_the_cpu():
    x = torch.from_numpy(_map(6, 64))
    y, codes = lr.log_requant_cuda(x, codes=True, relu=False)
    assert torch.equal(_bits(y), _bits(tlq.fake_log_quant(x)))
    assert torch.equal(codes, tlq.log_quantize(x)[0])
    sign = (codes.to(torch.int32) >> CFG.bits) & 1
    assert torch.equal(sign.bool(), x < 0) and bool((y < 0).any())


# ---------------------------------------------------------------------------
# the launch shape and the walk over a map
# ---------------------------------------------------------------------------

GEOMETRIES = [  # rows, C, aligned
    (8 * 224 * 224, 64, True), (128 * 7 * 7, 512, True), (2 * 5 * 7, 3, True),
    (70, 130, True), (70, 64, False), (1, 12288, True), (3, 1000, True),
    (9, 1, True), (2 * 14 * 14, 1024, False), (3000, 96, True),
]


def _walk(rows, C, vec, blocks):
    """The vectors each thread of the kernel's `Walk` reads, in plain
    Python: the step is a whole number of rows' vectors, threads past it
    idle → {vector: thread} and each active thread's first channel."""
    vectors = C // vec
    total, threads = rows * vectors, blocks * lr.NT
    step = threads - threads % vectors
    owner, first = {}, {}
    for t in range(step):
        first[t] = (t % vectors) * vec
        for i in range(t, total, step):
            assert i not in owner
            owner[i] = t
    return owner, first, total


@pytest.mark.parametrize("rows,C,aligned", GEOMETRIES)
def test_geometry_and_walk_cover_each_vector_once_on_fixed_channels(
        rows, C, aligned):
    geo = lr.log_requant_geometry(rows, C, aligned, n_sm=2)
    vec = geo["vec"]
    assert vec == (4 if C % 4 == 0 and aligned else 1)
    assert geo["blocks"] * lr.NT >= C // vec
    assert geo["blocks"] <= max(2 * lr.BLOCKS_PER_SM, -(-C // vec // lr.NT))
    if rows * C > 2_000_000:   # the walk itself, at sizes Python walks fast
        return
    owner, first, total = _walk(rows, C, vec, geo["blocks"])
    assert sorted(owner) == list(range(total))
    assert all((i * vec) % C == first[t] for i, t in owner.items())


def test_geometry_refuses_what_the_kernel_cannot_take():
    for rows, C in ((0, 8), (4, 0), (4, lr.MAX_CHANNELS + 1)):
        with pytest.raises(ValueError):
            lr.log_requant_geometry(rows, C, True)


# ---------------------------------------------------------------------------
# the kernel's order of operations, emulated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", CHANNELS)
def test_emulation_equals_the_plain_ops_bit_for_bit(C):
    x = torch.from_numpy(_map(10 + C, C))
    y, codes = _emulate(x)
    want = tlq.fake_log_quant(torch.relu(x))
    assert torch.equal(_bits(y), _bits(want))
    assert torch.equal(codes, tlq.log_quantize(torch.relu(x))[0])
    assert torch.equal(_bits(y), _bits(lr.ref_log_requant(x)))
    assert float(y[..., 0].abs().max()) == 0.0   # all-zero channel
    assert float(y[..., 1].abs().max()) == 0.0   # negative-only channel
    assert not torch.signbit(y).any()            # -0.0 comes out as +0.0


@pytest.mark.parametrize("C", CHANNELS)
def test_signed_emulation_equals_the_plain_ops_bit_for_bit(C):
    x = torch.from_numpy(_map(50 + C, C))
    y, codes = _emulate(x, relu=False)
    assert torch.equal(_bits(y), _bits(tlq.fake_log_quant(x)))
    assert torch.equal(codes, tlq.log_quantize(x)[0])
    assert torch.equal(_bits(y), _bits(lr.ref_log_requant(x, relu=False)))
    assert float(y[..., 0].abs().max()) == 0.0   # all-zero channel
    assert bool((y[..., 1] < 0).all())           # negative-only channel
    zero = x == 0                                # -0.0 comes out as +0.0
    assert not torch.signbit(y[zero]).any() and not codes[zero].any()


@pytest.mark.parametrize("C", CHANNELS)
def test_emulation_matches_jax_fake_log_quant(C):
    """Values within `test_torch_logquant.py`'s 2e-6 of JAX's; a code may
    differ by one step only where 2·log2(v / scale) lies within 1e-5 of a
    half-step boundary (a one-ulp log2 between the two libraries,
    `repro/core/logquant.py:114`), and the map's boundary channel holds
    such values on purpose.  XLA's CPU reads a subnormal input as zero
    (its ``x == 0`` holds there), which the port and the kernel give the
    lowest code; those are held apart."""
    if jax is None:
        pytest.skip("needs jax: the JAX package is the reference")
    x = _map(20 + C, C)
    y, codes = _emulate(torch.from_numpy(x))
    xr = jnp.maximum(jnp.asarray(x), 0.0)
    yj = np.asarray(jlq.fake_log_quant(xr))
    pj, sj = jlq.log_quantize(xr)
    pj = np.asarray(pj)
    sub = (x > 0) & (x < np.finfo(np.float32).tiny)
    assert sub.any() and np.all(pj[sub] == 0) and np.all(yj[sub] == 0)
    assert np.all(codes.numpy()[sub] == 1)
    same = (pj == codes.numpy()) & ~sub
    np.testing.assert_allclose(y.numpy()[same], yj[same], rtol=2e-6, atol=0)
    flip = ~same & ~sub
    if flip.any():
        v = np.maximum(x, 0).astype(np.float64)[flip]
        scale = np.broadcast_to(np.asarray(sj, np.float64), x.shape)[flip]
        half = np.log2(v / scale) * CFG.steps
        assert np.all(np.abs(half - np.floor(half) - 0.5) < 1e-5)
        assert np.all(np.abs(pj[flip].astype(int)
                             - codes.numpy()[flip].astype(int)) == 1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_kernel_equals_plain(x):
    """The kernel against `ref_log_requant` on the card, values and codes
    bit for bit, twice; the workspace left zero."""
    want, want_codes = lr.ref_log_requant(x, codes=True)
    for _ in range(2):
        y, codes = lr.log_requant_cuda(x, codes=True)
        assert torch.equal(_bits(y), _bits(want)), tuple(x.shape)
        assert torch.equal(codes, want_codes), tuple(x.shape)
    assert torch.equal(lr.log_requant_cuda(x), y)
    assert int(lr._workspace(x.device).abs().sum()) == 0


def _assert_signed_kernel_equals_plain(x):
    """The signed kernel against `fake_log_quant` of x itself on the card,
    values and codes bit for bit, twice; the workspace left zero."""
    want, want_codes = tlq.fake_log_quant(x), tlq.log_quantize(x)[0]
    for _ in range(2):
        y, codes = lr.log_requant_cuda(x, codes=True, relu=False)
        assert torch.equal(_bits(y), _bits(want)), tuple(x.shape)
        assert torch.equal(codes, want_codes), tuple(x.shape)
    assert int(lr._workspace(x.device).abs().sum()) == 0


@pytest.mark.cuda
def test_signed_kernel_matches_plain_ops_on_card(cuda_device):
    """As below, signed: both loads, the special channels (the negative-only
    one now keeps its values), 2-d maps and the widest C; and the ReLU
    kernel called after the signed one on the same map still equals its
    plain ops."""
    dev = cuda_device
    for C in CHANNELS + (1, 1000, 1024):
        _assert_signed_kernel_equals_plain(
            torch.from_numpy(_map(60 + C, C)).to(dev))
    x = torch.from_numpy(_map(70, 64)).to(dev)
    off = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    off.copy_(x)
    assert off.data_ptr() % 16 == 4
    _assert_signed_kernel_equals_plain(off)
    _assert_signed_kernel_equals_plain(
        torch.randn((3, lr.MAX_CHANNELS), device=dev))
    _assert_signed_kernel_equals_plain(torch.randn((5000, 24), device=dev) ** 3)
    _assert_kernel_equals_plain(x)


@pytest.mark.cuda
def test_kernel_matches_plain_ops_on_card(cuda_device):
    """Both loads (C % 4 == 0 and aligned; otherwise, and x 4 bytes past a
    16-byte boundary), 2-d maps, the widest C, and the special channels."""
    dev = cuda_device
    for C in CHANNELS + (1, 1000, 1024):
        _assert_kernel_equals_plain(torch.from_numpy(_map(30 + C, C)).to(dev))
    x = torch.from_numpy(_map(40, 64)).to(dev)
    off = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    off.copy_(x)
    assert off.data_ptr() % 16 == 4
    _assert_kernel_equals_plain(off)
    _assert_kernel_equals_plain(torch.randn((3, lr.MAX_CHANNELS), device=dev))
    _assert_kernel_equals_plain(torch.randn((5000, 24), device=dev) ** 3)


def _nets(dev, batch, img, names):
    from repro_torch.serving.quantize import quantize_cnn_params
    x = torch.randn((batch, img, img, 3),
                    generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    for name in names:
        params, _ = tcnn.make_cnn(name, 0, device=dev)
        yield name, quantize_cnn_params(params, conv_layout="lane_packed"), x


def _requant_inputs(name, params, x, monkeypatch):
    """Every `relu_q` input of one forward on the main path, and the
    counters' and launches' moves over it."""
    seen, relu_q = [], tcnn.relu_q

    def spy(xin, quant=None, qcfg=CFG):
        seen.append(xin.clone())
        return relu_q(xin, quant, qcfg)

    monkeypatch.setattr(tcnn, "relu_q", spy)
    before = (_calls("cuda"), _calls("plain"), lr.log_requant_cuda.launches)
    with torch.no_grad():
        tcnn.CNNS[name][1](params, x, quant="logq6", conv_impl="auto")
    torch.cuda.synchronize()
    after = (_calls("cuda"), _calls("plain"), lr.log_requant_cuda.launches)
    monkeypatch.setattr(tcnn, "relu_q", relu_q)
    return seen, [a - b for a, b in zip(after, before)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,img", [
    (n, 2, 64) for n in sorted(REQUANTS)] + [("vgg16", 8, 224)])
def test_every_relu_q_input_of_the_nets_bit_for_bit(cuda_device, name, batch,
                                                    img, monkeypatch):
    for name, params, x in _nets(cuda_device, batch, img, [name]):
        seen, moved = _requant_inputs(name, params, x, monkeypatch)
        n = REQUANTS[name]
        assert len(seen) == n and moved == [n, 0, 2 * n]
        for xin in seen:
            _assert_kernel_equals_plain(xin)


def _forward_kernels(name, params, x, tries=5):
    """Names of the device kernels of one forward, from the first
    `torch.profiler` window that saw all of its conv and requantization
    kernels (the profiler on the card now and then loses events; a window
    opens with a fill kernel, since it may drop one at its edge)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.benchmarks.common import device_events
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    seen = []
    for attempt in range(tries):
        time.sleep(0.5 * attempt)
        before = log_conv2d_fused.launches
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device=x.device)
            torch.cuda.synchronize()
            tcnn.CNNS[name][1](params, x, quant="logq6", conv_impl="auto")
            torch.cuda.synchronize()
        kernels = [e.name for e in device_events(prof)
                   if not e.name.startswith(("Memcpy", "Memset"))
                   and "FillFunctor" not in e.name]
        convs = sum("log_conv2d" in k for k in kernels)
        requant = sum("requant_" in k for k in kernels)
        if (convs, requant) == (log_conv2d_fused.launches - before,
                                2 * REQUANTS[name]):
            return kernels
        seen.append((len(kernels), convs, requant))
    pytest.fail(f"{name}: no profiler window saw the whole forward "
                f"(kernels, convs, requantizations): {seen}")


@pytest.mark.cuda
def test_kernels_a_forward_on_card(cuda_device):
    """Two requantization kernels a `relu_q` call, and at most 90 / 250
    device kernels a VGG-16 / ResNet-34 forward on the main path."""
    bound = {"vgg16": 90, "resnet34": 250}
    for name, params, x in _nets(cuda_device, 2, 64, sorted(bound)):
        with torch.no_grad():
            tcnn.CNNS[name][1](params, x, quant="logq6", conv_impl="auto")
        kernels = _forward_kernels(name, params, x)
        assert len(kernels) <= bound[name], (name, len(kernels))
