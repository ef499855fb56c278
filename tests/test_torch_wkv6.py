"""The port's WKV6 (`repro_torch.kernels`: `ref_wkv6`, `wkv6_chunked`,
`wkv6_cuda`, `ops.wkv6`) against the JAX package's (`ref_wkv6`,
`wkv6_chunked_jnp`, `wkv6_pallas(interpret=True)`).

The inputs are made with numpy from a seed and given to both packages.
On the CPU the "cuda" route runs the kernel's plain version, `ref_wkv6`.
Every comparison is held to JAX's own tolerance in
`tests/test_kernels_wkv6.py`, 1e-3 (rtol and atol).  The chunked closed
form of both packages overflows at strong decays; a test pins that down.
The test marked ``cuda`` holds the hand-written kernel against its plain
versions; it runs only where there is a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the machine with the card has no JAX: only the cuda test runs there
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels.ref import ref_wkv6 as jref
    from repro.kernels.wkv6 import wkv6_chunked_jnp, wkv6_pallas
except ImportError:
    jnp = None

from repro_torch.kernels import WkvConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import ref_wkv6  # noqa: E402
from repro_torch.kernels.wkv6 import (wkv6_chunked, wkv6_cuda,  # noqa: E402
                                      wkv6_work)

TOL = 1e-3  # tests/test_kernels_wkv6.py
CASES = [  # b, t, h, kd, vd, chunk (tests/test_kernels_wkv6.py:24)
    (1, 64, 2, 32, 32, 16),
    (2, 96, 2, 16, 32, 32),    # ragged T vs chunk, K != V
    (1, 33, 1, 8, 8, 16),      # T not a multiple of the chunk
    (2, 1, 2, 16, 16, 16),     # decode: T = 1
]


@pytest.fixture(autouse=True)
def _reference_package(request):
    if jnp is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _mk(b, t, h, kd, vd, seed=0, logw=None):
    """As `tests/test_kernels_wkv6.py:_mk`: numpy fp32 r, k, v, logw, u,
    with a data-dependent log decay in about [-2, -0.02] unless ``logw``
    fixes it."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(b, t, h, kd)) * 0.5
    k = rng.normal(size=(b, t, h, kd)) * 0.5
    v = rng.normal(size=(b, t, h, vd)) * 0.5
    lw = -np.exp(rng.normal(size=(b, t, h, kd)) * 0.5 - 1.5)
    if logw is not None:
        lw = np.full_like(lw, logw)
    u = rng.normal(size=(h, kd)) * 0.3
    return tuple(a.astype(np.float32) for a in (r, k, v, lw, u))


def _state(b, h, kd, vd, seed=1):
    return (np.random.default_rng(seed).normal(size=(b, h, kd, vd))
            * 0.5).astype(np.float32)


def _t(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("b,t,h,kd,vd,chunk", CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_matches_jax(b, t, h, kd, vd, chunk, with_state):
    """Every route of the port (`ops.wkv6` with impl cuda / blockwise / ref
    / auto, and the functions themselves) against JAX's oracle, chunked
    form and Pallas kernel in interpret mode, for o and S_T."""
    inp = _mk(b, t, h, kd, vd, seed=t)
    s0 = _state(b, h, kd, vd) if with_state else None
    o_ref, s_ref = jref(*_j(inp), _j([s0])[0])
    want = {"jax ref": (o_ref, s_ref),
            "jax chunked": wkv6_chunked_jnp(*_j(inp), _j([s0])[0],
                                            chunk=chunk),
            "jax pallas": wkv6_pallas(*_j(inp), _j([s0])[0], chunk=chunk,
                                      interpret=True)}
    args = _t(inp) + _t([s0])
    got = {impl: tops.wkv6(*args, impl=impl, chunk=chunk)
           for impl in ("cuda", "blockwise", "ref", "auto")}
    got["ref_wkv6"] = ref_wkv6(*args)
    got["wkv6_chunked"] = wkv6_chunked(*args, chunk=chunk)
    got["wkv6_cuda"] = wkv6_cuda(*args)
    for name, (o, s) in got.items():
        assert o.shape == (b, t, h, vd) and s.shape == (b, h, kd, vd), name
        assert s.dtype == torch.float32, name
        for wname, (wo, ws) in want.items():
            _close(o, wo, msg=f"o: {name} vs {wname}")
            _close(s, ws, msg=f"S_T: {name} vs {wname}")


@pytest.mark.parametrize("impl", ["cuda", "blockwise", "ref"])
def test_wkv6_state_carry_composes(impl):
    """Two halves with the state carried equal the whole sequence, and
    JAX's oracle on the whole (`test_wkv6_state_carry_composes`)."""
    inp = _t(_mk(1, 64, 2, 16, 16, seed=7))
    o_full, s_full = jref(*_j(_mk(1, 64, 2, 16, 16, seed=7)))
    first = [a[:, :32] for a in inp[:4]] + [inp[4]]
    second = [a[:, 32:] for a in inp[:4]] + [inp[4]]
    o1, s1 = tops.wkv6(*first, impl=impl, chunk=16)
    o2, s2 = tops.wkv6(*second, state=s1, impl=impl, chunk=16)
    _close(torch.cat([o1, o2], 1), o_full)
    _close(s2, s_full)


@pytest.mark.parametrize("b,t,h", [(1, 1, 1), (2, 17, 2), (3, 48, 1),
                                   (1, 40, 2)])
def test_wkv6_chunk_invariance(b, t, h):
    """The chunk length does not change the chunked form's result (JAX's
    `test_property_wkv6_chunk_invariance`, at fixed draws), and both
    chunkings agree with JAX's at the same chunk."""
    inp = _mk(b, t, h, 8, 8, seed=t)
    o8, s8 = tops.wkv6(*_t(inp), impl="blockwise",
                       config=WkvConfig(chunk=8))
    o32, s32 = tops.wkv6(*_t(inp), impl="blockwise", chunk=32)
    _close(o8, o32.numpy(), tol=2e-3)
    _close(s8, s32.numpy(), tol=2e-3)
    jo, js = jops.wkv6(*_j(inp), impl="blockwise", chunk=8)
    _close(o8, jo)
    _close(s8, js)


def test_chunk_argument_beats_the_config():
    inp = _t(_mk(1, 20, 1, 8, 8, seed=3))
    a = tops.wkv6(*inp, impl="blockwise", config=WkvConfig(chunk=16),
                  chunk=4)
    b = wkv6_chunked(*inp, chunk=4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_strong_decay_overflows_the_chunked_form_of_both_packages():
    """At logw = -3 over a chunk of 64 the cumulative log decay reaches
    -192, exp(-P) overflows fp32 and the closed form of both packages
    returns NaN; the sequential oracles stay finite and agree (the CUDA
    kernel runs the recurrence as the oracle does)."""
    inp = _mk(1, 64, 2, 16, 16, seed=11, logw=-3.0)
    o_t, s_t = ref_wkv6(*_t(inp))
    o_j, s_j = jref(*_j(inp))
    assert torch.isfinite(o_t).all() and torch.isfinite(s_t).all()
    _close(o_t, o_j)
    _close(s_t, s_j)
    _close(tops.wkv6(*_t(inp), impl="cuda")[0], o_j)
    o_c, _ = wkv6_chunked(*_t(inp), chunk=64)
    o_cj, _ = wkv6_chunked_jnp(*_j(inp), chunk=64)
    assert torch.isnan(o_c).any()
    assert np.isnan(np.asarray(o_cj)).any()
    # the closed form holds where the chunk's decay stays in range
    mild = _mk(1, 64, 2, 16, 16, seed=11, logw=-1.0)
    _close(wkv6_chunked(*_t(mild), chunk=64)[0], jref(*_j(mild))[0])


def test_bf16_inputs_keep_their_dtype():
    """bf16 r, k, v with fp32 logw and u (the full-width model's types): o
    comes back in r's dtype from cuda and blockwise, fp32 from ref, and
    all agree with JAX's oracle on the same bf16 values."""
    r, k, v, lw, u = _mk(2, 9, 2, 16, 16, seed=2)
    rkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    args = rkv + [torch.from_numpy(lw), torch.from_numpy(u)]
    want, _ = jref(*[jnp.asarray(a.float().numpy()) for a in rkv],
                   jnp.asarray(lw), jnp.asarray(u))
    for impl, dtype in (("cuda", torch.bfloat16), ("blockwise",
                                                   torch.bfloat16),
                        ("ref", torch.float32)):
        o, s = tops.wkv6(*args, impl=impl, chunk=16)
        assert o.dtype == dtype and s.dtype == torch.float32, impl
        _close(o, want, tol=8e-3, msg=impl)  # one bf16 rounding of o


def test_wrapper_checks_and_counts_only_kernel_launches():
    """On a CPU tensor the wrapper runs `ref_wkv6` and launches nothing;
    inconsistent operands raise on every device."""
    r, k, v, lw, u = _t(_mk(1, 5, 2, 8, 16))
    before = wkv6_cuda.launches
    o, s = wkv6_cuda(r, k, v, lw, u)
    assert wkv6_cuda.launches == before
    want = ref_wkv6(r, k, v, lw, u)
    assert torch.equal(o, want[0]) and torch.equal(s, want[1])
    with pytest.raises(ValueError, match="inconsistent wkv6 operands"):
        wkv6_cuda(r, k[..., :4], v, lw, u)
    with pytest.raises(ValueError, match="inconsistent wkv6 operands"):
        wkv6_cuda(r, k, v, lw, u[:1])
    with pytest.raises(ValueError, match="state"):
        wkv6_cuda(r, k, v, lw, u, torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="unknown wkv6 impl"):
        tops.wkv6(r, k, v, lw, u, impl="pallas")


def test_work_counts_bytes_and_flops():
    """The bound's inputs: each operand read once in its dtype, o and S_T
    written once, the state read only when given."""
    r = torch.zeros(4, 1, 32, 64, dtype=torch.bfloat16)
    lw = torch.zeros(4, 1, 32, 64)
    nbytes, flops = wkv6_work(r, r, lw)
    state = 4 * 32 * 64 * 64 * 4
    # r, k, v read and o written in bf16; logw read in fp32; u; S0 and S_T
    assert nbytes == 4 * 4 * 32 * 64 * 2 + 4 * 32 * 64 * 4 \
        + 32 * 64 * 4 + 2 * state
    assert wkv6_work(r, r, lw, state_given=False)[0] == nbytes - state
    assert flops == 7 * 4 * 32 * 64 * 64 + 4 * 32 * 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """The hand-written kernel against `ref_wkv6` (and `wkv6_chunked` where
    its closed form is finite) on the card: the sweep shapes, T = 1 with a
    state, K != V, head size 64, a strong decay, fp32 and bf16 r/k/v."""
    dev = cuda_device
    cases = [(c[:5], None) for c in CASES] + [
        ((4, 1, 32, 64, 64), None), ((1, 15, 4, 64, 64), None),
        ((2, 40, 2, 16, 32), None), ((1, 64, 2, 16, 16), -7.0)]
    for (b, t, h, kd, vd), logw in cases:
        inp = [a.to(dev) for a in _t(_mk(b, t, h, kd, vd, seed=t,
                                         logw=logw))]
        s0 = torch.from_numpy(_state(b, h, kd, vd)).to(dev)
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 8e-3)):
            args = [a.to(dtype) for a in inp[:3]] + inp[3:]
            o_r, s_r = ref_wkv6(*args, s0)
            before = wkv6_cuda.launches
            o, s = wkv6_cuda(*args, s0)
            torch.cuda.synchronize()
            assert wkv6_cuda.launches == before + 1
            assert o.dtype == dtype and s.dtype == torch.float32
            assert torch.isfinite(o).all() and torch.isfinite(s).all()
            for got, want in ((o, o_r), (s, s_r)):
                tol = rel * (float(want.abs().max()) + 1)
                assert float((got.float() - want).abs().max()) <= tol
            if logw is None:
                o_c, _ = wkv6_chunked(*args, s0, chunk=16)
                tol = rel * (float(o_r.abs().max()) + 1)
                assert float((o.float() - o_c.float()).abs().max()) <= tol
