"""The port's WKV6 (`repro_torch.kernels`: `ref_wkv6`, `wkv6_chunked`,
`wkv6_cuda`, `wkv6_geometry`, `ops.wkv6`) against the JAX package's
(`ref_wkv6`, `wkv6_chunked_jnp`, `wkv6_pallas(interpret=True)`).

The inputs are made with numpy from a seed and given to both packages.
On the CPU the "cuda" route runs the kernel's plain version, `ref_wkv6`.
Every comparison is held to JAX's own tolerance in
`tests/test_kernels_wkv6.py`, 1e-3 (rtol and atol).  The chunked closed
form of both packages overflows at strong decays; a test pins that down.
`_emulate_chunked` walks the CUDA kernel's chunked variant (its column
tiles, chunks and sub-chunks, with its decay factoring) in plain torch, so
the CPU tests hold that math against JAX's oracle, strong decays included.
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
from repro_torch.kernels.wkv6 import (CHUNK, DECODE_MAX_T,  # noqa: E402
                                      SUB_CHUNK, TARGET_BLOCKS, TILES,
                                      wkv6_chunked, wkv6_cuda,
                                      wkv6_geometry, wkv6_work)

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


# rwkv6-1.6b's WKV calls: 32 heads of 64; decode at 4 slots, prefill of a
# 3- or 15-token prompt, and a long call: (B, T) → variant, tile, blocks
MODEL_CALLS = [((4, 1), "decode", 32, 256), ((1, 3), "decode", 16, 128),
               ((1, 15), "chunked", 16, 128), ((1, 2048), "chunked", 16, 128)]


def _check_geometry(geo, B, T, H, K, V):
    tile, tiles = geo["tile"], geo["tiles"]
    assert tile in TILES and (tiles - 1) * tile < V <= tiles * tile
    assert geo["blocks"] == B * H * tiles
    # halved until two blocks an SM, never below 16 columns
    assert geo["blocks"] >= TARGET_BLOCKS or tile == TILES[0]
    start = next((n for n in TILES if V <= n), TILES[-1])
    assert tile <= start
    if tile < start:  # the tile twice as wide gave too few blocks
        assert B * H * -(-V // (2 * tile)) < TARGET_BLOCKS
    assert geo["variant"] == ("decode" if T <= DECODE_MAX_T else "chunked")
    assert K <= geo["kmax"] == geo["threads_per_column"] \
        * geo["rows_per_thread"]
    assert geo["threads"] <= 256
    if geo["variant"] == "decode":
        assert geo["chunk"] is None and geo["threads"] == tile // 4 * (
            geo["kmax"] // 4)
    else:
        assert (geo["chunk"], geo["sub_chunk"]) == (CHUNK, SUB_CHUNK)
        assert CHUNK % SUB_CHUNK == 0 and SUB_CHUNK == 16
        # the threads that hold the state cover it once, at most all 256
        assert geo["kmax"] * tile // 4 // geo["rows_per_thread"] \
            <= geo["threads"]


@pytest.mark.parametrize("bt,variant,tile,blocks", MODEL_CALLS)
def test_geometry_at_the_model_shapes(bt, variant, tile, blocks):
    """Decode at B = 4: 256 blocks of 32 columns; prefill at B = 1: 128
    blocks of 16, stopped by the 16-column floor; T = 15 in one chunk."""
    B, T = bt
    geo = wkv6_geometry(B, T, 32, 64, 64)
    assert (geo["variant"], geo["tile"], geo["blocks"]) == (variant, tile,
                                                           blocks)
    _check_geometry(geo, B, T, 32, 64, 64)
    if variant == "chunked":  # 2 rows x 4 columns of the state a thread
        assert geo["threads"] == 256 and geo["threads_per_column"] == 32
        assert T > geo["chunk"] or T <= geo["sub_chunk"]


@pytest.mark.parametrize("shape", [c[:5] for c in CASES] + [
    (1, 4, 2, 16, 16), (1, 5, 2, 16, 16), (1, 37, 2, 24, 40),
    (1, 17, 1, 64, 1024), (2, 9, 3, 5, 7), (8, 40, 32, 64, 64)])
def test_geometry_tiles_cover_v_once(shape):
    _check_geometry(wkv6_geometry(*shape), *shape)


def test_geometry_refuses_what_the_kernel_does_not_take():
    for bad in ((1, 1, 1, 65, 8), (1, 1, 1, 8, 1025), (0, 1, 1, 8, 8),
                (1, 0, 1, 8, 8)):
        with pytest.raises(ValueError, match="no wkv6 launch"):
            wkv6_geometry(*bad)


def _emulate_chunked(r, k, v, logw, u, state=None):
    """The CUDA kernel's chunked variant in plain torch (fp32): each column
    tile of `wkv6_geometry`, each chunk of ``CHUNK`` tokens zero-padded
    past T (k = 0, logw = 0: identity updates), each sub-chunk of
    ``SUB_CHUNK`` tokens with its own cumulative log decay p (p_{-1} = 0):
    pairs inside a sub-chunk decay by exp(p_{t-1} - p_s) taken directly,
    pairs across sub-chunks through the state at the boundary, so every
    exponent is ≤ 0.  Same arguments and results as `ref_wkv6`."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    tile = wkv6_geometry(B, T, H, K, V)["tile"]
    pt = (-T) % CHUNK

    def bhtx(a):  # [B, T, H, X] → [B, H, Tp, X] fp32, zero-padded in T
        return torch.nn.functional.pad(a.to(f32), (0, 0, 0, 0, 0, pt)) \
            .transpose(1, 2)

    rp, kp, vp, wp = (bhtx(a) for a in (r, k, v, logw))
    uf = u.to(f32)[None, :, None, :]                    # [1, H, 1, K]
    S0 = (torch.zeros((B, H, K, V), dtype=f32) if state is None
          else state.to(f32))
    tri = torch.ones(SUB_CHUNK, SUB_CHUNK, dtype=torch.bool).tril(-1)
    o = torch.zeros((B, H, T + pt, V), dtype=f32)
    S_out = torch.zeros_like(S0)
    for j0 in range(0, V, tile):
        cols = slice(j0, min(V, j0 + tile))
        S = S0[..., cols]
        for c0 in range(0, T + pt, CHUNK):
            for s0 in range(c0, c0 + CHUNK, SUB_CHUNK):
                if s0 >= T:
                    break
                sl = slice(s0, s0 + SUB_CHUNK)
                rr, kk, ww, vv = rp[:, :, sl], kp[:, :, sl], wp[:, :, sl], \
                    vp[:, :, sl, cols]
                p = torch.cumsum(ww, dim=2)             # [B, H, SUB, K]
                p_prev = p - ww
                # p_{t-1} - p_s for s < t only: never positive
                diff = torch.where(tri[..., None],
                                   p_prev[:, :, :, None] - p[:, :, None],
                                   torch.tensor(-torch.inf))
                a = torch.einsum("bhti,bhsi,bhtsi->bhts", rr, kk,
                                 torch.exp(diff))
                a = a + torch.diag_embed((rr * uf * kk).sum(-1))
                q = rr * torch.exp(p_prev)
                o[:, :, sl, cols] = a @ vv + q @ S
                p_last = p[:, :, -1]                    # [B, H, K]
                kh = kk * torch.exp(p_last[:, :, None] - p)
                S = torch.exp(p_last)[..., None] * S + kh.transpose(-1, -2) \
                    @ vv
        S_out[..., cols] = S
    return o[:, :, :T].transpose(1, 2), S_out


@pytest.mark.parametrize("b,t,h,kd,vd,chunk", CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_emulated_chunked_variant_matches_jax(b, t, h, kd, vd, chunk,
                                              with_state):
    """The kernel's chunked math against JAX's sequential oracle at the
    sweep shapes: K != V, T ragged against the chunk and the sub-chunk,
    T = 1, with and without a carried state."""
    inp = _mk(b, t, h, kd, vd, seed=t)
    s0 = _state(b, h, kd, vd) if with_state else None
    o_ref, s_ref = jref(*_j(inp), _j([s0])[0])
    o, s = _emulate_chunked(*_t(inp), _t([s0])[0])
    assert o.shape == (b, t, h, vd) and s.shape == (b, h, kd, vd)
    _close(o, o_ref, msg="o")
    _close(s, s_ref, msg="S_T")


@pytest.mark.parametrize("t,split", [(64, 40), (70, 33), (20, 16)])
def test_emulated_halves_equal_the_whole(t, split):
    """Two calls with the state carried equal one call and JAX's oracle
    on the whole, with the split on and off chunk boundaries."""
    inp = _mk(1, t, 2, 16, 24, seed=t)
    o_w, s_w = jref(*_j(inp))
    a = _t(inp)
    o1, s1 = _emulate_chunked(*[x[:, :split] for x in a[:4]], a[4])
    o2, s2 = _emulate_chunked(*[x[:, split:] for x in a[:4]], a[4], s1)
    _close(torch.cat([o1, o2], 1), o_w)
    _close(s2, s_w)


@pytest.mark.parametrize("logw", [-7.0, -float(np.e ** 2), -20.0])
def test_emulated_chunked_variant_is_finite_at_strong_decay(logw):
    """At the clip's floor (-e²), below it (-7 is the chip check's) and far
    below it (-20), JAX's chunked closed form gives NaN over a chunk of 64;
    the kernel's factoring stays finite and within TOL of the oracle."""
    inp = _mk(1, 70, 2, 16, 16, seed=5, logw=logw)
    s0 = _state(1, 2, 16, 16)
    o_cj, _ = wkv6_chunked_jnp(*_j(inp), _j([s0])[0], chunk=64)
    assert np.isnan(np.asarray(o_cj)).any()
    o_ref, s_ref = jref(*_j(inp), _j([s0])[0])
    o, s = _emulate_chunked(*_t(inp), _t([s0])[0])
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    _close(o, o_ref, msg="o")
    _close(s, s_ref, msg="S_T")


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
    state, K != V, head size 64, T on both sides of the variant threshold,
    of a sub-chunk and of a chunk, V not a multiple of the tile, rows that
    take element copies (K = 24, V = 37), strong decays (-7, -e², -20),
    fp32 and bf16 r/k/v; two calls give the same bits."""
    dev = cuda_device
    cases = [(c[:5], None) for c in CASES] + [
        ((4, 1, 32, 64, 64), None), ((1, 15, 4, 64, 64), None),
        ((2, 40, 2, 16, 32), None), ((1, 4, 2, 16, 16), None),
        ((1, 5, 2, 16, 16), None), ((1, 16, 2, 32, 32), None),
        ((1, 17, 2, 32, 32), None), ((1, 32, 2, 64, 40), None),
        ((1, 33, 2, 64, 40), None), ((1, 70, 2, 24, 37), None),
        ((3, 3, 2, 64, 40), None), ((1, 64, 2, 16, 16), -7.0),
        ((1, 100, 2, 64, 64), -float(np.e ** 2)),
        ((1, 100, 2, 64, 64), -20.0)]
    for (b, t, h, kd, vd), logw in cases:
        inp = [a.to(dev) for a in _t(_mk(b, t, h, kd, vd, seed=t,
                                         logw=logw))]
        s0 = torch.from_numpy(_state(b, h, kd, vd)).to(dev)
        geo = wkv6_geometry(b, t, h, kd, vd)
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 8e-3)):
            label = f"{(b, t, h, kd, vd)} logw={logw} {dtype} {geo}"
            args = [a.to(dtype) for a in inp[:3]] + inp[3:]
            o_r, s_r = ref_wkv6(*args, s0)
            before = wkv6_cuda.launches
            o, s = wkv6_cuda(*args, s0)
            o2, s2 = wkv6_cuda(*args, s0)
            torch.cuda.synchronize()
            assert wkv6_cuda.launches == before + 2, label
            assert torch.equal(o, o2) and torch.equal(s, s2), label
            assert o.dtype == dtype and s.dtype == torch.float32, label
            assert torch.isfinite(o).all() and torch.isfinite(s).all(), label
            for got, want in ((o, o_r), (s, s_r)):
                tol = rel * (float(want.abs().max()) + 1)
                assert float((got.float() - want).abs().max()) <= tol, label
            if logw is None:
                o_c, _ = wkv6_chunked(*args, s0, chunk=16)
                tol = rel * (float(o_r.abs().max()) + 1)
                assert float((o.float() - o_c.float()).abs().max()) <= tol, \
                    label
