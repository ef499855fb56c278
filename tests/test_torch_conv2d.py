"""The port's conv stack (`repro_torch.kernels`) against the JAX package's.

On the CPU the port's `ref` and `blockwise` (and the CUDA kernel's wrapper,
which runs its plain version for a CPU tensor) are held against JAX's
`ref`, `blockwise` and `log_conv2d_fused_pallas(interpret=True)` on the
sweeps of `tests/test_conv2d.py`, at its tolerances (`:58`, `:119-125`).
The test marked ``cuda`` holds the hand-written kernel itself against its
plain versions; it runs only where there is a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
try:  # the machine with the card has no JAX: only the cuda test runs there
    import jax.numpy as jnp
    from repro.core.logquant import LogQuantConfig as JaxLogQuantConfig
    from repro.core.logquant import quantize_tensor as jquantize
    from repro.kernels import log_conv2d as jlc
    from repro.kernels import ops as jops
    from repro.kernels.log_matmul import _decode_block
except ImportError:
    jnp = None

from repro_torch.core.logquant import QuantizedTensor  # noqa: E402
from repro_torch.core.logquant import quantize_tensor as tquantize  # noqa: E402
from repro_torch.kernels import log_conv2d as tlc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serving.quantize import quantize_cnn_params  # noqa: E402

SHAPES = [  # B, H, W, C, K, P, stride, padding, groups (test_conv2d.py:32)
    (2, 8, 8, 5, 3, 7, 1, "SAME", 1),
    (1, 9, 7, 4, 3, 6, 2, "SAME", 1),
    (2, 8, 8, 6, 3, 6, 1, "VALID", 6),    # depthwise
    (1, 10, 10, 4, 1, 8, 1, "VALID", 1),  # 1x1 (pwconv)
    (1, 8, 8, 6, 3, 4, 2, "SAME", 2),     # grouped, stride 2
    (1, 8, 8, 3, 5, 4, 2, 2, 1),          # K=5, int padding (ResNet stem)
    (1, 8, 8, 3, 3, 5, 1, ((1, 2), (0, 1)), 1),  # explicit asymmetric pairs
    (1, 10, 10, 4, 3, 6, 2, "SAME", 1),   # SAME, even input, stride 2
    (1, 9, 9, 4, 3, 5, 2, "VALID", 1),    # VALID where Ho/Wo round down
]

LANE_SHAPES = [  # test_conv2d.py:89
    (1, 8, 8, 6, 3, 6, 1, "SAME", 6),      # depthwise, multiplier 1
    (1, 8, 8, 6, 3, 12, 1, "SAME", 6),     # depthwise, Cout = Cin * 2
    (1, 9, 7, 12, 3, 8, 2, "SAME", 4),     # cin_g=3
    (1, 8, 8, 8, 3, 8, 1, "VALID", 4),     # cin_g=2
    (2, 8, 8, 16, 5, 8, 2, 2, 4),          # cin_g=4, K=5, int padding
    (1, 8, 8, 4, 3, 8, 1, ((1, 2), (0, 1)), 4),  # asymmetric, depthwise
]


DW_SHAPES = [  # depthwise shapes at the edges of the depthwise kernel's tiles
    (1, 19, 21, 8, 3, 8, 1, "SAME", 8),       # H and W not multiples of a tile
    (3, 11, 13, 10, 3, 10, 1, "SAME", 10),    # C % 4 != 0, batch 3
    (1, 15, 16, 12, 3, 12, 2, "SAME", 12),    # stride 2, odd H; W pads (0, 1)
    (3, 14, 9, 36, 3, 36, 2, "SAME", 36),     # stride 2, a ragged channel tile
    (2, 12, 11, 8, 5, 8, 1, "SAME", 8),       # K = 5
    (1, 13, 14, 8, 5, 8, 2, "SAME", 8),       # K = 5, stride 2, pads (1, 2)
    (1, 10, 9, 4, 3, 8, 1, "SAME", 4),        # channel multiplier 2
    (3, 9, 10, 6, 3, 12, 2, "SAME", 6),       # multiplier 2, stride 2
    (1, 37, 41, 40, 3, 40, 1, "SAME", 40),    # many tiles each way
    (2, 9, 9, 16, 3, 16, 2, "VALID", 16),     # VALID, stride 2
    (2, 28, 30, 24, 3, 48, 1, "SAME", 24),    # multiplier 2, 16-channel tiles
    (4, 40, 36, 30, 3, 30, 2, "SAME", 30),    # C % 4 != 0 on wider tiles
]


@pytest.fixture(autouse=True)
def _reference_package(request):
    if jnp is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs jax: the JAX package is the reference")


def _inputs(seed, B, H, W, C, K, P, groups):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = rng.normal(size=(K, K, C // groups, P)).astype(np.float32)
    return x, w


def _lane_qt(qt, groups):
    """The ``lane_packed`` QuantizedTensor `quantize_cnn_params` would bake."""
    lp = tlc.lane_pack_geometry(groups, qt.shape[2])
    codes = tlc.lane_pack_codes(qt.packed, groups, lp["g_b"], lp["cin_lane"])
    return QuantizedTensor(codes, qt.scale.reshape(-1), qt.cfg, qt.shape,
                           layout="lane_packed",
                           layout_meta=(lp["g_b"], lp["cin_lane"], groups))


@pytest.mark.parametrize("B,H,W,C,K,P,stride,padding,groups",
                         SHAPES + LANE_SHAPES)
def test_port_conv_matches_jax(B, H, W, C, K, P, stride, padding, groups):
    x, w = _inputs(0, B, H, W, C, K, P, groups)
    kw = dict(stride=stride, padding=padding, groups=groups)
    qj = jquantize(jnp.asarray(w))
    qt = tquantize(torch.from_numpy(w))
    np.testing.assert_array_equal(qt.packed.numpy(), np.asarray(qj.packed))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    y_jref = np.asarray(jops.conv2d(xj, qj, impl="ref", **kw))
    jax_outs = {
        "blockwise": jops.conv2d(xj, qj, impl="blockwise", **kw),
        "fused": jlc.log_conv2d_fused_pallas(xj, qj.packed, qj.scale,
                                             interpret=True, **kw)}
    port_outs = {
        "ref": tops.conv2d(xt, qt, impl="ref", **kw),
        "blockwise": tops.conv2d(xt, qt, impl="blockwise", **kw),
        "cuda-wrapper": tops.conv2d(xt, qt, impl="cuda", **kw)}
    if tlc.lane_pack_geometry(groups, C // groups)["g_b"] > 1:
        port_outs["cuda-wrapper lane"] = tops.conv2d(
            xt, _lane_qt(qt, groups), impl="cuda", **kw)
    tol = 1e-4 * float(np.abs(y_jref).max() + 1)
    for name, y in port_outs.items():
        assert tuple(y.shape) == y_jref.shape, name
        for jname, yj in jax_outs.items():
            np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=tol,
                                       err_msg=f"port {name} vs jax {jname}")
        np.testing.assert_allclose(y.numpy(), y_jref, atol=tol,
                                   err_msg=f"port {name} vs jax ref")


def test_padding_geometry_matches_jax():
    for size in range(1, 12):
        for k in (1, 3, 5):
            for s in (1, 2, 3):
                assert tlc._pad_pair(size, k, s) == jlc._pad_pair(size, k, s)
                assert tlc._out_size(size, k, s, (1, 2)) == \
                    jlc._out_size(size, k, s, (1, 2))
    for pad in ("SAME", "valid", 2, (1, 0), ((1, 2), (0, 1))):
        assert tlc.normalize_padding(pad, 3, 2, 9, 8) == \
            jlc.normalize_padding(pad, 3, 2, 9, 8)
    with pytest.raises(ValueError):
        tlc.normalize_padding("FULL", 3, 1, 8, 8)


def test_im2col_and_block_diag_codes_match_jax():
    x, w = _inputs(1, 2, 7, 9, 6, 3, 4, 2)
    pads = tlc.normalize_padding("SAME", 3, 2, 7, 9)
    pj, hj, wj = jlc._im2col(jnp.asarray(x), 3, 2, pads)
    pt, ht, wt = tlc._im2col(torch.from_numpy(x), 3, 2, pads)
    assert (ht, wt) == (hj, wj)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    codes = np.array(jquantize(jnp.asarray(w)).packed)
    np.testing.assert_array_equal(
        tlc._block_diag_codes(torch.from_numpy(codes), 2).numpy(),
        np.asarray(jlc._block_diag_codes(jnp.asarray(codes), 2)))


def test_lane_pack_layout_matches_jax_byte_for_byte():
    rng = np.random.default_rng(6)
    for groups in (1, 2, 3, 4, 6, 32, 200):
        for cin_g in (1, 2, 3, 4, 5, 64, 200):
            for lane_pack in (None, 1, 4):
                assert tlc.lane_pack_geometry(groups, cin_g, lane_pack) == \
                    jlc.lane_pack_geometry(groups, cin_g, lane_pack)
    for C, groups, P, K in ((6, 6, 6, 3), (12, 4, 8, 3), (16, 4, 8, 5),
                            (200, 200, 200, 3)):
        cin_g = C // groups
        codes = rng.integers(-128, 128, size=(K, K, cin_g, P)).astype(np.int8)
        lp = jlc.lane_pack_geometry(groups, cin_g)
        cj = np.asarray(jlc.lane_pack_codes(jnp.asarray(codes), groups,
                                            lp["g_b"], lp["cin_lane"]))
        ct = tlc.lane_pack_codes(torch.from_numpy(codes), groups, lp["g_b"],
                                 lp["cin_lane"])
        np.testing.assert_array_equal(ct.numpy(), cj)
        back = tlc.lane_unpack_codes(ct, codes.shape, groups, lp["g_b"],
                                     lp["cin_lane"])
        np.testing.assert_array_equal(back.numpy(), codes)


def test_decode_codes_is_exact_eq8():
    """`decode_codes` (what the kernel reproduces bit for bit) equals the
    exactly rounded ``sign·2^(code/2)`` for every int8 code; JAX's decodes
    agree within the error of XLA's CPU `exp2` (up to ~1.01e-6 relative at
    large negative exponents)."""
    codes = np.arange(-128, 128).astype(np.int8)
    p = codes.astype(np.int32)
    biased = p & 63
    exact = np.where(biased != 0, (1 - 2 * ((p >> 6) & 1))
                     * 2.0 ** ((biased - 63) / 2.0), 0.0).astype(np.float32)
    got = tlc.decode_codes(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), exact.view(np.int32))
    np.testing.assert_allclose(
        got, np.asarray(_decode_block(jnp.asarray(codes), JaxLogQuantConfig(),
                                      jnp.float32)), rtol=2e-6, atol=0)
    np.testing.assert_allclose(
        got, np.asarray(jlc.log_dequantize(jnp.asarray(codes), 1.0,
                                           dtype=jnp.float32)),
        rtol=2e-6, atol=0)


@pytest.mark.parametrize("bits,frac_bits", [(6, 1), (5, 1), (7, 1), (6, 0),
                                            (7, 0)])
def test_plane_table_is_the_exact_decode(bits, frac_bits):
    """The conv kernel's table: for every code, the even plane equals
    `decode_codes` bit for bit where the code has no √2 factor, fp32(√2) ×
    the odd plane equals it bit for bit where it has one, the other plane
    is +0, and the zero code gives +0 in both."""
    cfg = tlc.LogQuantConfig(bits=bits, frac_bits=frac_bits)
    n = 2 << bits
    tab = tlc.plane_table(cfg, torch.device("cpu"))
    assert tab.dtype == torch.int32 and tuple(tab.shape) == (n,)

    def plane(shift):
        return ((tab >> shift) & 0xFFFF).to(torch.int16).view(
            torch.bfloat16).float()

    even, odd = plane(0), plane(16)
    codes = torch.arange(n, dtype=torch.int64)
    want = tlc.decode_codes(codes, cfg)
    sqrt2 = torch.tensor(2.0 ** 0.5, dtype=torch.float32)
    code = (codes & cfg.bias) - cfg.bias
    has_sqrt2 = (code & 1).bool() & (frac_bits == 1)
    bits_of = lambda t: t.view(torch.int32)  # noqa: E731
    assert torch.equal(bits_of(torch.where(has_sqrt2, sqrt2 * odd, even)),
                       bits_of(want))
    assert torch.equal(bits_of(torch.where(has_sqrt2, even, odd)),
                       torch.zeros(n, dtype=torch.int32))
    zero = (codes & cfg.bias) == cfg.zero_code
    assert int(zero.sum()) == 2
    assert torch.equal(tab[zero], torch.zeros(2, dtype=torch.int32))
    # every plane value is a power of two or zero: exact in bf16
    mags = torch.cat([even, odd]).abs()
    nz = mags[mags != 0]
    assert torch.equal(torch.exp2(torch.log2(nz).round()), nz)


def _geometry_cases():
    from repro_torch.models.cnn import zoo_conv_shapes
    recs = [(r["B"], r["H"], r["W"], r["C"], r["K"], r["Cout"], r["stride"],
             r["padding"], r["groups"])
            for b in (1, 8) for r in zoo_conv_shapes(batch=b)]
    return recs + SHAPES + LANE_SHAPES + DW_SHAPES


def _check_depthwise_geometry(g, B, Ho, Wo, C, K, P, stride, groups):
    """A depthwise launch shape: tiles that cover Ho x Wo x Cout exactly, a
    block within 256 threads whose halo patch and decoded codes fit the
    shared memory it declares, and the cp.async load exactly where
    C % 4 == 0 and each group has one output channel."""
    assert g["path"] == "depthwise" and g["splits"] == 1
    th, tw, ct = g["tile"]
    for n, t, tiles in ((Ho, th, "tiles_h"), (Wo, tw, "tiles_w"),
                        (P, ct, "tiles_c")):
        assert (g[tiles] - 1) * t < n <= g[tiles] * t, (tiles, g)
    assert g["tiles"] == g["blocks"] == \
        B * g["tiles_h"] * g["tiles_w"] * g["tiles_c"]
    assert tw % tlc.DW_PW == 0 and ct in (4, 8, 16, 32)
    assert g["threads"] == ct // 4 * th * (tw // tlc.DW_PW) <= tlc.DW_NT
    patch = ((th - 1) * stride + K) * ((tw - 1) * stride + K) * ct * 4
    assert patch + K * K * ct * 4 <= g["smem_bytes"] <= tlc.DW_SMEM_MAX
    assert g["load"] == ("cp.async" if C % 4 == 0 and P == groups
                         else "gather")


@pytest.mark.parametrize("n_sm", [132, 114])
def test_conv_geometry_covers_r_and_fills_the_card(n_sm):
    """`log_conv2d_geometry` at every zoo conv shape (batch 1 and 8) and the
    sweep shapes.  Dense: the shares cover the stages of R exactly, none is
    empty, and the launch has at least one block per SM wherever R allows
    it.  Depthwise: the tiles cover the output and fit the block
    (`_check_depthwise_geometry`), and every MobileNet depthwise conv at
    batch 8 launches at least one block per SM."""
    from repro_torch.models.cnn import zoo_conv_shapes
    seen_split = False
    for (B, H, W, C, K, P, stride, padding, groups) in _geometry_cases():
        g = tlc.log_conv2d_geometry(B, H, W, C, K, P, stride, padding,
                                    groups, n_sm=n_sm)
        cin_g = C // groups
        pads = tlc.normalize_padding(padding, K, stride, H, W)
        Ho = tlc._out_size(H, K, stride, pads[0])
        Wo = tlc._out_size(W, K, stride, pads[1])
        if cin_g == 1:
            _check_depthwise_geometry(g, B, Ho, Wo, C, K, P, stride, groups)
            continue
        assert g["path"] == "dense"
        assert g["load"] == ("cp.async" if cin_g % 16 == 0 else "gather")
        M = B * Ho * Wo
        assert g["m_tiles"] == -(-M // tlc.BM)
        assert g["n_tiles"] == -(-(P // groups) // tlc.BN)
        assert g["tiles"] == g["m_tiles"] * g["n_tiles"] * groups
        assert g["stages"] == -(-K * K * cin_g // tlc.BK)
        sps, splits = g["stages_per_split"], g["splits"]
        assert (splits - 1) * sps < g["stages"] <= splits * sps
        assert g["blocks"] == g["tiles"] * splits
        assert g["blocks"] >= n_sm or splits == g["stages"]
        seen_split |= splits > 1
    assert seen_split
    # ResNet-34's 7x7x512 -> 512 layer at batch 8: 32 tiles, 144 stages
    g = tlc.log_conv2d_geometry(8, 7, 7, 512, 3, 512, n_sm=n_sm)
    assert g["tiles"] == 32 and g["blocks"] >= 2 * n_sm * 0.9
    dw = [r for r in zoo_conv_shapes(batch=8) if r["C"] == r["groups"]]
    assert len(dw) == 9 and all(r["nets"] == ["mobilenet_v1"] for r in dw)
    for r in dw:
        g = tlc.log_conv2d_geometry(*(r[k] for k in (
            "B", "H", "W", "C", "K", "Cout", "stride", "padding", "groups")),
            n_sm=n_sm)
        assert g["blocks"] >= n_sm and g["load"] == "cp.async", (r, g)
    with pytest.raises(ValueError):
        tlc.log_conv2d_geometry(1, 4, 4, 6, 3, 4, groups=4)


def _x_pieces(x, n=3):
    """The dense kernel's split of fp32 x: each bf16 piece rounds what the
    pieces before it left."""
    pieces = []
    for _ in range(n):
        pieces.append(x.to(torch.bfloat16).float())
        x = x - pieces[-1]
    return pieces


def test_three_bf16_pieces_hold_x_exactly():
    """Three pieces sum to x bit for bit over fp32's normal range; two
    leave up to about 2^-17 of x out, which is why the kernel takes three."""
    rng = np.random.default_rng(5)
    x = (rng.uniform(1, 2, 1 << 16) * 2.0 ** rng.integers(-100, 100, 1 << 16)
         * rng.choice([-1, 1], 1 << 16)).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, mid, lo = _x_pieces(xt)
    assert torch.equal((hi + mid) + lo, xt)
    rel = ((xt - (hi + mid)).abs() / xt.abs()).max()
    assert 2.0 ** -19 < float(rel) <= 2.0 ** -16


def _emulate_kernel(x, packed, scale, *, stride, padding, groups):
    """The dense kernel's arithmetic in plain torch: x split into three
    bf16 pieces, the codes into the two bf16 planes of `plane_table`, fp32
    sums of the six products, then ``scale · (acc_e + fp32(√2) · acc_o)``."""
    cfg = tlc.DEFAULT_CFG
    B, H, W, C, K, Cout = tlc._check_shapes(x, packed, groups)
    pads = tlc.normalize_padding(padding, K, stride, H, W)
    tab = tlc.plane_table(cfg, x.device)
    entry = tab[packed.to(torch.int64) & ((2 << cfg.bits) - 1)]
    w_e, w_o = (((entry >> s) & 0xFFFF).to(torch.int16).view(torch.bfloat16)
                .float() for s in (0, 16))
    pieces = _x_pieces(x)

    def conv(a, w):
        return tlc.conv_nhwc(a, w, stride=stride, pads=pads, groups=groups)

    acc_e = sum(conv(p, w_e) for p in pieces)
    acc_o = sum(conv(p, w_o) for p in pieces)
    sqrt2 = torch.tensor(2.0 ** 0.5, dtype=torch.float32)
    return tlc._scale_vector(scale, Cout, x.device) * (acc_e + sqrt2 * acc_o)


@pytest.mark.parametrize("B,H,W,C,K,P,stride,padding,groups",
                         SHAPES + LANE_SHAPES)
def test_kernel_arithmetic_matches_jax_blockwise(B, H, W, C, K, P, stride,
                                                 padding, groups):
    """Two exact planes and a three-piece bf16 split of x, summed in fp32,
    stay within the per-conv tolerance of JAX's `log_conv2d_blockwise`."""
    x, w = _inputs(10, B, H, W, C, K, P, groups)
    x = x * np.float32(3.0) + np.float32(0.1)   # mantissas bf16 cannot hold
    kw = dict(stride=stride, padding=padding, groups=groups)
    qj = jquantize(jnp.asarray(w))
    qt = tquantize(torch.from_numpy(w))
    y_j = np.asarray(jlc.log_conv2d_blockwise(jnp.asarray(x), qj.packed,
                                              qj.scale, **kw))
    y = _emulate_kernel(torch.from_numpy(x), qt.packed, qt.scale, **kw)
    tol = 1e-4 * float(np.abs(y_j).max() + 1)
    assert tuple(y.shape) == y_j.shape
    err = float(np.abs(y.numpy() - y_j).max())
    assert err <= tol, (err, tol)
    # the split is what holds it: bf16 x alone misses the tolerance
    x_hi = torch.from_numpy(x).to(torch.bfloat16).float()
    y_hi = tlc.log_conv2d_blockwise(x_hi, qt.packed, qt.scale, **kw)
    assert float(np.abs(y_hi.numpy() - y_j).max()) > tol


def _emulate_depthwise(x, packed, scale, *, stride, padding, groups,
                      lane=None, n_sm=132):
    """The depthwise kernel's arithmetic in plain torch, block by block as
    `log_conv2d_geometry` tiles the output: each block's input patch, zero
    outside the image and past the last channel (output channel o reads
    input channel o // cout_g), the codes read at the kernel's addresses in
    either layout and decoded once, then per output fp32 fmaf over (kh, kw)
    in row-major order from 0 and the scale.  An fmaf is emulated as the
    exact fp64 product plus the sum, rounded to fp32.  Outputs no tile
    covers stay NaN."""
    B, H, W, C = x.shape
    if lane is None:
        K, Cout = packed.shape[0], packed.shape[3]
    else:
        n_sb, taps, L, cout_lane = packed.shape
        K, Cout = int(round(taps ** 0.5)), groups * cout_lane
    cout_g = Cout // groups
    if lane is None:
        g_b, w_sb, w_gl, w_tap = 1, cout_g, 0, Cout
    else:
        g_b, cin_lane = lane
        w_sb, w_gl, w_tap = K * K * L * cout_g, cin_lane * cout_g, L * cout_g
    pads = tlc.normalize_padding(padding, K, stride, H, W)
    Ho = tlc._out_size(H, K, stride, pads[0])
    Wo = tlc._out_size(W, K, stride, pads[1])
    geo = tlc.log_conv2d_geometry(B, H, W, C, K, Cout, stride, pads, groups,
                                  n_sm=n_sm)
    th, tw, ct = geo["tile"]
    o = torch.arange(Cout)
    grp = o // cout_g
    base = (grp // g_b) * w_sb + (grp % g_b) * w_gl + (o - grp * cout_g)
    codes = packed.reshape(-1)[base[None, :]
                               + torch.arange(K * K)[:, None] * w_tap]
    dec = tlc.decode_codes(codes).double()            # [K*K, Cout]
    scale = tlc._scale_vector(scale, Cout, x.device)
    y = torch.full((B, Ho, Wo, Cout), float("nan"))
    pr, pc = (th - 1) * stride + K, (tw - 1) * stride + K
    for b in range(B):
        for tc in range(geo["tiles_c"]):
            oc = torch.arange(tc * ct, (tc + 1) * ct)
            c_ok = oc < Cout
            oc = oc.clamp(max=Cout - 1)
            wd = torch.where(c_ok, dec[:, oc], 0.0)
            for t_h in range(geo["tiles_h"]):
                for t_w in range(geo["tiles_w"]):
                    ho0, wo0 = t_h * th, t_w * tw
                    hi = ho0 * stride - pads[0][0] + torch.arange(pr)
                    wi = wo0 * stride - pads[1][0] + torch.arange(pc)
                    ok = (((hi >= 0) & (hi < H))[:, None, None]
                          & ((wi >= 0) & (wi < W))[None, :, None]
                          & c_ok[None, None, :])
                    patch = x[b][hi.clamp(0, H - 1)][:, wi.clamp(0, W - 1)]
                    patch = torch.where(ok, patch[:, :, oc // cout_g], 0.0)
                    acc = torch.zeros((th, tw, ct), dtype=torch.float32)
                    for kh in range(K):
                        for kw in range(K):
                            xs = patch[kh:kh + (th - 1) * stride + 1:stride,
                                       kw:kw + (tw - 1) * stride + 1:stride]
                            acc = (xs.double() * wd[kh * K + kw]
                                   + acc.double()).float()
                    out = acc * torch.where(c_ok, scale[oc], 0.0)
                    nh, nw = min(th, Ho - ho0), min(tw, Wo - wo0)
                    nc = int(c_ok.sum())
                    y[b, ho0:ho0 + nh, wo0:wo0 + nw, tc * ct:tc * ct + nc] = \
                        out[:nh, :nw, :nc]
    return y


DW_CASES = [s for s in SHAPES + LANE_SHAPES if s[3] == s[8]] + DW_SHAPES


@pytest.mark.parametrize("B,H,W,C,K,P,stride,padding,groups", DW_CASES)
def test_depthwise_kernel_arithmetic_matches_jax_blockwise(
        B, H, W, C, K, P, stride, padding, groups):
    """The depthwise kernel's tiles, zero-filled halo and (kh, kw) order,
    emulated at the card's tiles (132 SMs) and at the largest tiles
    (1 SM), in natural and lane-packed codes, stay within the per-conv
    tolerance of JAX's `log_conv2d_blockwise`; the two layouts give the
    same bits."""
    x, w = _inputs(11, B, H, W, C, K, P, groups)
    kw = dict(stride=stride, padding=padding, groups=groups)
    qj = jquantize(jnp.asarray(w))
    qt = tquantize(torch.from_numpy(w))
    y_j = np.asarray(jlc.log_conv2d_blockwise(jnp.asarray(x), qj.packed,
                                              qj.scale, **kw))
    tol = 1e-4 * float(np.abs(y_j).max() + 1)
    lp = tlc.lane_pack_geometry(groups, 1)
    lane_codes = tlc.lane_pack_codes(qt.packed, groups, lp["g_b"],
                                     lp["cin_lane"])
    xt = torch.from_numpy(x)
    for n_sm in (132, 1):
        y = _emulate_depthwise(xt, qt.packed, qt.scale, n_sm=n_sm, **kw)
        assert tuple(y.shape) == y_j.shape
        assert bool(torch.isfinite(y).all()), "a tile left outputs unwritten"
        err = float(np.abs(y.numpy() - y_j).max())
        assert err <= tol, (n_sm, err, tol)
        y_lane = _emulate_depthwise(xt, lane_codes, qt.scale, n_sm=n_sm,
                                    lane=(lp["g_b"], lp["cin_lane"]), **kw)
        assert torch.equal(y.view(torch.int32), y_lane.view(torch.int32))


def test_resolve_impl_follows_the_tensor_device():
    assert tops.resolve_impl("conv2d", "auto", torch.device("cpu")) == \
        "blockwise"
    # the device decides; no card is needed to resolve "cuda"
    assert tops.resolve_impl("conv2d", "auto", torch.device("cuda")) == "cuda"
    assert tops.resolve_impl("conv2d", "ref", torch.device("cuda")) == "ref"
    with pytest.raises(ValueError, match="unknown conv2d impl"):
        tops.resolve_impl("conv2d", "pallas", torch.device("cpu"))
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="unknown conv2d impl"):
        tops.conv2d(x, torch.zeros(3, 3, 2, 2), impl="pallas_im2col")


def test_kernel_wrapper_validates_inputs():
    x, w = _inputs(2, 1, 6, 6, 4, 3, 4, 1)
    qt = tquantize(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="fp32"):
        tlc.log_conv2d_fused(xt.double(), qt.packed, qt.scale)
    with pytest.raises(ValueError, match="fp32"):
        tlc.log_conv2d_fused(xt.transpose(1, 2), qt.packed, qt.scale)
    with pytest.raises(ValueError, match="int8"):
        tlc.log_conv2d_fused(xt, qt.packed.to(torch.int32), qt.scale)
    with pytest.raises(ValueError, match="groups"):
        tlc.log_conv2d_fused(xt, qt.packed, qt.scale, groups=3)
    with pytest.raises(ValueError, match="lane-packed"):
        tlc.log_conv2d_fused(xt, qt.packed, qt.scale, lane=(2, 4))
    # a CPU tensor runs the plain version and launches nothing
    before = tlc.log_conv2d_fused.launches
    y = tlc.log_conv2d_fused(xt, qt.packed, qt.scale)
    assert tlc.log_conv2d_fused.launches == before
    np.testing.assert_array_equal(
        y.numpy(), tlc.log_conv2d_blockwise(xt, qt.packed, qt.scale).numpy())


def test_lane_layout_precedence(monkeypatch):
    """`ops.conv2d`'s lane-layout precedence (the JAX `ops.py:249-271`
    contract): a baked ``lane_packed`` layout rides onto the kernel as
    stored when the call matches it; an explicit conflicting `lane_pack`,
    other groups or a plain impl unpack it to HWIO first."""
    C = 12
    rng = np.random.default_rng(7)
    w = rng.normal(size=(3, 3, 1, C)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, C)).astype(np.float32))
    qp = quantize_cnn_params({"conv": {"w": torch.from_numpy(w),
                                       "b": torch.zeros(C)}},
                             conv_layout="lane_packed")
    qt_lp = qp["conv"]["w"]
    assert qt_lp.layout == "lane_packed"
    g_b, cin_lane, meta_groups = qt_lp.layout_meta
    assert meta_groups == C and g_b > 1
    qt = tquantize(torch.from_numpy(w))
    np.testing.assert_array_equal(qt_lp.dequantize(torch.float32).numpy(),
                                  qt.dequantize(torch.float32).numpy())

    seen = []
    wrapper = tlc.log_conv2d_fused

    def spy(x, packed, scale, cfg, *, lane=None, **kw):
        seen.append((tuple(packed.shape), lane))
        return wrapper(x, packed, scale, cfg, lane=lane, **kw)

    monkeypatch.setattr(tops, "log_conv2d_fused", spy)
    y_pre = tops.conv2d(x, qt_lp, impl="cuda", groups=C)
    y_fly = tops.conv2d(x, qt, impl="cuda", groups=C)
    y_off = tops.conv2d(x, qt_lp, impl="cuda", groups=C,
                        config=tops.ConvConfig(lane_pack=1))
    y_same = tops.conv2d(x, qt_lp, impl="cuda", groups=C,
                         config={"lane_pack": g_b})
    assert seen == [(tuple(qt_lp.packed.shape), (g_b, cin_lane)),
                    ((3, 3, 1, C), None), ((3, 3, 1, C), None),
                    (tuple(qt_lp.packed.shape), (g_b, cin_lane))]
    for y in (y_fly, y_off, y_same):
        np.testing.assert_array_equal(y_pre.numpy(), y.numpy())
    # a plain impl unpacks: bit-identical to the natural layout
    y_bw = tops.conv2d(x, qt, impl="blockwise", groups=C)
    np.testing.assert_array_equal(
        tops.conv2d(x, qt_lp, impl="blockwise", groups=C).numpy(),
        y_bw.numpy())
    # and the whole thing agrees with the JAX package's prepacked path
    qj = jquantize(jnp.asarray(w))
    y_j = np.asarray(jops.conv2d(jnp.asarray(x.numpy()), qj, impl="pallas",
                                 interpret=True, groups=C))
    np.testing.assert_allclose(y_pre.numpy(), y_j,
                               atol=1e-4 * float(np.abs(y_j).max() + 1))
    # non-depthwise leaves fall back to conv_taps
    qp2 = quantize_cnn_params({"c": {"w": torch.from_numpy(
        rng.normal(size=(3, 3, 4, 8)).astype(np.float32))}},
        conv_layout="lane_packed")
    assert qp2["c"]["w"].layout == "conv_taps"


def test_conv2d_accepts_unpacked_weights():
    x, w = _inputs(8, 1, 6, 6, 3, 3, 4, 1)
    xt = torch.from_numpy(x)
    y1 = tops.conv2d(xt, torch.from_numpy(w), impl="blockwise")
    y2 = tops.conv2d(xt, tquantize(torch.from_numpy(w)), impl="blockwise")
    np.testing.assert_array_equal(y1.numpy(), y2.numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# R on either side of a share boundary of `log_conv2d_geometry` (one tile:
# R = 8432 gives 264 shares of one stage of 32, R = 8464 gives 133 shares of
# two), a gathered R, a half stage in the last share, grouped and ragged-N
SPLIT_SHAPES = [
    (1, 4, 4, 8432, 1, 64, 1, "VALID", 1),
    (1, 4, 4, 8464, 1, 64, 1, "VALID", 1),
    (1, 4, 4, 8440, 1, 64, 1, "VALID", 1),
    (1, 4, 4, 48, 1, 64, 1, "VALID", 1),
    (1, 6, 6, 64, 3, 64, 1, "SAME", 2),
    (2, 5, 5, 96, 3, 72, 2, "SAME", 1),
]


def test_split_shapes_cross_share_boundaries():
    """The split shapes the card test runs do split R, on both sides of a
    share boundary, on both load paths."""
    geos = [tlc.log_conv2d_geometry(B, H, W, C, K, P, s, pad, g)
            for (B, H, W, C, K, P, s, pad, g) in SPLIT_SHAPES]
    assert all(g["splits"] > 1 for g in geos)
    assert [g["stages_per_split"] for g in geos[:2]] == [1, 2]
    assert {g["load"] for g in geos} == {"cp.async", "gather"}


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_versions(cuda_device):
    """The hand-written kernel against `log_conv2d_ref` and
    `log_conv2d_blockwise` on the card, in natural and lane-packed layouts,
    split-K and the depthwise tile edges included; each call made twice
    gives the same bits.  Plus the bit-exact decode of all 128 codes on the
    depthwise path and both dense load paths, and the depthwise gather on x
    4 bytes past a 16-byte boundary, bit for bit against the cp.async load
    of the same x."""
    dev = cuda_device
    codes = torch.arange(128, dtype=torch.int8, device=dev)
    want = tlc.decode_codes(codes).view(torch.int32)
    ones = torch.ones(128, device=dev)
    for cin in (1, 2, 16):   # depthwise, dense gather, dense cp.async
        x = torch.zeros((1, 1, 1, cin), device=dev)
        x[..., cin - 1] = 1.0
        w = torch.stack([codes.roll(j) for j in range(cin - 1, -1, -1)])
        y = tlc.log_conv2d_fused(x, w.reshape(1, 1, cin, 128).contiguous(),
                                 ones, padding="VALID")
        assert torch.equal(y.reshape(-1).view(torch.int32), want), cin
    x, w = _inputs(12, 2, 9, 10, 8, 3, 8, 8)
    qt = tquantize(torch.from_numpy(w).to(dev))
    xt = torch.from_numpy(x).to(dev)
    x_off = torch.empty(x.size + 1, device=dev)[1:].view(x.shape)
    x_off.copy_(xt)
    assert x_off.data_ptr() % 16 == 4
    y_al = tlc.log_conv2d_fused(xt, qt.packed, qt.scale, groups=8)
    y_off = tlc.log_conv2d_fused(x_off, qt.packed, qt.scale, groups=8)
    assert torch.equal(y_al.view(torch.int32), y_off.view(torch.int32))
    y_ref = tlc.log_conv2d_ref(xt, qt.packed, qt.scale, groups=8)
    assert float((y_al - y_ref).abs().max()) <= \
        1e-4 * (float(y_ref.abs().max()) + 1)
    for (B, H, W, C, K, P, stride, padding, groups) in (
            SHAPES + LANE_SHAPES + SPLIT_SHAPES + DW_SHAPES):
        x, w = _inputs(9, B, H, W, C, K, P, groups)
        xt = torch.from_numpy(x).to(dev)
        qt = tquantize(torch.from_numpy(w).to(dev))
        kw = dict(stride=stride, padding=padding, groups=groups)
        y_ref = tlc.log_conv2d_ref(xt, qt.packed, qt.scale, **kw)
        tol = 1e-4 * (float(y_ref.abs().max()) + 1)
        before = tlc.log_conv2d_fused.launches
        outs = [tlc.log_conv2d_fused(xt, qt.packed, qt.scale, **kw),
                tlc.log_conv2d_fused(xt, qt.packed, qt.scale, **kw),
                tops.conv2d(xt, _lane_qt(qt, groups), impl="cuda", **kw)
                if groups > 1 else None]
        torch.cuda.synchronize()
        assert tlc.log_conv2d_fused.launches == before + 2 + (groups > 1)
        assert torch.equal(outs[0].view(torch.int32),
                           outs[1].view(torch.int32))
        y_bw = tlc.log_conv2d_blockwise(xt, qt.packed, qt.scale, **kw)
        for y in filter(lambda t: t is not None, outs):
            assert float((y - y_ref).abs().max()) <= tol
            assert float((y - y_bw).abs().max()) <= tol
