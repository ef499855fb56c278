"""ConvNeXt-T in the port's CNN path (`repro_torch.models.cnn`), which the
JAX package does not have: held against a float forward written here from
the published plan (Liu et al., arXiv:2201.03545, section 2 and Fig. 4),
its packed path against the plain ``conv_impl="ref"``, the spans and
counters of one forward, and the registry split.  The tests marked
``cuda`` run on the card only: the signed requantization kernel on every
`log_q` input of a full-width forward, and the conv kernel at ConvNeXt-T's
conv shapes."""

import contextlib
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
import torch.nn.functional as F  # noqa: E402

from repro_torch.core import logquant as tlq  # noqa: E402
from repro_torch.kernels import log_requant as lr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.obs.metrics import REGISTRY  # noqa: E402
from repro_torch.serving.quantize import quantize_cnn_params  # noqa: E402

DEPTHS, DIMS = [3, 3, 9, 3], [96, 192, 384, 768]
IMG, WIDTH = 32, 0.125


def _params(seed=1, width_mult=WIDTH, device="cpu"):
    """Random weights, with LayerNorm scales and shifts and layer scales
    drawn away from their inits (g = 1, b = 0, gamma = 1e-6), so that each
    of them moves the result."""
    params, _ = tcnn.make_cnn("convnext_t", seed, n_classes=10,
                              width_mult=width_mult, device=device)
    gen = torch.Generator().manual_seed(seed + 100)

    def draw(t, mean, std):
        return (mean + std * torch.randn(t.shape, generator=gen)).to(device)

    def visit(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                visit(v)
            elif isinstance(v, list):
                for blk in v:
                    visit(blk)
            elif k == "gamma":
                tree[k] = draw(v, 0.5, 0.1)
            elif k == "g":
                tree[k] = draw(v, 1.0, 0.1)
            elif k == "b" and "g" in tree:
                tree[k] = draw(v, 0.0, 0.05)
    visit(params)
    return params


def _images(seed=2, batch=2, img=IMG):
    return torch.randn((batch, img, img, 3),
                       generator=torch.Generator().manual_seed(seed))


def _plan_forward(p, x):
    """ConvNeXt-T in float32 from the published plan, NCHW convs with the
    published padding (3 on the 7x7 depthwise convs, none elsewhere)."""
    def conv(c, x, stride=1, pad=0, groups=1):
        y = F.conv2d(x.permute(0, 3, 1, 2), c["w"].permute(3, 2, 0, 1),
                     stride=stride, padding=pad, groups=groups)
        return y.permute(0, 2, 3, 1) + c["b"]

    def ln(n, x):
        return F.layer_norm(x, x.shape[-1:], n["g"], n["b"], 1e-6)

    x = ln(p["stem_norm"], conv(p["stem"], x, stride=4))
    for s, stage in enumerate(p["stages"]):
        if s > 0:
            x = conv(stage["down"], ln(stage["down_norm"], x), stride=2)
        for blk in stage["blocks"]:
            h = ln(blk["norm"], conv(blk["dw"], x, pad=3, groups=x.shape[-1]))
            h = conv(blk["pw2"], F.gelu(conv(blk["pw1"], h),
                                        approximate="none"))
            x = x + blk["gamma"] * h
    return ln(p["head_norm"], x.mean(dim=(1, 2))) @ p["head"]["w"] \
        + p["head"]["b"]


def test_init_follows_the_published_shapes_and_inits():
    params, _ = tcnn.make_cnn("convnext_t", 0, device="meta")
    assert [len(s["blocks"]) for s in params["stages"]] == DEPTHS
    assert [s["blocks"][0]["dw"]["w"].shape for s in params["stages"]] == [
        (7, 7, 1, d) for d in DIMS]
    assert params["stem"]["w"].shape == (4, 4, 3, 96)
    assert [s["down"]["w"].shape for s in params["stages"][1:]] == [
        (2, 2, 96, 192), (2, 2, 192, 384), (2, 2, 384, 768)]
    blk = params["stages"][2]["blocks"][0]
    assert blk["pw1"]["w"].shape == (1, 1, 384, 1536)
    assert blk["pw2"]["w"].shape == (1, 1, 1536, 384)
    assert params["head"]["w"].shape == (768, 1000)
    small, _ = tcnn.make_cnn("convnext_t", 0, width_mult=WIDTH, device="cpu")
    assert [s["blocks"][0]["gamma"].numel() for s in small["stages"]] == [
        12, 24, 48, 96]
    assert float(small["stages"][0]["blocks"][0]["gamma"][0]) == \
        pytest.approx(tcnn.LAYER_SCALE_INIT)
    assert torch.equal(small["stem_norm"]["g"], torch.ones(12))


def test_float_forward_matches_the_plan():
    p, x = _params(), _images()
    with torch.no_grad():
        got = tcnn.convnext_t_apply(p, x)
        want = _plan_forward(p, x)
    assert got.shape == (2, 10)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_packed_path_matches_the_plain_ref_and_the_fake_quant_path():
    """``quant="logq6"``: codes packed at load as the benchmark packs them
    (``lane_packed``) through the kernel route (plain on the CPU) against
    ``conv_impl="ref"`` on the same codes and against the fake-quant float
    convs of the QAT path; tolerance `test_cnn.py:106`'s."""
    p, x = _params(), _images()
    packed = quantize_cnn_params(p, conv_layout="lane_packed")
    apply = functools.partial(tcnn.convnext_t_apply, quant="logq6")
    with torch.no_grad():
        ref = apply(packed, x, conv_impl="ref")
        outs = {"cuda route": apply(packed, x, conv_impl="cuda"),
                "fake quant": apply(p, x)}
    tol = 1e-3 * (float(ref.abs().max()) + 1)
    for route, y in outs.items():
        torch.testing.assert_close(y, ref, rtol=0, atol=tol, msg=route)
    with torch.no_grad():   # the requantization does work here
        assert not torch.allclose(apply(packed, x, conv_impl="ref"),
                                  tcnn.convnext_t_apply(p, x), atol=tol)


@contextlib.contextmanager
def _span_counts(monkeypatch):
    counts, span = {}, tcnn.trace.span

    def counting(name, **args):
        counts[name] = counts.get(name, 0) + 1
        return span(name, **args)
    monkeypatch.setattr(tcnn.trace, "span", counting)
    yield counts
    monkeypatch.setattr(tcnn.trace, "span", span)


def _signed(path):
    return REGISTRY.counter("requant_signed_calls", path=path).value


def _relu(path):
    return REGISTRY.counter("requant_calls", path=path).value


def test_spans_and_counters_of_one_forward(monkeypatch):
    """One packed forward: the spans of each new layer kind, and every
    requantization signed, on the plain path here (a CPU tensor)."""
    p, x = _params(), _images()
    packed = quantize_cnn_params(p, conv_layout="lane_packed")
    before = [_signed("plain"), _signed("cuda"), _relu("plain"),
              _relu("cuda")]
    with torch.no_grad(), _span_counts(monkeypatch) as counts:
        tcnn.convnext_t_apply(packed, x, quant="logq6", conv_impl="ref")
    assert {k: counts[k] for k in ("cnn.norm", "cnn.act", "cnn.dwconv",
                                   "cnn.requant", "cnn.shortcut")} == {
        "cnn.norm": 23, "cnn.act": 18, "cnn.dwconv": 18, "cnn.requant": 61,
        "cnn.shortcut": 18}
    assert counts["cnn.conv"] == 40 and counts["cnn.forward"] == 1
    after = [_signed("plain"), _signed("cuda"), _relu("plain"),
             _relu("cuda")]
    assert [a - b for a, b in zip(after, before)] == [61, 0, 0, 0]


def test_registry_split():
    """The zoo is the paper's four nets, which the JAX package mirrors;
    ConvNeXt-T is registered beside them, and the zoo's shape walk (the
    autotune tables' source) leaves it out."""
    assert sorted(tcnn.CNN_ZOO) == ["mobilenet_v1", "resnet34", "squeezenet",
                                    "vgg16"]
    assert tcnn.CNNS == {**tcnn.CNN_ZOO, "convnext_t": (
        tcnn.convnext_t_init, tcnn.convnext_t_apply)}
    assert all("convnext_t" not in r["nets"] for r in tcnn.zoo_conv_shapes())
    recs = tcnn.trace_conv_shapes("convnext_t", batch=128)
    assert len(recs) == 58
    dw = [r for r in recs if r["groups"] > 1]
    assert len(dw) == 18 and {(r["K"], r["groups"]) for r in dw} == {
        (7, d) for d in DIMS}
    assert (recs[0]["K"], recs[0]["stride"], recs[0]["C"]) == (4, 4, 3)
    assert sorted(r["C"] for r in recs if r["K"] == 2) == DIMS[:3]
    assert max(r["C"] for r in recs if r["K"] == 1) == 3072


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
def test_signed_requant_on_every_log_q_input_on_card(cuda_device,
                                                     monkeypatch):
    """A full-width packed forward at 224 px: all 61 requantizations take
    the signed kernel (two launches each, none plain), and each of their
    inputs (C from 96 to 3,072) gives `fake_log_quant`'s values and codes
    bit for bit.  Beside them an odd C, a map 4 bytes past a 16-byte
    boundary (the one-channel loads), and a view that is not contiguous,
    which `log_q` leaves to the plain ops."""
    dev = cuda_device
    p = _params(seed=3, width_mult=1.0, device=dev)
    packed = quantize_cnn_params(p, conv_layout="lane_packed")
    x = _images(4, 2, 224).to(dev)
    seen, log_q = [], tcnn.log_q

    def spy(xin, quant=None, qcfg=tlq.DEFAULT):
        seen.append(xin.clone())
        return log_q(xin, quant, qcfg)
    monkeypatch.setattr(tcnn, "log_q", spy)
    before = (_signed("cuda"), _signed("plain"), lr.log_requant_cuda.launches)
    with torch.no_grad():
        tcnn.convnext_t_apply(packed, x, quant="logq6", conv_impl="auto")
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(
        (_signed("cuda"), _signed("plain"), lr.log_requant_cuda.launches),
        before)]
    monkeypatch.setattr(tcnn, "log_q", log_q)
    assert len(seen) == 61 and moved == [61, 0, 122]
    assert {t.shape[-1] for t in seen} == set(DIMS) | {1536, 3072}
    odd = torch.randn((2, 7, 7, 97), device=dev) * 3
    off = torch.empty(odd.numel() + 1, device=dev)[1:].view(odd.shape)
    off.copy_(odd)
    assert off.data_ptr() % 16 == 4
    for t in seen + [odd, off]:
        want, want_codes = tlq.fake_log_quant(t), tlq.log_quantize(t)[0]
        y, codes = lr.log_requant_cuda(t, codes=True, relu=False)
        assert torch.equal(_bits(y), _bits(want)), tuple(t.shape)
        assert torch.equal(codes, want_codes), tuple(t.shape)
    view = seen[0].transpose(1, 2)
    assert not lr.kernel_takes(view)
    plain = _signed("plain")
    y = tcnn.log_q(view, "logq6")
    assert _signed("plain") == plain + 1
    assert torch.equal(_bits(y), _bits(tlq.fake_log_quant(view)))
    assert int(lr._workspace(dev).abs().sum()) == 0


@pytest.mark.cuda
def test_conv_kernel_at_convnext_shapes_on_card(cuda_device):
    """Each distinct conv of ConvNeXt-T at 224 px, batch 2, through
    `ops.conv2d` ``impl="auto"`` on lane-packed codes (the 7x7 depthwise
    convs, the 4x4/4 stem on three channels, the 2x2/2 convs down, the 1x1
    convs with 96 to 3,072 input channels) against ``impl="ref"``, within
    the benchmark's conv_gap limit of 1e-4 of the largest output."""
    dev = cuda_device
    shapes = {(r["H"], r["C"], r["K"], r["Cout"], r["stride"], r["groups"])
              for r in tcnn.trace_conv_shapes("convnext_t", batch=2)}
    assert len(shapes) == 16
    gen = torch.Generator().manual_seed(5)
    for H, C, K, Cout, stride, groups in sorted(shapes):
        w = torch.randn((K, K, C // groups, Cout), generator=gen) \
            * (2.0 / (K * K * C // groups)) ** 0.5
        qt = quantize_cnn_params({"w": w.to(dev)},
                                 conv_layout="lane_packed")["w"]
        x = torch.randn((2, H, H, C), generator=gen).to(dev)
        kw = dict(stride=stride, groups=groups)
        with torch.no_grad():
            y = tops.conv2d(x, qt, impl="auto", **kw)
            y_ref = tops.conv2d(x, qt, impl="ref", **kw)
        torch.cuda.synchronize()
        gap = float((y - y_ref).abs().max() / y_ref.abs().max())
        assert gap <= 1e-4, ((H, C, K, Cout, stride, groups), gap)
