"""ConvNeXt-T in the benchmark: its plan (`reference/families/convnext.py`)
against the program, whole runs of its cell at 32 px on the CPU (the
harness's look for a card skipped), the control and planted faults, the
weights' draw, and the readers of its per-layer metrics on a hand-built
trace."""

import json
import math
import time

import pytest
import torch
import torch.nn.functional as F

import control
import costs
import harness
import program
import requant_maps
import traced
from conftest import BENCH
from reference import check
from reference import cnn as ref_cnn

CELL = "convnext_t.offline128"
SEED = 2 ** 31 + 4243
CPU = torch.device("cpu")
DIMS = [96, 192, 384, 768]


def _config():
    return json.loads((BENCH / "configs" / "convnext_t.json").read_text())


def _run(cell):
    return harness.run_cell(cell, SEED, 0.3, False, CPU, time.perf_counter())


def test_sound_run_is_correct(tiny_cell):
    cell = tiny_cell(CELL)
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert {m for m in r["metrics"]} == {m["name"] for m in cell.end_to_end}


def test_reference_follows_the_plain_versions(tiny_cell):
    """Stage by stage against the port's plain ``conv_impl="ref"``."""
    cell = tiny_cell(CELL)
    gen = torch.Generator().manual_seed(SEED)
    weights = harness.draw_weights(cell.config, gen, CPU)
    x = torch.randn((2, 32, 32, 3), generator=gen)
    prog = program.Program(cell.config, weights)
    rec = {}
    with prog.capture(rec), torch.no_grad():
        logits = prog.apply(prog.packed, x, quant="logq6", qcfg=prog.qcfg,
                            conv_impl="ref")
    got = check.compare(cell.config, weights, x, rec, logits)
    assert len(rec) == len(costs.conv_shapes(cell.config, 2)) == 58
    assert got["conv_gap"] < 1e-5 and got["logit_gap"] < 1e-5
    assert got["act_mismatch"] == 0.0


@pytest.mark.parametrize("precision", ["control", "tf32", "bf16_quant"])
def test_control_is_not_correct(tiny_cell, precision):
    r = control.readings(tiny_cell(CELL), [SEED], 0.3, CPU,
                         check.PRECISIONS[precision])
    assert r[0]["correct"] is False, r


def _plant(monkeypatch, fault):
    """A fault in the program's forward, the same in every forward."""
    from repro_torch.models import cnn
    if fault == "norm_left_out":   # stage 0 block 1's LayerNorm
        norm, calls = cnn.layer_norm, [0]

        def layer_norm(p, x, eps=1e-6):
            calls[0] += 1
            return x if calls[0] % 23 == 3 else norm(p, x, eps)
        monkeypatch.setattr(cnn, "layer_norm", layer_norm)
    elif fault == "gelu_tanh":
        monkeypatch.setattr(cnn, "gelu",
                            lambda x: F.gelu(x, approximate="tanh"))
    elif fault == "gamma_dropped":   # stage 1 block 0: x + h
        init = program.Program.__init__

        def dropped(self, config, weights):
            init(self, config, weights)
            blk = self.packed["stages"][1]["blocks"][0]
            blk["gamma"] = torch.ones_like(blk["gamma"])
        monkeypatch.setattr(program.Program, "__init__", dropped)
    else:   # the ReLU requantization where the signed one belongs
        monkeypatch.setattr(cnn, "log_q", cnn.relu_q)


@pytest.mark.parametrize("fault", ["norm_left_out", "gelu_tanh",
                                   "gamma_dropped", "relu_requant"])
def test_fault_is_not_correct(tiny_cell, monkeypatch, fault):
    cell = tiny_cell(CELL)
    _plant(monkeypatch, fault)
    r = _run(cell)
    assert r["correct"] is False, r["checks"]


def test_plan_shapes_are_the_programs():
    cfg = _config()
    shapes = costs.conv_shapes(cfg, 8)
    assert len(shapes) == 58
    assert program.conv_shapes(cfg, 8) == sorted(
        (c["B"], c["H"], c["W"], c["C"], c["K"], c["Cout"], c["stride"],
         c["groups"]) for c in shapes)
    dw = [c for c in shapes if c["groups"] > 1]
    assert [c["groups"] for c in dw] == [96] * 3 + [192] * 3 + [384] * 9 \
        + [768] * 3
    assert all(c["K"] == 7 and c["C"] == c["Cout"] == c["groups"] for c in dw)
    assert costs.model_flops_per_image(cfg) == 8911062528
    assert sum(math.prod(s) for s in ref_cnn.weight_shapes(cfg).values()) \
        == 28589128


def test_drawn_norm_and_layer_scales_have_the_configured_means():
    cfg = _config()
    w = harness.draw_weights(cfg, torch.Generator().manual_seed(SEED), CPU)
    g = torch.cat([v for k, v in w.items() if k.endswith(".g")])
    gamma = torch.cat([v for k, v in w.items() if k.endswith(".gamma")])
    assert g.numel() == 96 + (96 + 192 + 384) \
        + (3 * 96 + 3 * 192 + 9 * 384 + 3 * 768) + 768
    assert float(g.mean()) == pytest.approx(1.0, abs=0.01)
    assert float(g.std()) == pytest.approx(0.1, rel=0.05)
    assert float(gamma.mean()) == pytest.approx(0.5, abs=0.01)
    assert float(gamma.std()) == pytest.approx(0.1, rel=0.05)
    assert float(w["stem_norm.b"].std()) == pytest.approx(harness.BIAS_STD,
                                                          rel=0.3)
    assert float(w["stages.2.blocks.4.dw.w"].std()) == pytest.approx(
        (2 / 49) ** 0.5, rel=0.05)


def _next_conv(cfg):
    """Each block's prefix and the conv that next reads the residual
    stream it leaves (None after the last block)."""
    names = [n for n, *_ in ref_cnn.conv_layers(cfg)]
    out = []
    for i, n in enumerate(names):
        if n.endswith(".pw2"):
            out.append((n[:-len(".pw2")],
                        names[i + 1] if i + 1 < len(names) else None))
    return out


def test_each_block_branch_is_visible_to_the_check():
    """With one block's branch zeroed (gamma = 0), the input of the next
    conv differs from the sound one in more than 10 % of its elements, so
    ``act_mismatch`` sees each branch; after the last block, the logits
    move."""
    cfg = _config()
    cfg["image_size"] = 32
    gen = torch.Generator().manual_seed(SEED)
    w = harness.draw_weights(cfg, gen, CPU)
    x = torch.randn((2, 32, 32, 3), generator=gen)
    sound = {}
    logits = check.reference_forward(cfg, w, x, record=sound)
    blocks = _next_conv(cfg)
    assert len(blocks) == 18
    for pre, nxt in blocks:
        zeroed, rec = dict(w), {}
        zeroed[pre + ".gamma"] = torch.zeros_like(w[pre + ".gamma"])
        out = check.reference_forward(cfg, zeroed, x, record=rec)
        if nxt is None:
            assert check.gap(out, logits) > 0.01, pre
            continue
        close = torch.isclose(rec[nxt][0], sound[nxt][0], rtol=check.ACT_RTOL,
                              atol=0.0)
        assert float((~close).float().mean()) > 0.10, (pre, nxt)


# ---------------------------------------------------------------------------
# the per-layer metrics' readers
# ---------------------------------------------------------------------------

def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1}


def _launch(span, ts, kernel, kts, dur):
    return [_ev("user_annotation", span, ts, 8),
            _ev("cuda_runtime", "cudaLaunchKernel", ts + 1, 2),
            _ev("kernel", kernel, kts, dur)]


# one query of a forward: a depthwise conv (10 µs) and its bias (2 µs), a
# LayerNorm (5), a GELU (3), two requantization passes (4 and 6)
WINDOW = [
    _ev("user_annotation", "bench.window", 0, 400),
    _ev("cuda_runtime", "cudaMemcpyAsync", 2, 3),
    _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 20, 4),
    _ev("user_annotation", "cnn.forward", 10, 200),
    _ev("user_annotation", "cnn.dwconv", 11, 20),
    _ev("cuda_runtime", "cudaLaunchKernel", 12, 2),
    _ev("kernel", "log_conv2d_depthwise_kernel", 30, 10),
    _ev("cuda_runtime", "cudaLaunchKernel", 15, 2),
    _ev("kernel", "elementwise add", 41, 2),
    *_launch("cnn.norm", 40, "layer_norm_kernel", 50, 5),
    *_launch("cnn.act", 60, "gelu_kernel", 60, 3),
    _ev("user_annotation", "cnn.requant", 80, 20),
    _ev("cuda_runtime", "cudaLaunchKernel", 81, 2),
    _ev("kernel", "requant_max", 85, 4),
    _ev("cuda_runtime", "cudaLaunchKernel", 84, 2),
    _ev("kernel", "requant_quantize", 90, 6),
    _ev("cuda_runtime", "cudaMemcpyAsync", 205, 3),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 220, 1),
]


def _reader(name):
    return harness._module("layer_metrics", name).read


def test_new_layer_metrics_read_their_spans(tiny_cell):
    cell = tiny_cell(CELL)

    class Run:
        trace = traced.Traced(WINDOW, queries=1, images=2, b1_launches=1)
        convs = costs.conv_shapes(cell.config, 2)
        config, traffic = cell.config, cell.traffic
    assert _reader("norm_device_ms")(Run) == pytest.approx(5e-3)
    assert _reader("act_device_ms")(Run) == pytest.approx(3e-3)
    bound = sum(costs.conv_bound_s(c) for c in Run.convs if c["groups"] > 1)
    assert bound > 0
    assert _reader("dw_roofline")(Run) == pytest.approx(100 * bound / 12e-6)
    n = requant_maps.requant_elements(cell.config, 2)
    assert n == 2 * sum(  # the 61 maps of one 32 px image
        e for e in [8 * 8 * 96] + [8 * 8 * 96, 4 * 4 * 192]
        + [4 * 4 * 192, 2 * 2 * 384] + [2 * 2 * 384, 1 * 1 * 768]
        + [8 * 8 * 96 * 6] * 3 + [4 * 4 * 192 * 6] * 3
        + [2 * 2 * 384 * 6] * 9 + [1 * 1 * 768 * 6] * 3)
    assert _reader("requant_roofline")(Run) == pytest.approx(
        100 * 12 * n / costs.HBM_BYTES_PER_S / 10e-6)

    class Bare(Run):   # no ConvNeXt spans: a program that lacks them
        trace = traced.Traced([e for e in WINDOW if e["name"] not in (
            "cnn.norm", "cnn.act", "cnn.dwconv", "cnn.requant")],
            queries=1, images=2, b1_launches=1)

    class Untraced(Run):
        trace = None
    for name in ("norm_device_ms", "act_device_ms", "dw_roofline",
                 "requant_roofline"):
        assert _reader(name)(Bare) is None, name
        assert _reader(name)(Untraced) is None, name


def test_new_cells_report_only_the_new_metrics(bench_json):
    """The two new cells report `setup_s`, `images_per_s` and only the
    metrics this configuration brought: ConvNeXt-T all four, and
    `vgg16.offline64` the requantization's share of its byte bound, which
    reads there the ReLU instances over VGG-16's 13 maps at batch 64."""
    from conftest import ROOT
    cx = harness.Cell(bench_json, "convnext_t.offline128", ROOT)
    vgg = harness.Cell(bench_json, "vgg16.offline64", ROOT)
    assert [m["name"] for m in cx.per_layer] == [
        "norm_device_ms", "act_device_ms", "dw_roofline", "requant_roofline"]
    assert [m["name"] for m in vgg.per_layer] == ["requant_roofline"]
    for cell in (cx, vgg):
        assert [m["name"] for m in cell.end_to_end] == [
            "images_per_s", "setup_s"]
    assert (vgg.traffic["batch"], vgg.traffic["in_flight"]) == (64, 2)
    maps = ([224 * 224 * 64] * 2 + [112 * 112 * 128] * 2
            + [56 * 56 * 256] * 3 + [28 * 28 * 512] * 3 + [14 * 14 * 512] * 3)
    assert requant_maps.requant_elements(vgg.config, 64) == 64 * sum(maps)
