"""The harness's parts on the CPU: cost arithmetic, discovery by name, the
import guard, the percentile, the load generator and the trace reader."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

import costs
import harness
import loadgen
import traced
from conftest import BENCH, ROOT


def test_conv_costs_by_hand():
    # VGG-16's conv 2: 8 x 224 x 224 x 64 -> 64, 3x3, stride 1
    c = dict(B=8, H=224, W=224, C=64, K=3, Cout=64, stride=1, groups=1,
             Ho=224, Wo=224)
    assert costs.conv_flops(c) == 2 * 8 * 224 * 224 * 64 * 9 * 64
    assert costs.conv_bytes(c) == (8 * 224 * 224 * 64 * 4 + 9 * 64 * 64
                                   + 64 * 4 + 8 * 224 * 224 * 64 * 4)
    # a depthwise 3x3/2 on 112 x 112 x 32: one input channel an output
    d = dict(B=1, H=112, W=112, C=32, K=3, Cout=32, stride=2, groups=32,
             Ho=56, Wo=56)
    assert costs.conv_flops(d) == 2 * 56 * 56 * 32 * 9
    assert costs.conv_bytes(d) == (112 * 112 * 32 * 4 + 9 * 32 + 32 * 4
                                   + 56 * 56 * 32 * 4)
    # wide maps are bound by their bytes, deep ones by their operations
    e = dict(c, H=28, W=28, C=512, Cout=512, Ho=28, Wo=28)
    assert costs.conv_bound_s(c) == costs.conv_bytes(c) / costs.HBM_BYTES_PER_S
    assert costs.conv_bound_s(d) == costs.conv_bytes(d) / costs.HBM_BYTES_PER_S
    assert costs.conv_bound_s(e) == costs.conv_flops(e) / costs.PEAK_FLOPS


@pytest.mark.parametrize("config,convs,gflop", [("vgg16", 13, 30.694285312),
                                                ("resnet34", 36, 7.211917312)])
def test_config_shapes_are_the_programs(config, convs, gflop):
    import program
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    shapes = costs.conv_shapes(cfg, 8)
    assert len(shapes) == convs
    assert program.conv_shapes(cfg, 8) == sorted(
        (c["B"], c["H"], c["W"], c["C"], c["K"], c["Cout"], c["stride"],
         c["groups"]) for c in shapes)
    assert costs.model_flops_per_image(cfg) == pytest.approx(gflop * 1e9,
                                                             rel=1e-12)


def test_discovery_by_name(bench_json):
    ms = harness.Cell(bench_json, "vgg16.ms8", ROOT)
    off = harness.Cell(bench_json, "resnet34.offline128", ROOT)
    assert (ms.config["name"], ms.traffic["batch"], ms.traffic["in_flight"]) \
        == ("vgg16", 8, 1)
    assert (off.config["name"], off.traffic["batch"],
            off.traffic["in_flight"]) == ("resnet34", 128, 2)
    assert [m["name"] for m in ms.end_to_end] == [
        "images_per_s", "query_ms_p95", "setup_s"]
    assert [m["name"] for m in off.end_to_end] == ["images_per_s", "setup_s"]
    names = [m["name"] for m in bench_json["per_layer"]]
    assert [m["name"] for m in ms.per_layer] == names
    assert [m["name"] for m in off.per_layer] == names
    with pytest.raises(ValueError, match="no workload"):
        harness.Cell(bench_json, "vgg16.nothing", ROOT)


def test_every_entry_has_its_files(bench_json):
    for kind, sec in (("end_to_end", "end_to_end"),
                      ("layer_metrics", "per_layer")):
        for m in bench_json[sec]:
            assert callable(harness._module(kind, m["name"]).read)
    for c in bench_json["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in cfg["reduced"])
        assert set(cfg["limits"]) == {"conv_gap", "act_mismatch",
                                      "logit_gap"}
    for w in bench_json["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()


def test_a_later_metric_is_a_new_file(bench_json, tmp_path, monkeypatch):
    """A per-layer metric without a ``workloads`` key reaches every cell
    that reports what it moves, and is read from its own file."""
    (tmp_path / "layer_metrics").mkdir()
    (tmp_path / "layer_metrics" / "some.metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench_json["per_layer"].append({"name": "some.metric", "unit": "%",
                                    "better": "higher", "source": "device_trace",
                                    "layer": "device", "moves": "query_ms_p95"})
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    assert harness._module("layer_metrics", "some.metric").read(None) == 42.0
    monkeypatch.setattr(harness, "BENCH", BENCH)
    ms = harness.Cell(bench_json, "vgg16.ms8", ROOT)
    off = harness.Cell(bench_json, "resnet34.offline128", ROOT)
    assert "some.metric" in [m["name"] for m in ms.per_layer]
    assert "some.metric" not in [m["name"] for m in off.per_layer]


def test_import_guard(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro.kernels", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert {"repro.kernels", "jax"} <= set(harness.forbidden_modules())


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.check, reference.cnn, costs, loadgen, traced; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(BENCH))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 500])
def test_percentile_over_all_values(n):
    v = np.random.default_rng(n).exponential(size=n).tolist()
    assert loadgen.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    assert loadgen.percentile(v, 0) == min(v)
    assert loadgen.percentile(v, 100) == max(v)


def test_closed_loop_retires_every_query_in_order():
    pool = [torch.full((2, 4, 4, 3), float(i)) for i in range(3)]
    calls = []

    def forward(x):
        calls.append(float(x[0, 0, 0, 0]))
        return x.mean(dim=(1, 2))

    for in_flight in (1, 2):
        calls.clear()
        win = loadgen.closed_loop(forward, pool, torch.device("cpu"),
                                  in_flight, count=7)
        assert win.slot == [0, 1, 2, 0, 1, 2, 0] and calls == win.slot
        assert [float(l[0, 0]) for l in win.logits] == win.slot
        assert len(win.done) == 7 and win.images == 14
        assert all(d >= i for i, d in zip(win.issued, win.done))
        assert win.images_per_s == pytest.approx(14 / win.seconds)


def _trace(events):
    t = traced.Traced(events, queries=2, images=16, b1_launches=2)
    return t


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_trace_reader_and_layer_metrics():
    ev = [_ev("user_annotation", "bench.window", 0, 100),
          _ev("user_annotation", "bench.issue", 0, 30),
          _ev("gpu_memcpy", "Memcpy HtoD", 5, 5),
          _ev("kernel", "log_conv2d_dense_kernel", 10, 20),
          _ev("kernel", "elementwise_kernel", 25, 15),     # overlaps
          _ev("gpu_user_annotation", "bench.window", 0, 100),
          _ev("cuda_runtime", "cudaEventSynchronize", 40, 50),
          _ev("cpu_op", "aten::empty", 41, 3),            # inside the sync
          _ev("cpu_op", "other_thread", 30, 70, tid=2),
          _ev("kernel", "log_conv2d_dense_kernel", 60, 20),
          _ev("kernel", "reduce_kernel", 95, 10),           # clipped at 100
          _ev("kernel", "outside", 200, 5)]
    t = _trace(ev)
    assert t.complete()
    assert t.busy_intervals() == [(5.0, 40.0), (60.0, 80.0), (95.0, 100.0)]
    assert t.busy_s == pytest.approx(60e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert dict(t.idle_gaps()) == pytest.approx(
        {"bench.issue": 5e-6, "cudaEventSynchronize": 35e-6})
    ev2 = ev + [_ev("cpu_op", "aten::mm", 80, 15)]   # covers gap 80-95
    assert dict(_trace(ev2).idle_gaps()) == pytest.approx(
        {"bench.issue": 5e-6, "cudaEventSynchronize": 20e-6,
         "aten::mm": 15e-6})
    assert len(t.kernels) == 4

    class Run:
        trace = t
        convs = [dict(B=1, H=8, W=8, C=8, K=3, Cout=8, stride=1, groups=1,
                      Ho=8, Wo=8)]
    read = lambda name: harness._module("layer_metrics", name).read(Run)  # noqa: E731
    assert read("kernels_per_forward") == 2.0
    assert read("device_idle_pct") == pytest.approx(40.0)
    assert read("nonconv_device_ms") == pytest.approx((15 + 10) * 1e-3 / 2)
    assert read("b1_roofline") == pytest.approx(
        100 * 2 * costs.conv_bound_s(Run.convs[0]) / 40e-6)
    lost = _trace(ev[:3] + ev[4:])   # one conv-kernel event lost
    assert not lost.complete()


def test_layer_metrics_read_nothing_without_a_trace():
    class Run:
        trace = None
    for name in ("b1_roofline", "nonconv_device_ms", "kernels_per_forward",
                 "device_idle_pct"):
        assert harness._module("layer_metrics", name).read(Run) is None


def test_weights_drawn_from_the_seed():
    cfg = json.loads((BENCH / "configs" / "resnet34.json").read_text())
    g = lambda: torch.Generator().manual_seed(2 ** 31 + 99)  # noqa: E731
    a = harness.draw_weights(cfg, g(), "cpu")
    b = harness.draw_weights(cfg, g(), "cpu")
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    w = a["stages.1.0.0.c1.w"]
    assert tuple(w.shape) == (3, 3, 64, 128)
    assert float(w.std()) == pytest.approx(math.sqrt(2 / (9 * 64)), rel=0.05)
    assert float(a["stem.b"].std()) == pytest.approx(harness.BIAS_STD,
                                                     rel=0.3)
