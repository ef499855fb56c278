"""The harness's parts on the CPU: cost arithmetic, discovery by name, the
import guard, the percentile, the load generator and the trace reader."""

import hashlib
import itertools
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


# each configuration's conv shapes at batch 8 (JSON of `costs.conv_shapes`,
# names and output sizes included), pinned before the plans moved into
# `reference/families/`
SHAPES_SHA256 = {
    "vgg16": "3c6580e737b0f6b0f1cc8d7be87e6a7b78bd1512ad037420b8f6850d5501ce0e",
    "resnet34": "a539d08885de32fbed3222c59ffc85c3e3f07d83415c401607d00b8075ecb082",
}


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
    assert hashlib.sha256(json.dumps(shapes).encode()).hexdigest() == \
        SHAPES_SHA256[config]
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
            "fams = [reference.cnn.family({'family': p.stem}) for p in "
            "reference.cnn.FAMILIES.glob('*.py')]; "
            "assert len(fams) >= 2, fams; "
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


# the bytes of every weight drawn at seed 2**31 + 99 on the CPU, in the
# plan's order, pinned before the plans moved into `reference/families/`
WEIGHTS_SHA256 = {
    "vgg16": "a5b3ea62b4dd180afacca9f11e0d95c9f7b50dd3aba96d2dbb3fd8b8e87cbfd1",
    "resnet34": "af1a8cfa404928d5582c06d6dff028bd6eb1ea5624cbcb6b1a4a87564025dc28",
}


@pytest.mark.parametrize("config,layer,shape,names", [
    ("vgg16", "convs.3", (3, 3, 128, 128),
     [f"convs.{i}.{k}" for i in range(13) for k in "wb"]),
    ("resnet34", "stages.1.0.0.c1", (3, 3, 64, 128),
     ["stem.w", "stem.b", "stages.0.0.0.c1.w"]),
])
def test_weights_drawn_from_the_seed(config, layer, shape, names):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    g = lambda: torch.Generator().manual_seed(2 ** 31 + 99)  # noqa: E731
    a = harness.draw_weights(cfg, g(), "cpu")
    b = harness.draw_weights(cfg, g(), "cpu")
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert list(a)[:len(names)] == names and list(a)[-2:] == ["head.w",
                                                              "head.b"]
    assert len(a) == 2 * len(costs.conv_shapes(cfg, 1)) + 2
    digest = hashlib.sha256()
    for w in a.values():
        digest.update(w.contiguous().numpy().tobytes())
    assert digest.hexdigest() == WEIGHTS_SHA256[config]
    w = a[layer + ".w"]
    assert tuple(w.shape) == shape
    assert float(w.std()) == pytest.approx(
        math.sqrt(2 / (9 * shape[2])), rel=0.05)
    assert float(a[layer + ".b"].std()) == pytest.approx(harness.BIAS_STD,
                                                         rel=0.3)


# the first 8 logits of the plain reference on a 32 px batch of 2 (weights,
# then images, from seed 2**31 + 99), taken before the plans moved
PINNED_LOGITS = {
    "vgg16": [1.046464204788208, 1.3734796047210693, 0.9077056050300598,
              1.3544816970825195, -0.5741625428199768, -1.0352513790130615,
              0.49159887433052063, 1.0320937633514404],
    "resnet34": [7.081466197967529, 57.375667572021484, 90.45326232910156,
                 -48.21151351928711, 71.930908203125, 8.567936897277832,
                 13.350794792175293, -9.040199279785156],
}


@pytest.mark.parametrize("config", sorted(PINNED_LOGITS))
def test_reference_logits_pinned(config):
    from reference import check
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg["image_size"] = 32
    gen = torch.Generator().manual_seed(2 ** 31 + 99)
    weights = harness.draw_weights(cfg, gen, "cpu")
    x = torch.randn((2, 32, 32, 3), generator=gen)
    logits = check.reference_forward(cfg, weights, x)
    assert logits.flatten()[:8].tolist() == pytest.approx(
        PINNED_LOGITS[config], rel=1e-6)


# a later family: a 3x3 conv, a 3x3/2 depthwise conv scaled per channel and
# requantized signed, a 1x1 conv, the dense head
LATER_FAMILY = '''
from .. import cnn


def conv_layers(config):
    c, w, o = config["in_channels"], config["width"], config["out"]
    return [("stem", 3, c, w, 1), ("dw", 3, w, w, 2), ("pw", 1, w, o, 1)]


def head_width(config):
    return config["out"]


def weight_shapes(config):
    c, w, o = config["in_channels"], config["width"], config["out"]
    return {"stem.w": (3, 3, c, w), "stem.b": (w,),
            "dw.w": (3, 3, 1, w), "dw.b": (w,), "dw.scale": (w,),
            "pw.w": (1, 1, w, o), "pw.b": (o,),
            "head.w": (o, config["n_classes"]),
            "head.b": (config["n_classes"],)}


def weight_init(name, shape):
    return (1.0, 0.1) if name == "dw.scale" else None


def forward(config, weights, images, conv, requant):
    b = weights
    x = requant(conv("stem", images, 1) + b["stem.b"])
    x = requant((conv("dw", x, 2) + b["dw.b"]) * b["dw.scale"], relu=False)
    x = requant(conv("pw", x, 1) + b["pw.b"])
    return cnn.dense_head(x, b)
'''
LATER_CONFIG = {"name": "later", "family": "later", "image_size": 16,
                "in_channels": 3, "n_classes": 10, "width": 32, "out": 48,
                "log_quant": {"bits": 6, "frac_bits": 1, "per_channel": True}}


@pytest.fixture
def later_family(tmp_path, monkeypatch):
    """The later family's plan as a new file in a families directory of
    its own, and its configuration."""
    from reference import cnn
    (tmp_path / "later.py").write_text(LATER_FAMILY)
    monkeypatch.setattr(cnn, "FAMILIES", tmp_path)
    return json.loads(json.dumps(LATER_CONFIG))


def _later_run(cfg):
    from reference import check
    gen = torch.Generator().manual_seed(2 ** 31 + 7)
    weights = harness.draw_weights(cfg, gen, "cpu")
    x = torch.randn((2, 16, 16, 3), generator=gen)
    rec = {}
    logits = check.reference_forward(cfg, weights, x, record=rec)
    return weights, x, rec, logits


def test_a_later_family_is_new_files(later_family):
    """Weights, costs, the reference and the check of a family that only
    its own file describes."""
    from reference import check
    cfg = later_family
    weights, x, rec, logits = _later_run(cfg)
    flat = torch.randn(sum(w.numel() for w in weights.values()),
                       generator=torch.Generator().manual_seed(2 ** 31 + 7))
    start = dict(zip(weights, itertools.accumulate(
        (w.numel() for w in weights.values()), initial=0)))

    def drawn(name):
        return flat[start[name]:][:weights[name].numel()].view(
            weights[name].shape)
    assert list(weights) == ["stem.w", "stem.b", "dw.w", "dw.b", "dw.scale",
                             "pw.w", "pw.b", "head.w", "head.b"]
    assert torch.equal(weights["dw.scale"], drawn("dw.scale") * 0.1 + 1.0)
    assert torch.equal(weights["dw.w"], drawn("dw.w") * (2.0 / 9) ** 0.5)
    assert torch.equal(weights["pw.b"], drawn("pw.b") * harness.BIAS_STD)
    shapes = costs.conv_shapes(cfg, 2)
    assert [(c["name"], c["C"], c["Cout"], c["groups"], c["Ho"])
            for c in shapes] == [("stem", 3, 32, 1, 16), ("dw", 32, 32, 32, 8),
                                 ("pw", 32, 48, 1, 8)]
    assert costs.model_flops_per_image(cfg) == 2 * (
        16 * 16 * 32 * 27 + 8 * 8 * 32 * 9 + 8 * 8 * 48 * 32 + 48 * 10)
    assert list(rec) == ["stem", "dw", "pw"]
    assert float(rec["pw"][0].min()) < 0   # requantized signed
    assert check.compare(cfg, weights, x, rec, logits) == {
        "conv_gap": 0.0, "act_mismatch": 0.0, "logit_gap": 0.0}


def test_a_later_family_fault_is_read(later_family):
    """One depthwise output off by 1 % of its max reads as not correct."""
    from reference import check
    weights, x, rec, logits = _later_run(later_family)
    x_dw, y_dw = rec["dw"]
    y_dw = y_dw.clone()
    y_dw[0, 0, 0, 0] += 0.01 * float(y_dw.abs().max())
    rec["dw"] = (x_dw, y_dw)
    got = check.compare(later_family, weights, x, rec, logits)
    assert got["conv_gap"] > 1e-4


def test_unknown_family_names_its_file():
    from reference import cnn
    with pytest.raises(ValueError, match="nothing.py"):
        cnn.conv_layers({"family": "nothing"})


def test_no_family_is_named_outside_its_plan():
    """The harness and the shared reference name no family: a family is
    its file under `reference/families/` and its configurations."""
    from reference import cnn
    families = [p.stem for p in cnn.FAMILIES.glob("*.py")]
    assert {"vgg", "resnet"} <= set(families)
    for path in [*BENCH.glob("*.py"), *(BENCH / "reference").glob("*.py")]:
        text = path.read_text()
        for f in families:
            assert f'"{f}"' not in text and f"'{f}'" not in text, (path, f)
