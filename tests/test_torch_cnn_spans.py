"""The port's CNN forward under `torch.profiler`: its ``cnn.*`` spans
(`repro_torch.models.cnn`) as the profiler records them, on the CPU.

Every op of a forward lies in exactly one span below ``cnn.forward``;
each net opens as many spans of each kind as its plan has layers of that
kind; and a forward computes the same logits, bit for bit, whether a
profiler records or not."""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)

from repro_torch.models import cnn as tcnn  # noqa: E402

IMG = 32
# the spans of one forward at 32 px: dense and depthwise convs,
# requantizations, pools (the maxpools the plan keeps at this size and the
# global average), shortcuts, concats, LayerNorms, GELUs, head
PLAN = {
    "vgg16": {"cnn.conv": 13, "cnn.requant": 13, "cnn.pool": 6,
              "cnn.head": 1},
    "mobilenet_v1": {"cnn.conv": 14, "cnn.dwconv": 13, "cnn.requant": 27,
                     "cnn.pool": 1, "cnn.head": 1},
    "resnet34": {"cnn.conv": 36, "cnn.requant": 33, "cnn.shortcut": 16,
                 "cnn.pool": 2, "cnn.head": 1},
    "squeezenet": {"cnn.conv": 26, "cnn.requant": 26, "cnn.concat": 8,
                   "cnn.pool": 4},
    "convnext_t": {"cnn.conv": 40, "cnn.dwconv": 18, "cnn.requant": 61,
                   "cnn.norm": 23, "cnn.act": 18, "cnn.shortcut": 18,
                   "cnn.pool": 1, "cnn.head": 1},
}


def _net(name):
    params, apply = tcnn.make_cnn(name, 3, n_classes=10, width_mult=0.125,
                                  quant="logq6", conv_impl="blockwise",
                                  device="cpu")
    x = torch.randn((2, IMG, IMG, 3), generator=torch.Generator()
                    .manual_seed(4))
    return params, apply, x


def _profiled_forward(apply, params, x, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        logits = apply(params, x)
    path = tmp_path / "forward.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return logits, events


def _inside(e, outer):
    return (outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("name", sorted(PLAN))
def test_every_op_of_the_forward_in_exactly_one_layer_span(name, tmp_path):
    params, apply, x = _net(name)
    _, events = _profiled_forward(apply, params, x, tmp_path)
    marks = [e for e in events if e["cat"] == "user_annotation"]
    assert all(e["name"].startswith("cnn.") for e in marks)
    (fwd,) = [e for e in marks if e["name"] == "cnn.forward"]
    layers = [e for e in marks if e["name"] != "cnn.forward"]
    assert all(_inside(e, fwd) for e in layers)
    counts = {}
    for e in layers:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    assert counts == PLAN[name]
    ops = [e for e in events if e["cat"] == "cpu_op" and _inside(e, fwd)]
    assert len(ops) > sum(PLAN[name].values())
    outside = [e["name"] for e in ops
               if sum(_inside(e, s) for s in layers) != 1]
    assert outside == []


@pytest.mark.parametrize("name", sorted(PLAN))
def test_logits_bit_equal_with_and_without_a_profiler(name, tmp_path):
    params, apply, x = _net(name)
    with torch.no_grad():
        plain = apply(params, x)
    profiled, events = _profiled_forward(apply, params, x, tmp_path)
    assert any(e["name"] == "cnn.forward" for e in events)
    assert torch.equal(plain, profiled)
