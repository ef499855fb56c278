"""`spans` and the readers of the program's spans, on hand-built trace
events: launches paired with device events in order, each event put in
the innermost ``cnn.*`` span around its launch, and the idle gaps inside
and outside ``cnn.forward``."""

import pytest

import harness
import spans
import traced


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _read(name, t):
    class Run:
        trace = t
    return harness._module("layer_metrics", name).read(Run)


# one query: the images copied in, a forward of a conv, a requantization
# and a head, the logits copied out; device busy 20-36, 52-60, 70-73,
# 90-92, 120-121, idle between
WINDOW = [
    _ev("user_annotation", "bench.window", 0, 200),
    _ev("user_annotation", "bench.issue", 1, 118),
    _ev("cuda_runtime", "cudaMemcpyAsync", 2, 3),
    _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 20, 4),
    _ev("user_annotation", "cnn.forward", 10, 90),
    _ev("user_annotation", "cnn.conv", 11, 30),
    _ev("cpu_op", "aten::empty", 12, 2),
    _ev("cuda_runtime", "cudaLaunchKernel", 15, 4),
    _ev("kernel", "log_conv2d_dense_kernel", 24, 10),
    _ev("cpu_op", "aten::add", 30, 6),
    _ev("cuda_runtime", "cudaLaunchKernel", 32, 3),
    _ev("kernel", "vectorized_elementwise_kernel add", 34, 2),
    _ev("user_annotation", "cnn.requant", 45, 30),
    _ev("cuda_runtime", "cudaLaunchKernel", 48, 3),
    _ev("kernel", "clamp_min kernel", 52, 5),
    _ev("cuda_runtime", "cudaMemsetAsync", 55, 2),
    _ev("gpu_memset", "Memset (Device)", 57, 3),
    _ev("cuda_runtime", "cudaEventRecord", 62, 1),      # no device event
    _ev("cuda_runtime", "cudaLaunchKernel", 66, 3),
    _ev("kernel", "bitwise_and kernel", 70, 3),
    _ev("user_annotation", "cnn.head", 80, 15),
    _ev("cuda_driver", "cuLaunchKernel", 85, 4),
    _ev("kernel", "gemm kernel", 90, 2),
    _ev("cuda_runtime", "cudaLaunchKernel", 80, 5, tid=2),  # other thread
    _ev("cuda_runtime", "cudaMemcpyAsync", 105, 3),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 120, 1),
    _ev("user_annotation", "bench.wait", 130, 60),
]


def _traced(events, queries=1):
    return traced.Traced(events, queries=queries, images=8, b1_launches=1)


def _two_queries(drop=()):
    """WINDOW's query twice, the second 200 µs later, in a 400 µs window,
    without the device events of the second query named in ``drop``."""
    second = [dict(e, ts=e["ts"] + 200) for e in WINDOW[1:]
              if e["name"] not in drop]
    return _traced([dict(WINDOW[0], dur=400)] + WINDOW[1:] + second, 2)


def test_launches_pair_with_device_events_in_the_innermost_span():
    t = _traced(WINDOW)
    pairs, kept = spans.attribute(t)
    assert kept == 1
    assert [(n, d[0][:12]) for n, d in pairs] == [
        (None, "Memcpy HtoD "),
        ("cnn.conv", "log_conv2d_d"),
        ("cnn.conv", "vectorized_e"),
        ("cnn.requant", "clamp_min ke"),
        ("cnn.requant", "Memset (Devi"),
        ("cnn.requant", "bitwise_and "),
        ("cnn.head", "gemm kernel"),
        (None, "Memcpy DtoH ")]
    assert spans.device_ms_a_forward(t) == pytest.approx({
        None: 5e-3, "cnn.conv": 12e-3, "cnn.requant": 11e-3,
        "cnn.head": 2e-3})
    assert _read("requant_device_ms", t) == pytest.approx(11e-3)
    two = _two_queries()
    assert spans.attribute(two)[1] == 2
    assert _read("requant_device_ms", two) == pytest.approx(11e-3)


def test_a_launch_outside_every_child_span_falls_to_the_forward():
    ev = WINDOW + [_ev("cuda_runtime", "cudaLaunchKernel", 98, 1),
                   _ev("kernel", "stray kernel", 99, 0.5)]
    names = [n for n, _ in spans.attribute(_traced(ev))[0]]
    assert names[-2:] == ["cnn.forward", None]


def test_a_forward_whose_events_do_not_pair_is_left_out(capsys):
    # a kernel of the second forward lost: the first forward alone counts
    t = _two_queries(drop=("bitwise_and kernel",))
    pairs, kept = spans.attribute(t)
    assert kept == 1 and len(pairs) == 8 + 2
    assert "1 of 2 forwards left out" in capsys.readouterr().err
    assert _read("requant_device_ms", t) == pytest.approx(11e-3)
    # the memset lost and a kernel from elsewhere in its place: the counts
    # agree, the kinds do not
    swapped = [e for e in WINDOW if e["cat"] != "gpu_memset"] + [
        _ev("kernel", "stray kernel", 58, 1)]
    assert spans.attribute(_traced(swapped))[1] == 0
    assert _read("requant_device_ms", _traced(swapped)) is None
    assert "1 of 1 forwards left out" in capsys.readouterr().err


def test_a_copy_the_device_lacks_is_skipped(capsys):
    # the second query's logits copy lost: the runs beside it join and pair
    t = _two_queries(drop=("Memcpy DtoH (Device -> Pinned)",))
    pairs, kept = spans.attribute(t)
    assert kept == 2 and len(pairs) == 8 + 7
    assert "1 of 4 copies launched in the traced window are not on the " \
        "device; skipped" in capsys.readouterr().err
    assert _read("requant_device_ms", t) == pytest.approx(11e-3)
    # the first query's logits copy lost, and a kernel of the second
    # query: the pairing that explains both keeps the first forward
    first = [e for e in WINDOW[1:]
             if e["name"] != "Memcpy DtoH (Device -> Pinned)"]
    second = [dict(e, ts=e["ts"] + 200) for e in WINDOW[1:]
              if e["name"] != "bitwise_and kernel"]
    t = _traced([dict(WINDOW[0], dur=400)] + first + second, 2)
    pairs, kept = spans.attribute(t)
    assert kept == 1
    assert [n for n, _ in pairs] == [n for n, _ in
                                     spans.attribute(_traced(WINDOW))[0]
                                     ][:-1] + [None, None]
    assert _read("requant_device_ms", t) == pytest.approx(11e-3)


def test_nothing_when_the_copies_do_not_pair(capsys):
    # a copy on the device that no launch made
    t = _two_queries()
    t.device.append(("Memcpy HtoD (Pinned -> Device)", 390.0, 1.0,
                     "gpu_memcpy"))
    assert spans.attribute(t) is None
    assert spans.device_ms_a_forward(t) is None
    assert _read("requant_device_ms", t) is None
    assert "4 copies launched and 5 on the device" in capsys.readouterr().err


def test_pairing_holds_where_the_device_clock_reads_early():
    """The device clock drifts from the host's: a kernel the card started
    as soon as it was launched can read as starting before its launch."""
    early = [dict(e, ts=e["ts"] - 6) if e["name"] == "clamp_min kernel"
             else e for e in WINDOW]   # 46, its launch at 48
    names = [n for n, _ in spans.attribute(_traced(early))[0]]
    assert names == [n for n, _ in spans.attribute(_traced(WINDOW))[0]]


def test_idle_gaps_inside_and_outside_the_forward():
    t = _traced(WINDOW)
    assert spans.idle_gaps(t) == [(0.0, 20.0), (36.0, 52.0), (60.0, 70.0),
                                  (73.0, 90.0), (92.0, 120.0),
                                  (121.0, 200.0)]
    # midpoints 10 (the forward's first instant), 44, 65, 81.5 lie inside
    # the forward at 10-100; 106 and 160.5 outside
    assert spans.forward_idle_us(t) == pytest.approx(20 + 16 + 10 + 17)
    assert _read("forward_idle_ms", t) == pytest.approx(63e-3)
    assert _read("forward_host_ms", t) == pytest.approx(90e-3)
    two = _two_queries()
    assert _read("forward_host_ms", two) == pytest.approx(90e-3)
    # the second query's gaps 236-252, 260-270, 273-290 lie inside its
    # forward; 121-220 (midpoint 170.5, between the forwards), 292-320 and
    # 321-400 outside
    assert _read("forward_idle_ms", two) == pytest.approx((63 + 43) / 2e3)
    # every gap is counted once, inside or outside, as traced counts them
    assert sum(b - a for a, b in spans.idle_gaps(t)) * 1e-6 == \
        pytest.approx(sum(s for _, s in t.idle_gaps()))


READERS = ("requant_device_ms", "forward_idle_ms", "forward_host_ms")


@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_nothing_without_the_programs_spans(name):
    assert _read(name, None) is None
    bare = [e for e in WINDOW if not e["name"].startswith("cnn.")]
    assert _read(name, _traced(bare)) is None
