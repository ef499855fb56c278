"""The port's dataflow, network and cost models (`repro_torch.core.dataflow`,
`accelerator`, `cost_model`) against the JAX package's: every field of
every layer of the four paper nets equal, the cost-model anchors equal, and
the analytical cycle count against the port's functional grid."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
pytest.importorskip("jax")

from repro.core import accelerator as jacc  # noqa: E402
from repro.core import cost_model as jcost  # noqa: E402
from repro.core import dataflow as jdf  # noqa: E402
from repro_torch.core import accelerator as tacc  # noqa: E402
from repro_torch.core import cost_model as tcost  # noqa: E402
from repro_torch.core import dataflow as tdf  # noqa: E402
from repro_torch.core.pe_grid import PEGrid  # noqa: E402

NET_FIELDS = ("total_cycles", "total_macs", "avg_utilization",
              "mean_layer_utilization", "latency_ms",
              "throughput_gops_paper", "ddr_bytes_log", "ddr_bytes_fp16")
LAYER_FIELDS = ("utilization", "latency_ms", "gops_paper", "gmacs_per_s")


def _layer(perf) -> dict:
    out = dataclasses.asdict(perf)
    out.update({f: getattr(perf, f) for f in LAYER_FIELDS})
    out["spec"].update(Ho=perf.spec.Ho, Wo=perf.spec.Wo,
                       macs=perf.spec.macs)
    return out


@pytest.mark.parametrize("img", [224, 112])
@pytest.mark.parametrize("net", sorted(jacc.NETWORKS))
def test_run_network_matches_jax(net, img):
    got, want = tacc.run_network(net, img), jacc.run_network(net, img)
    assert got.name == want.name and len(got.layers) == len(want.layers)
    for g, w in zip(got.layers, want.layers):
        assert _layer(g) == _layer(w)
    for f in NET_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def test_layer_kinds_match_jax():
    """Every branch of `analyze_layer`: pool, K = 4 and 5, 1×1 with a
    stride, depthwise with stride 2."""
    for args in [("p", "pool", 56, 56, 64, 64, 2, 2, 0),
                 ("k4", "conv", 30, 30, 16, 8, 4, 1, 1),
                 ("k5", "conv", 31, 29, 12, 20, 5, 2, 2),
                 ("pw", "pwconv", 13, 13, 40, 7, 1, 2, 0),
                 ("dw", "dwconv", 27, 27, 30, 30, 3, 2, 1)]:
        g = tdf.analyze_layer(tdf.LayerSpec(*args))
        w = jdf.analyze_layer(jdf.LayerSpec(*args))
        assert _layer(g) == _layer(w), args
    assert (tdf.CLOCK_HZ, tdf.PEAK_OPS_PER_CYCLE, tdf.PEAK_GOPS_PAPER) == \
        (jdf.CLOCK_HZ, jdf.PEAK_OPS_PER_CYCLE, jdf.PEAK_GOPS_PAPER)


def test_cost_model_anchors_match_jax():
    assert tcost.cost_adjusted_pe_count() == jcost.cost_adjusted_pe_count() \
        == 122
    for threads in (1, 2, 3, 4):
        assert tcost.log_pe_cost(threads).luts == \
            jcost.log_pe_cost(threads).luts
        assert tcost.log_pe_cost(threads).ffs == \
            jcost.log_pe_cost(threads).ffs
        assert tcost.cost_adjusted_pe_count(threads=threads) == \
            jcost.cost_adjusted_pe_count(threads=threads)
        for adjusted in (True, False):
            assert tcost.peak_throughput_per_pe(threads, adjusted) == \
                jcost.peak_throughput_per_pe(threads, adjusted)
        assert tcost.area_overhead_vs_linear(threads) == \
            jcost.area_overhead_vs_linear(threads)
    assert tcost.linear_pe_cost().relative_to_linear() == \
        jcost.linear_pe_cost().relative_to_linear()
    assert tcost.breakdown() == jcost.breakdown()
    assert abs(tcost.peak_throughput_per_pe() - 324 / 122) < 1e-9


def test_paper_aggregates():
    """`test_dataflow.py`'s VGG-16 claims (Fig 19a/20, Table 3) on the
    port's copy."""
    perf = tacc.run_network("vgg16")
    assert 0.92 <= perf.mean_layer_utilization <= 0.97
    assert abs(perf.throughput_gops_paper - 307.8) < 12.0
    assert abs(perf.latency_ms - 240.23) < 25.0
    assert 2.0 < perf.ddr_bytes_fp16 / perf.ddr_bytes_log < 2.5


@pytest.mark.parametrize("H,W,C,P", [(12, 6, 1, 1), (12, 8, 6, 2),
                                     (18, 6, 3, 2), (30, 30, 13, 3)])
def test_analytical_cycles_vs_the_grid(H, W, C, P):
    """`test_pe_grid.py`'s check on the port: the streamed-band model never
    counts more cycles than the functional grid, and at least 0.6 of them;
    the grid's counts do not depend on the values (zeros here)."""
    x = np.zeros((H, W, C), np.float32)
    w = np.zeros((3, 3, C, P), np.float32)
    _, stats = PEGrid(mode="float", device="cpu").conv2d(x, w)
    perf = tdf.analyze_layer(tdf.LayerSpec("t", "conv", H, W, C, P, K=3))
    assert 0.6 * stats.cycles <= perf.cycles <= stats.cycles
