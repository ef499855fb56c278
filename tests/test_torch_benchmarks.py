"""The conv traffic model (`repro_torch.kernels.log_conv2d.
conv_traffic_bytes`) and the bench twins (`repro_torch.benchmarks`).

``"cuda"`` bytes are held against a walk over the blocks of
`log_conv2d_geometry`, block by block, as the kernel `csrc/log_conv2d.cu`
fetches them; ``"fp32"`` / ``"blockwise"`` / ``"ref"`` against the JAX
package's formulas.  Each twin runs on the CPU at a tiny size and writes
its JSON under a temporary directory."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the machine with the card has no JAX: the JAX comparison skips
    from repro.kernels import log_conv2d as jlc
except ImportError:
    jlc = None

from repro_torch.benchmarks import (attention_kernels,  # noqa: E402
                                    conv_kernels, run, telemetry_overhead)
from repro_torch.kernels import log_conv2d as tlc  # noqa: E402

BM, BN, BK = tlc.BM, tlc.BN, tlc.BK


def _walk_dense(g, B, H, W, C, K, Cout, stride, pads, groups, bits):
    """Bytes the dense kernel fetches and writes, block by block."""
    (ph, _), (pw, _) = pads
    Ho = (H + sum(pads[0]) - K) // stride + 1
    Wo = (W + sum(pads[1]) - K) // stride + 1
    cin_g, cout_g = C // groups, Cout // groups
    M, R = B * Ho * Wo, K * K * cin_g
    m = np.arange(M)
    ho, wo = (m % (Ho * Wo)) // Wo, m % Wo
    tap = np.arange(R) // cin_g
    hi = ho[:, None] * stride + (tap // K)[None] - ph
    wi = wo[:, None] * stride + (tap % K)[None] - pw
    inside = (hi >= 0) & (hi < H) & (wi >= 0) & (wi < W)     # [M, R]
    share = g["stages_per_split"] * BK
    act = w = out = 0
    for _grp in range(groups):
        for nt in range(g["n_tiles"]):
            ncols = min(BN, cout_g - nt * BN)
            for mt in range(g["m_tiles"]):
                rows = slice(mt * BM, min(M, (mt + 1) * BM))
                n_rows = rows.stop - rows.start
                for sp in range(g["splits"]):
                    r0, r1 = sp * share, min(R, (sp + 1) * share)
                    assert r1 > r0                      # no empty share
                    act += 4 * int(inside[rows, r0:r1].sum())
                    w += (r1 - r0) * ncols + 4 * (2 << bits)  # codes, table
                w += 4 * ncols                          # the tile's scales
                out += 4 * n_rows * ncols               # y
                if g["splits"] > 1:                     # partials, tickets
                    out += 2 * g["splits"] * 4 * n_rows * ncols \
                        + 8 * g["splits"] + 4
    return act, w, out


def _walk_depthwise(g, B, H, W, C, K, Cout, stride, pads):
    """Bytes the depthwise kernel fetches and writes, block by block."""
    th, tw, ct = g["tile"]
    pr, pc = (th - 1) * stride + K, (tw - 1) * stride + K
    Ho = (H + sum(pads[0]) - K) // stride + 1
    Wo = (W + sum(pads[1]) - K) // stride + 1
    act = w = 0
    for _b in range(B):
        for i in range(g["tiles_h"]):
            h0 = i * th * stride - pads[0][0]
            rows = len(range(max(h0, 0), min(h0 + pr, H)))
            for j in range(g["tiles_w"]):
                w0 = j * tw * stride - pads[1][0]
                cols = len(range(max(w0, 0), min(w0 + pc, W)))
                for c in range(g["tiles_c"]):
                    chans = min(ct, Cout - c * ct)
                    act += 4 * rows * cols * chans
                    w += chans * (K * K + 4)            # codes, scales
    return act, w, 4 * B * Ho * Wo * Cout


WALK_SHAPES = [  # B, H, W, C, K, Cout, stride, padding, groups, n_sm, knobs
    (1, 4, 4, 64, 3, 64, 1, "SAME", 1, 132, None),     # split-K dense
    (2, 9, 7, 32, 3, 80, 2, "SAME", 1, 1, None),       # no split, ragged N
    (1, 8, 8, 16, 3, 32, 1, ((1, 2), (0, 1)), 4, 132, None),   # grouped
    (2, 15, 16, 12, 3, 12, 2, "SAME", 12, 132, None),  # depthwise, stride 2
    # the knobs of an autotune table, as the wrapper launches them
    (1, 6, 6, 96, 3, 72, 2, "SAME", 1, 132, dict(splits=1)),
    (1, 6, 6, 96, 3, 72, 2, "SAME", 1, 132, dict(splits=3)),
    (1, 6, 6, 96, 3, 72, 2, "SAME", 1, 132, dict(splits=27)),
    (1, 8, 8, 16, 3, 32, 1, "SAME", 4, 132, dict(splits=2)),
    (2, 15, 16, 12, 3, 12, 2, "SAME", 12, 132, dict(tile=(3, 4, 4))),
    (2, 15, 16, 12, 3, 12, 1, "SAME", 12, 132, dict(tile=(8, 8, 8))),
    (1, 19, 21, 40, 3, 40, 1, "SAME", 40, 132, dict(tile=(19, 12, 16))),
]


@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_cuda_bytes_match_tile_walk(shape):
    B, H, W, C, K, Cout, stride, padding, groups, n_sm, knobs = shape
    pads = tlc.normalize_padding(padding, K, stride, H, W)
    g = tlc.log_conv2d_geometry(B, H, W, C, K, Cout, stride, padding, groups,
                                n_sm, **tlc.knob_args(knobs))
    for name, value in (knobs or {}).items():
        assert g[name] == value                  # the knob took effect
    if g["path"] == "dense":
        walked = _walk_dense(g, B, H, W, C, K, Cout, stride, pads, groups, 6)
        if knobs is None:                        # the shapes cover both
            assert (g["splits"] > 1) == (n_sm > 1)
    else:
        walked = _walk_depthwise(g, B, H, W, C, K, Cout, stride, pads)
    got = tlc.conv_traffic_bytes("cuda", B, H, W, C, K, Cout, stride=stride,
                                 padding=padding, groups=groups, n_sm=n_sm,
                                 config=knobs)
    assert (got["act"], got["w"], got["out"]) == walked
    assert got["act_w"] == got["act"] + got["w"]
    assert got["total"] == sum(walked)
    # nothing moves less than x, codes, scale and y once each
    assert got["total"] >= tlc.conv_traffic_bytes(
        "min", B, H, W, C, K, Cout, stride=stride, padding=padding,
        groups=groups)["total"]


def test_min_bytes_are_each_operand_once():
    got = tlc.conv_traffic_bytes("min", 2, 9, 7, 6, 3, 8, stride=2,
                                 groups=2)
    Ho, Wo = 5, 4
    assert got["act"] == 4 * 2 * 9 * 7 * 6
    assert got["w"] == 3 * 3 * 3 * 8 + 4 * 8
    assert got["out"] == 4 * 2 * Ho * Wo * 8
    assert got["total"] == got["act"] + got["w"] + got["out"]


@pytest.mark.skipif(jlc is None, reason="needs the JAX package")
@pytest.mark.parametrize("impl", ["fp32", "blockwise", "ref"])
@pytest.mark.parametrize("shape", [s[:9] for s in WALK_SHAPES[:4]]
                         + [(1, 8, 8, 3, 5, 4, 2, 2, 1)])
def test_plain_bytes_match_jax(impl, shape):
    B, H, W, C, K, Cout, stride, padding, groups = shape
    kw = dict(stride=stride, padding=padding, groups=groups)
    want = jlc.conv_traffic_bytes({"ref": "fp32"}.get(impl, impl),
                                  B, H, W, C, K, Cout, **kw)
    assert tlc.conv_traffic_bytes(impl, B, H, W, C, K, Cout, **kw) == want


def test_conv_key_format():
    assert tlc.conv_key(2, 9, 7, 6, 3, 8, stride=2, groups=2,
                        backend="cpu") == \
        "conv2d|cpu|q6.1|x2x9x7x6|k3o8|s2|g2|p1.1.1.1"


def test_conv_bench_twin_on_cpu(tmp_path):
    out = conv_kernels.run(device="cpu", root=tmp_path, img=8, batch=1,
                           reps=1)
    assert out["ok"], out
    saved = json.loads((tmp_path / "BENCH_torch_conv.json").read_text())
    assert len(saved["rows"]) == 4 and len(saved["lane_rows"]) == 4
    assert saved["timer"] == "host clock"
    cold = saved["cold_start"]       # the packaged tier covers the zoo
    assert cold["ok"] and cold["miss"] == 0 and cold["sweeps"] == 0
    assert cold["hit_warm"] == cold["lookups"] == cold["distinct_keys"] > 0
    assert cold["conv_dispatches"] == 13 + 27 + 36 + 26
    for r in saved["rows"]:
        assert r["bytes_min"] <= r["bytes_cuda"]
        assert r["rel_quant_err"] < conv_kernels.QUANT_ERR_LIMIT


def test_attention_bench_twin_on_cpu(tmp_path):
    out = attention_kernels.run(device="cpu", root=tmp_path, reps=1)
    assert out["ok"], out
    saved = json.loads((tmp_path / "BENCH_torch_attention.json").read_text())
    assert [r["case"] for r in saved["rows"]] == \
        [c[0] for c in attention_kernels.CASES]
    assert saved["min_gqa4_traffic_win_x"] >= \
        attention_kernels.TRAFFIC_WIN_GQA4
    assert all(p["ok"] for p in saved["probes"].values())


def test_telemetry_bench_twin_on_cpu(tmp_path):
    """The 3 % gate is not asserted: host-clock figures of a loaded test
    machine vary more than it."""
    out = telemetry_overhead.run(device="cpu", root=tmp_path, steps=2,
                                 trials=2)
    saved = json.loads((tmp_path / "BENCH_torch_telemetry.json").read_text())
    assert saved["overhead_pct"] == pytest.approx(out["overhead_pct"])
    assert saved["kernel_records"] > 0
    for name in ("trace.json", "metrics_snapshot.json"):
        assert (tmp_path / "telemetry_torch" / name).exists()
    snap = json.loads((tmp_path / "telemetry_torch"
                       / "metrics_snapshot.json").read_text())
    assert {"prefill", "decode"} <= set(snap["kernels"]["programs"])


def test_run_cli_writes_under_out(tmp_path):
    assert run.main(["--only", "conv", "--device", "cpu", "--img", "8",
                     "--out", str(tmp_path)]) == 0
    assert (tmp_path / "BENCH_torch_conv.json").exists()
