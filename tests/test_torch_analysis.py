"""The port's `repro_torch.analysis` (roofline terms and the report) and
`ModelConfig.active_param_count` / `flops_per_token` against the JAX
package's, on the same inputs:

  * the analytic parameter and FLOP counts for every arch and shape;
  * synthetic dry-run records in JAX's schema through both packages'
    `from_record`, `row()`, `table`, `dryrun_table`, `roofline_table` and
    `summary`: the FLOP, byte, memory, status and count columns equal;
    ``t_compute`` scaled by 197e12 / 989e12 (JAX's TPU v5e bf16 peak over
    the H100's), ``t_memory`` by 819e9 / 3.35e12 and ``t_collective`` by
    50e9 / 450e9 (JAX's ICI link over the H100's NVLink sends).  Every
    record leads with one term by over 10x in both packages, so
    ``bottleneck`` is held equal on all of them; ``roofline_mfu`` is held
    equal where both find the record compute-bound (the peak cancels) and
    scaled by the ratio of the two packages' terms elsewhere;
  * the metrics view: one snapshot JSON written by the port's
    ``launch.serve --reduced --device cpu --telemetry on --metrics-out``
    under ``REPRO_KERNEL_PROFILE=1``, and the same snapshot at 1e-4 of its
    times (so that the bandwidth column reads more than 0.00 %), through
    both packages' `metrics_report`: every line equal but the %HBM column,
    scaled by 819e9 / 3.35e12, and the programs heading.
"""

import itertools
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
try:  # the machine with the card has no JAX: the JAX comparisons skip
    from repro.analysis import report as jrep
    from repro.analysis import roofline as jroof
    from repro.configs import base as jbase
    from repro.configs.registry import get_config as jget
except ImportError:
    jrep = None

from repro_torch.analysis import report as trep  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
needs_jax = pytest.mark.skipif(jrep is None, reason="needs the JAX package")

R_COMPUTE = 197e12 / 989e12
R_MEMORY = 819e9 / 3.35e12
R_COLL = 50e9 / 450e9


def test_h100_peaks_have_one_definition():
    """The card's peaks are defined in `analysis.roofline` and read from
    there by the bench plumbing and chip_smoke.py."""
    assert (troof.PEAK_FLOPS, troof.PEAK_FP32_FLOPS, troof.HBM_BW,
            troof.NVLINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    assert common.PEAK_BF16_FLOPS is troof.PEAK_FLOPS
    assert common.PEAK_FP32_FLOPS is troof.PEAK_FP32_FLOPS
    assert common.PEAK_HBM_BYTES is troof.HBM_BW
    pattern = re.compile(r"^\s*(PEAK_\w+|HBM_BW|NVLINK_BW)\s*=\s*[\d.]+e\d+",
                         re.M)
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
            [ROOT / "chip_smoke.py"]:
        defs = pattern.findall(path.read_text())
        if path.name == "roofline.py" and path.parent.name == "analysis":
            assert sorted(defs) == ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS",
                                    "PEAK_FP32_FLOPS"]
        else:
            assert not defs, (path, defs)


@needs_jax
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_model_flops_match_jax(arch):
    jc, tc = jget(arch), tget(arch)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.flops_per_token() == jc.flops_per_token()
    if tc.is_moe:
        assert tc.active_param_count() < tc.param_count()
    assert list(tbase.SHAPES) == list(jbase.SHAPES)
    for name, shape in tbase.SHAPES.items():
        assert troof.model_flops_for(tc, shape) == \
            jroof.model_flops_for(jc, jbase.SHAPES[name])


# ------------------------------------------------------------ dry-run records

# seconds of each term at JAX's rates, by the term that is to lead; every
# leader is over 10x the other two in both packages
TERMS = {"compute": (2.0, 0.01, 0.01), "memory": (0.01, 2.0, 0.01),
         "collective": (0.01, 0.01, 2.0)}


def _records() -> list[dict]:
    """One record per (arch, shape, mesh) in JAX's schema: skipped where
    the cell is not runnable, a failed compile on a few, each of the three
    terms leading on a third of the rest."""
    rng = np.random.default_rng(5)
    recs = []
    for i, (arch, shape, mesh) in enumerate(itertools.product(
            ARCH_NAMES, tbase.SHAPES, ("single", "multi"))):
        chips = 256 if mesh == "single" else 512
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
               "step_kind": tbase.SHAPES[shape]["step"]}
        if not tbase.cell_is_runnable(arch, shape):
            recs.append(dict(rec, skipped=True))
            continue
        if i % 11 == 3:
            recs.append(dict(rec, error="RESOURCE_EXHAUSTED (synthetic)"))
            continue
        lead = list(TERMS)[i % 3]
        tc, tm, tl = (t * rng.uniform(0.5, 1.5) for t in TERMS[lead])
        rec.update(
            cost_true={"flops": tc * jroof.PEAK_FLOPS,
                       "bytes": tm * jroof.HBM_BW,
                       "collective_bytes": tl * jroof.ICI_BW},
            memory={"temp_bytes": int(rng.integers(1, 40)) << 30,
                    "argument_bytes": int(rng.integers(1, 20)) << 29},
            model_flops=troof.model_flops_for(tget(arch),
                                              tbase.SHAPES[shape]),
            collectives_prod_once={"counts": {
                "all-gather": int(rng.integers(0, 9)),
                "reduce-scatter": int(rng.integers(0, 5)),
                "all-reduce": int(rng.integers(0, 3))}})
        recs.append(rec)
    return recs


def _cells(line: str) -> list[str]:
    return [c.strip() for c in line.strip().strip("|").split("|")]


def _num(cell: str) -> float:
    return float(cell.rstrip("%"))


@needs_jax
def test_roofline_rows_scale_by_the_two_cards_rates():
    recs = [r for r in _records() if "cost_true" in r]
    assert len(recs) > 40
    leads = {"compute": 0, "memory": 0, "collective": 0}
    for rec in recs:
        j, t = jroof.from_record(rec), troof.from_record(rec)
        assert _fields(t) == _fields(j)
        jr, tr = j.row(), t.row()
        assert set(tr) == set(jr)
        for k in ("arch", "shape", "mesh", "model_flops", "useful_ratio",
                  "mem_gb_per_dev"):
            assert tr[k] == jr[k], k
        for k, ratio in (("t_compute_s", R_COMPUTE),
                         ("t_memory_s", R_MEMORY),
                         ("t_collective_s", R_COLL)):
            assert math.isclose(tr[k], jr[k] * ratio, rel_tol=1e-12), k
        assert tr["bottleneck"] == jr["bottleneck"]
        leads[tr["bottleneck"]] += 1
        if tr["bottleneck"] == "compute":
            assert math.isclose(tr["roofline_mfu"], jr["roofline_mfu"],
                                rel_tol=1e-12)
        else:
            scale = R_COMPUTE / {"memory": R_MEMORY, "collective": R_COLL}[
                tr["bottleneck"]]
            assert math.isclose(tr["roofline_mfu"],
                                jr["roofline_mfu"] * scale, rel_tol=1e-12)
        assert t.step_time == max(t.t_compute, t.t_memory, t.t_collective)
    assert min(leads.values()) > 5


def _fields(r) -> dict:
    return {k: getattr(r, k) for k in ("arch", "shape", "mesh", "chips",
                                       "flops_per_dev", "bytes_per_dev",
                                       "coll_bytes_per_dev", "model_flops",
                                       "memory_per_dev")}


def _assert_roofline_tables(tt: str, jt: str):
    """Rows of two roofline tables (arch, shape, t_comp, t_mem, t_coll,
    bound, useful, roofline-MFU, GB/dev): the times within the 2-decimal
    rounding of the scaled JAX value, the MFU within the 1-decimal rounding
    of JAX's scaled as its bound says, the rest equal."""
    tl, jl = tt.splitlines(), jt.splitlines()
    assert len(tl) == len(jl) > 2 and tl[:2] == jl[:2]
    mfu_scale = {"comp": 1.0, "memo": R_COMPUTE / R_MEMORY,
                 "coll": R_COMPUTE / R_COLL}
    for a, b in zip(tl[2:], jl[2:]):
        ca, cb = _cells(a), _cells(b)
        assert len(ca) == len(cb) == 9
        for i, ratio in ((2, R_COMPUTE), (3, R_MEMORY), (4, R_COLL)):
            assert abs(_num(ca[i]) - _num(cb[i]) * ratio) <= \
                0.005 * (1 + ratio) + 1e-12 * _num(ca[i]), (i, a, b)
        scale = mfu_scale[ca[5][:4]]
        assert abs(_num(ca[7]) - _num(cb[7]) * scale) <= \
            0.05 * (1 + scale) + 1e-9, (a, b)
        for i in (0, 1, 5, 6, 8):
            assert ca[i] == cb[i], (i, a, b)


@needs_jax
def test_report_tables_match_jax(tmp_path):
    recs = _records()
    # status, memory and collective counts: no rate in them
    assert trep.dryrun_table(recs) == jrep.dryrun_table(recs)
    assert trep.dryrun_table(recs).count("\n") > 40
    _assert_roofline_tables(trep.roofline_table(recs),
                            jrep.roofline_table(recs))
    # roofline.table reads a directory of records.  JAX's raises on a
    # failed compile's record (no costs); the port's leaves it out
    for i, rec in enumerate(recs):
        (tmp_path / "all" / f"{i:03d}.json").parent.mkdir(exist_ok=True)
        (tmp_path / "all" / f"{i:03d}.json").write_text(json.dumps(rec))
        if "error" not in rec:
            (tmp_path / "ok" / f"{i:03d}.json").parent.mkdir(exist_ok=True)
            (tmp_path / "ok" / f"{i:03d}.json").write_text(json.dumps(rec))
    assert troof.load_records(str(tmp_path / "all")) == recs
    with pytest.raises(KeyError, match="cost_true"):
        jroof.table(str(tmp_path / "all"))
    _assert_roofline_tables(troof.table(str(tmp_path / "all")),
                            jroof.table(str(tmp_path / "ok")))
    # summary: counts and the bottleneck split equal; over compute-bound
    # records only, the lowest-MFU line too
    ts, js = trep.summary(recs).splitlines(), jrep.summary(recs).splitlines()
    assert ts[:2] == js[:2] and len(ts) == len(js) == 3
    compute = [r for r in recs if "cost_true" not in r
               or troof.from_record(r).bottleneck == "compute"]
    assert trep.summary(compute) == jrep.summary(compute)


def test_report_cli_renders_records_and_writes_out(tmp_path, capsys):
    rec = {"arch": "gemma-2b", "shape": "train_4k", "mesh": "single",
           "chips": 1, "step_kind": "train",
           "cost_true": {"flops": 989e12, "bytes": 3.35e11,
                         "collective_bytes": 0.0},
           "memory": {"temp_bytes": 2**30, "argument_bytes": 2**30},
           "model_flops": 494.5e12}
    (tmp_path / "recs").mkdir()
    (tmp_path / "recs" / "a.json").write_text(json.dumps(rec))
    out = tmp_path / "report.md"
    trep.main(["--dir", str(tmp_path / "recs"), "--out", str(out)])
    text = out.read_text()
    assert text in capsys.readouterr().out
    # one second of bf16 compute at the peak, 0.1 s of HBM: 50 % MFU
    assert "| gemma-2b | train_4k | 1000.00 | 100.00 | 0.00 | comp | 0.50 " \
        "| 50.0% | 2.0 |" in text
    assert "- 1 compiled ok, 0 skipped" in text


# ------------------------------------------------------------ metrics view


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory) -> dict:
    """The port's CPU serve run under the kernel-dispatch profiler."""
    path = tmp_path_factory.mktemp("snap") / "metrics.json"
    env = dict(os.environ, REPRO_KERNEL_PROFILE="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--telemetry", "on", "--metrics-out", str(path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    snap = json.loads(path.read_text())
    snap["path"] = str(path)
    return snap


def _faster(snap: dict, by: float) -> dict:
    snap = json.loads(json.dumps(snap))
    for r in snap["kernels"]["records"]:
        r["steady_us"] *= by
    return snap


def test_metrics_report_rows_from_the_serve_snapshot(snapshot, tmp_path,
                                                     capsys):
    recs = snapshot["kernels"]["records"]
    assert len(recs) > 4 and {r["op"] for r in recs} >= {"log_matmul",
                                                          "attention"}
    text = trep.metrics_report(snapshot)
    rows = [ln for ln in text.splitlines()
            if ln.startswith("| log_matmul") or ln.startswith("| attention")]
    assert len(rows) == len(recs)
    for r in recs:
        row = next(ln for ln in rows if f"`{r['key']}`" in ln)
        gbps = r["bytes"]["total"] / (r["steady_us"] * 1e-6) / 1e9
        assert f"| {gbps:.3f} |" in row
    assert "### Programs (the engine's timed prefill and decode calls)" \
        in text and "| decode |" in text and "serve_ttft_s" in text
    out = tmp_path / "r.md"
    trep.main(["--metrics", snapshot["path"], "--out", str(out)])
    assert out.read_text() == text
    assert text in capsys.readouterr().out


@needs_jax
@pytest.mark.parametrize("by", [1.0, 1e-4])
def test_metrics_report_matches_jax(snapshot, by):
    snap = _faster(snapshot, by)
    tl = trep.metrics_report(snap).splitlines()
    jl = jrep.metrics_report(snap).splitlines()
    assert len(tl) == len(jl)
    pct = re.compile(r"(\d+\.\d+)%")
    n_pct = 0
    for a, b in zip(tl, jl):
        if b.startswith("### Programs"):
            assert a == "### Programs (the engine's timed prefill and " \
                "decode calls)"
            continue
        pa, pb = pct.findall(a), pct.findall(b)
        assert pct.sub("%", a) == pct.sub("%", b)
        assert len(pa) == len(pb) <= 1
        for x, y in zip(pa, pb):
            n_pct += 1
            assert abs(float(x) - float(y) * R_MEMORY) <= \
                0.005 * (1 + R_MEMORY) + 1e-9, (a, b)
    assert n_pct == len(snap["kernels"]["records"])
    if by < 1:   # the column is no longer all zeros
        assert max(float(x) for ln in tl for x in pct.findall(ln)) > 1.0
