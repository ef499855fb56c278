"""The output check, driven through whole runs of each cell at 32 px on the
CPU (the harness's look for a card skipped): a sound run comes out
correct; the control in the program's place, and each fault planted under
the timed path, come out not correct.  A CNN forward keeps no state and
runs on one card, so a state left unchanged and a lost exchange between
cards are not faults these cells can have."""

import json
import subprocess
import sys
import time

import pytest
import torch

import control
import harness
import program
from conftest import ROOT
from reference import check

CELLS = ("vgg16.ms8", "resnet34.offline128")
SEED = 2 ** 31 + 4242
CPU = torch.device("cpu")


def _run(cell):
    return harness.run_cell(cell, SEED, 0.3, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    r = _run(tiny_cell(name))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert {m for m in r["metrics"]} == {m["name"] for m in
                                         tiny_cell(name).end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_plain_versions(tiny_cell, name):
    """Stage by stage against the port's plain ``conv_impl="ref"`` (im2col
    against `ref_log_matmul`), another summation order than the reference's
    `F.conv2d`."""
    cell = tiny_cell(name)
    gen = torch.Generator().manual_seed(SEED)
    weights = harness.draw_weights(cell.config, gen, CPU)
    x = torch.randn((2, 32, 32, 3), generator=gen)
    prog = program.Program(cell.config, weights)
    rec = {}
    with prog.capture(rec), torch.no_grad():
        logits = prog.apply(prog.packed, x, quant="logq6", qcfg=prog.qcfg,
                            conv_impl="ref")
    got = check.compare(cell.config, weights, x, rec, logits)
    assert len(rec) == len(harness.costs.conv_shapes(cell.config, 2))
    assert got["conv_gap"] < 1e-5 and got["logit_gap"] < 1e-5
    assert got["act_mismatch"] == 0.0


@pytest.mark.parametrize("precision", ["control", "tf32", "bf16_quant"])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_cell, name, precision):
    r = control.readings(tiny_cell(name), [SEED], 0.3, CPU,
                         check.PRECISIONS[precision])
    assert r[0]["correct"] is False, r


def _conv_output_altered(monkeypatch):
    from repro_torch.kernels import ops
    plain = ops.log_conv2d_blockwise
    n = {"calls": 0}

    def altered(*a, **k):
        y = plain(*a, **k)
        n["calls"] += 1
        if n["calls"] % 5 == 3:    # one conv in five, one element
            y = y.clone()
            y[0, 0, 0, 0] += 0.01 * float(y.abs().max())
        return y
    monkeypatch.setattr(ops, "log_conv2d_blockwise", altered)


def _forward_broken(monkeypatch, how):
    forward = program.Program.forward

    def broken(self, x):
        if how == "half_batch":     # the second half left out, copied over
            h = x.shape[0] // 2
            out = forward(self, x[:h])
            return torch.cat([out, out[: x.shape[0] - h]])
        out = forward(self, x).clone()
        out[0, 0] += 0.01 * float(out.abs().max())   # one logit altered
        return out
    monkeypatch.setattr(program.Program, "forward", broken)


@pytest.mark.parametrize("fault", ["conv_output", "logit", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny_cell, monkeypatch, name, fault):
    cell = tiny_cell(name)
    if fault == "conv_output":
        _conv_output_altered(monkeypatch)
    else:
        _forward_broken(monkeypatch, fault)
    r = _run(cell)
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_run_on_the_card(cuda_device, name):
    """The command as the benchmark is run, a short window."""
    r = subprocess.run([sys.executable, "bench/run.py", "--workload", name,
                        "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
