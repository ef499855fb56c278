"""The twins of the paper's benches (`repro_torch.benchmarks`: fig1_quant,
fig17_pe_cost, fig19_utilization, fig20_throughput, table2_comparison,
table3_latency, ablation_grad_compress) against the JAX package's
(`benchmarks/`, a namespace package at the repository root), on the CPU:

  * the five analytic twins: their result dicts equal the JAX `run()`'s
    (rows and derived numbers, floats within 1e-12 relative), and they
    print the same tables;
  * fig1_quant: each scheme's SNRs on the bench's numpy draws within
    0.01 dB of JAX's; each scheme's VGG-16 logit correlation on JAX's
    weights and input (carried across with `params_from_numpy`) within
    1e-4 of JAX's; the same verdict;
  * ablation_grad_compress: both packages start from JAX's
    `init_params(cfg, PRNGKey(0))` on the same batches for the bench's 60
    steps.  The first loss within 1e-5 relative; each mode's final 10-step
    average within ``FINAL_TOL`` nats of JAX's (measured on an 8-core
    Intel Xeon CPU at 7.2e-8 for fp32, 3.1e-5 for log-EF and 4.7e-4 for
    log-naive: a log code that rounds the other way in one package is
    carried on by AdamW's sign-like steps); ``ef_gap`` under the bench's
    0.15 gate in both, with the same ``ok``.

On the machine with the card (no JAX) the comparisons skip and the twins
run on their own.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:   # the JAX benches: `benchmarks` at the root
    sys.path.insert(0, str(ROOT))
try:  # the machine with the card has no JAX: the JAX comparisons skip
    import jax
    import jax.numpy as jnp
    from benchmarks import ablation_grad_compress as jablation
    from benchmarks import (fig1_quant as jfig1, fig17_pe_cost as jfig17,
                            fig19_utilization as jfig19,
                            fig20_throughput as jfig20,
                            table2_comparison as jtable2,
                            table3_latency as jtable3)
    from repro.configs.registry import get_config as jget
    from repro.core.logquant import quantization_snr_db as jsnr
    from repro.data.pipeline import DataConfig, ShardedLoader
    from repro.models import cnn as jcnn
    from repro.models import transformer as jt
except ImportError:
    jax = None

from repro_torch.benchmarks import (ablation_grad_compress,  # noqa: E402
                                    fig1_quant, fig17_pe_cost,
                                    fig19_utilization, fig20_throughput, run,
                                    table2_comparison, table3_latency)
from repro_torch.core.logquant import quantization_snr_db  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

ANALYTIC = {"fig17_pe_cost": fig17_pe_cost,
            "fig19_utilization": fig19_utilization,
            "fig20_throughput": fig20_throughput,
            "table2_comparison": table2_comparison,
            "table3_latency": table3_latency}
FINAL_TOL = {"fp32": 1e-5, "log-EF": 2e-3, "log-naive": 2e-3}


def _assert_same(got, want, path="out"):
    """Equal trees: same keys, lengths and types; floats within 1e-12."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        assert math.isclose(got, want, rel_tol=1e-12), (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("name", sorted(ANALYTIC))
def test_analytic_twin_reproduces_the_paper(name, tmp_path, monkeypatch):
    """Each analytic twin reads REPRODUCED, touches no device and writes
    no file."""
    monkeypatch.chdir(tmp_path)
    out = ANALYTIC[name].run(root=tmp_path)
    assert out["ok"] is True
    assert not list(tmp_path.iterdir())


@needs_jax
@pytest.mark.parametrize("name", sorted(ANALYTIC))
def test_analytic_twin_equals_jax(name, capsys):
    jmod = {"fig17_pe_cost": jfig17, "fig19_utilization": jfig19,
            "fig20_throughput": jfig20, "table2_comparison": jtable2,
            "table3_latency": jtable3}[name]
    want = jmod.run()
    jprinted = capsys.readouterr().out
    got = ANALYTIC[name].run()
    _assert_same(got, want)
    assert capsys.readouterr().out == jprinted


# ------------------------------------------------------------ fig1_quant


@needs_jax
def test_fig1_snr_matches_jax():
    rng = np.random.default_rng(0)
    dists = {
        "normal*0.05": rng.normal(size=65536).astype(np.float32) * 0.05,
        "laplace": rng.laplace(size=65536).astype(np.float32) * 0.03,
    }
    rows = fig1_quant.snr_rows("cpu")
    assert [r["scheme"] for r in rows] == list(jfig1.SCHEMES)
    for row, (name, jscheme) in zip(rows, jfig1.SCHEMES.items()):
        tscheme = fig1_quant.SCHEMES[name]
        for dname, w in dists.items():
            want = jsnr(w, jfig1._quantize(w, jscheme))
            got = quantization_snr_db(
                w, fig1_quant._quantize(torch.as_tensor(w), tscheme))
            assert abs(got - want) <= 0.01, (name, dname, got, want)
            assert abs(row[f"snr_{dname}_db"] - round(want, 2)) <= \
                0.01 + 1e-9
    assert rows[2]["snr_normal*0.05_db"] > rows[1]["snr_normal*0.05_db"] + 4


@needs_jax
def test_fig1_logit_fidelity_matches_jax():
    """JAX's weights and images at the bench's size, through both
    packages' fake-quant VGG-16 forwards; the verdict from each package's
    own numbers."""
    params, apply_fp = jcnn.make_cnn(
        "vgg16", jax.random.PRNGKey(1), n_classes=fig1_quant.N_CLASSES,
        width_mult=fig1_quant.WIDTH_MULT)
    x = jax.random.normal(jax.random.PRNGKey(2), (
        fig1_quant.BATCH, fig1_quant.IMG, fig1_quant.IMG, 3))
    fwd = jax.jit(apply_fp)
    ref = np.asarray(fwd(params, x)).ravel()
    want = {}
    for name, scheme in jfig1.SCHEMES.items():
        qparams = jax.tree.map(
            lambda w: jnp.asarray(jfig1._quantize(np.asarray(w), scheme))
            if w.ndim >= 2 else w, params)
        want[name] = float(np.corrcoef(ref, np.asarray(fwd(qparams, x))
                                       .ravel())[0, 1])
    tparams = tcnn.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    got = fig1_quant.logit_fidelity(
        tparams, torch.as_tensor(np.array(x)), device="cpu")
    assert list(got) == list(want)
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-4, (name, got, want)
    w = np.random.default_rng(0).normal(size=65536).astype(np.float32) \
        * 0.05
    jsnr_ = {n: round(jsnr(w, jfig1._quantize(w, s)), 2)
             for n, s in jfig1.SCHEMES.items()}
    tsnr = {r["scheme"]: r["snr_normal*0.05_db"]
            for r in fig1_quant.snr_rows("cpu")}

    def verdict(snr, fid):
        return snr[fig1_quant.SQRT2] > snr[fig1_quant.BASE2] + 4.0 and \
            fid[fig1_quant.SQRT2] > fid[fig1_quant.BASE2]
    assert verdict(tsnr, got) is verdict(jsnr_, want) is True


def test_fig1_twin_runs_and_writes_its_json(tmp_path):
    out = fig1_quant.run(device="cpu", root=tmp_path)
    assert out["ok"] and out["size"] == {"width_mult": 0.25, "img": 32,
                                         "n_classes": 100, "batch": 4}
    assert out["snr_gain_db"] > 4.0
    assert (tmp_path / "BENCH_torch_fig1_quant.json").exists()
    small = fig1_quant.run(device="cpu", root=tmp_path / "small",
                           width_mult=0.125, img=16, n_classes=10, batch=2)
    assert small["size"]["img"] == 16
    assert set(small["logit_corr"]) == set(fig1_quant.SCHEMES)


# ------------------------------------------------------------ ablation


@pytest.fixture(scope="module")
def ablation():
    """Both packages' three trainings from JAX's initial parameters."""
    jcfg = jget("gemma-2b").reduced(n_layers=2, vocab=256, d_model=64,
                                    d_ff=128, head_dim=16)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    batch = ShardedLoader(DataConfig(seq_len=32, global_batch=8, vocab=256,
                                     seed=3)).batch(0)
    first = float(jt.lm_loss(jparams, batch, jcfg, xent_chunk=32)[0])
    res = {"jax_first": first, "jax": {}, "torch": {}}
    for mode in ablation_grad_compress.MODES:
        res["jax"][mode] = jablation._train(mode)
        res["torch"][mode] = ablation_grad_compress._train(
            mode, tt.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu"), device="cpu")
    return res


@needs_jax
def test_ablation_first_loss_matches_jax(ablation):
    for mode, losses in ablation["torch"].items():
        assert len(losses) == ablation_grad_compress.STEPS
        assert math.isclose(losses[0], ablation["jax_first"],
                            rel_tol=1e-5), mode


@needs_jax
def test_ablation_final_losses_and_gap_match_jax(ablation):
    final = {m: sum(v[-10:]) / 10 for m, v in ablation["torch"].items()}
    for mode, want in ablation["jax"].items():
        assert abs(final[mode] - want) <= FINAL_TOL[mode], \
            (mode, final[mode], want)
    gaps = {"torch": final["log-EF"] - final["fp32"],
            "jax": ablation["jax"]["log-EF"] - ablation["jax"]["fp32"]}
    oks = {k: abs(g) < ablation_grad_compress.EF_GAP_LIMIT
           for k, g in gaps.items()}
    assert oks["torch"] is oks["jax"] is True, gaps


def test_ablation_twin_runs_and_writes_its_json(tmp_path):
    """The port alone, from its own initial weights: the EF gap holds."""
    out = ablation_grad_compress.run(device="cpu", root=tmp_path)
    assert out["ok"] and out["steps"] == ablation_grad_compress.STEPS
    assert set(out["final_loss"]) == set(ablation_grad_compress.MODES)
    assert all(math.isfinite(v) for v in out["final_loss"].values())
    assert (tmp_path / "BENCH_torch_ablation_grad_compress.json").exists()


# ------------------------------------------------------------ run.py


def test_run_lists_all_ten_twins_with_jax_derived_keys():
    assert list(run.BENCHES) == [
        "fig1_quant", "conv_kernels", "attention_kernels", "fig17_pe_cost",
        "fig19_utilization", "fig20_throughput", "table2_comparison",
        "table3_latency", "ablation_grad_compress", "telemetry_overhead"]
    keys = {n: k for n, (_, k) in run.BENCHES.items()
            if n in run.PAPER_BENCHES}
    assert keys == {"fig1_quant": "snr_gain_db",
                    "fig17_pe_cost": "tput_per_pe",
                    "fig19_utilization": None,
                    "fig20_throughput": "adjusted_pes",
                    "table2_comparison": "peak_gops",
                    "table3_latency": "total_ms",
                    "ablation_grad_compress": "ef_gap"}


def test_run_cli_prints_reproduced_for_the_paper_benches(tmp_path, capsys):
    res = {}
    assert run.main(["--only", *sorted(ANALYTIC), "fig1_quant", "--device",
                     "cpu", "--out", str(tmp_path)], results=res) == 0
    assert set(res) == set(ANALYTIC) | {"fig1_quant"}
    out = capsys.readouterr().out
    for name in res:
        assert any(ln.startswith(f"{name},") and ln.endswith("[REPRODUCED]")
                   for ln in out.splitlines()), name
    assert "ALL PAPER CLAIMS REPRODUCED" in out
    assert [p.name for p in tmp_path.iterdir()] == \
        ["BENCH_torch_fig1_quant.json"]
