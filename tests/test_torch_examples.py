"""The port's example twins (`repro_torch.examples.quickstart`,
`serve_lm`, `train_lm`) against the JAX scripts under `examples/`, on the
CPU:

  * quickstart: the same five printed figures;
  * serve_lm: the same ten requests on the same weights (JAX's, bridged
    with `params_from_numpy`) give the JAX engine's greedy tokens, and the
    spot check against naive decode holds;
  * train_lm: the same scaled config (size, width, depth) as the JAX
    script's, and its smallest size trained 2 steps at batch 1 × 16 on
    JAX's initial weights gives JAX's first loss and gradient norm
    (bf16 activations: within 8e-3 relative, the repo's bf16 tolerance)
    and a second loss within 2e-2; a second run on the same checkpoint
    directory resumes.
"""

import contextlib
import io
import os
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")

from repro_torch.examples import quickstart as tquick  # noqa: E402
from repro_torch.examples import serve_lm as tserve  # noqa: E402
from repro_torch.examples import train_lm as ttrain  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")


def _jax_example(name: str):
    """The JAX script ``examples/<name>.py`` as a module (not run)."""
    sys.path.insert(0, str(EXAMPLES))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(EXAMPLES))


def test_quickstart_prints_the_jax_scripts_figures():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(EXAMPLES / "quickstart.py"), run_name="__main__")
    want = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tquick.main(["--device", "cpu"])
    got = buf.getvalue().splitlines()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert NUM.findall(g) == NUM.findall(w), (g, w)
    assert out["grid_matches"] and out["log_matmul_err"] < 1e-5


def test_serve_lm_greedy_tokens_equal_the_jax_engines():
    from repro.models import transformer as jt
    from repro.serving.engine import EngineConfig, Request, ServeEngine
    cfg_t = tserve.config()
    jmod = _jax_example("serve_lm")
    cfg_j = jmod.get_config("gemma3-1b").reduced(n_layers=4)
    jp = jt.init_params(cfg_j, jax.random.PRNGKey(0))
    # the JAX script's engine and requests, without its (slow, eager)
    # naive-decode spot check
    engine = ServeEngine(cfg_j, jp, EngineConfig(max_batch=4, max_prompt=32,
                                                 max_len=64))
    rng = np.random.default_rng(0)
    for uid in range(10):
        T = int(rng.integers(3, 16))
        prompt = rng.integers(1, cfg_j.vocab, size=T).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=12,
                              temperature=0.0 if uid % 2 else 0.8,
                              seed=uid))
    want = {r.uid: r.output for r in engine.run() if r.temperature == 0.0}
    done, ok = tserve.run(cfg_t, tt.params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu"))
    got = {r.uid: r.output for r in done if r.temperature == 0.0}
    assert ok and len(done) == 10
    assert got == want and len(got) == 5


def test_train_lm_matches_the_jax_script(tmp_path, capsys):
    from repro.data.pipeline import DataConfig, ShardedLoader
    from repro.models import transformer as jt
    from repro.training.optimizer import OptimizerConfig
    from repro.training.train_loop import TrainConfig, train
    jmod = _jax_example("train_lm")
    for m in (1, 100, 300):
        jc, tc = jmod.scaled_config(m), ttrain.scaled_config(m)
        assert (tc.d_model, tc.d_ff, tc.n_layers, tc.param_count()) == \
            (jc.d_model, jc.d_ff, jc.n_layers, jc.param_count())
    # the JAX script's run at its smallest size, 2 steps of 1 × 16
    cfg = jmod.scaled_config(1)
    jp = jt.init_params(cfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)   # JAX's train donates jp
    tcfg = TrainConfig(opt=OptimizerConfig(lr=3e-3, warmup_steps=30,
                                           total_steps=2),
                       grad_compress=True, log_every=20, xent_chunk=16)
    _, want = train(lambda p, b: jt.lm_loss(p, b, cfg, xent_chunk=16), jp,
                    ShardedLoader(DataConfig(seq_len=16, global_batch=1,
                                             vocab=cfg.vocab, seed=0)),
                    tcfg, num_steps=2)
    argv = ["--steps", "2", "--params-m", "1", "--batch", "1", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    got = ttrain.run(ttrain.parse_args(argv),
                     tt.params_from_numpy(np_params, device="cpu"))
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1]
    for k in ("loss", "grad_norm"):   # bf16: the repo's 8e-3
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=8e-3)
    np.testing.assert_allclose(got[1]["loss"], want[1]["loss"], rtol=2e-2)
    assert "model: 47M params, d=512, 8L, quant=logq6" in \
        capsys.readouterr().out


def test_train_lm_resumes_from_its_checkpoint_directory(tmp_path, capsys,
                                                        monkeypatch):
    """A second run on the same checkpoint directory resumes at the saved
    step (the scaled config swapped for a reduced one, to stay small)."""
    small = ttrain.get_config("gemma-2b").reduced(quant="logq6")
    monkeypatch.setattr(ttrain, "scaled_config", lambda params_m: small)
    argv = ["--steps", "2", "--batch", "2", "--seq", "16", "--device",
            "cpu", "--ckpt-dir", str(tmp_path)]
    first = ttrain.run(ttrain.parse_args(argv))
    assert [h["step"] for h in first] == [0, 1]
    argv[1] = "3"
    again = ttrain.run(ttrain.parse_args(argv))
    assert [h["step"] for h in again] == [2]
    assert "resumed from step 2" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                            "step_000000003"]
