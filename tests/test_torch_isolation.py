"""The port stands alone: no module of `repro_torch`, and not
`chip_smoke.py`, imports `jax` or the JAX package `repro`; and its entry
points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import cnn as tcnn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return mods


def test_port_sources_import_neither_jax_nor_repro():
    assert len(PORT_FILES) >= 10
    models = {p.name for p in PORT_FILES if p.parent.name == "models"}
    assert {"griffin.py", "moe.py", "rwkv.py", "transformer.py"} <= models
    obs = {p.name for p in PORT_FILES if p.parent.name == "obs"}
    assert "kernel_profile.py" in obs
    benches = {p.name for p in PORT_FILES if p.parent.name == "benchmarks"}
    assert {"common.py", "conv_kernels.py", "attention_kernels.py",
            "telemetry_overhead.py", "run.py"} <= benches
    by_dir = {d: {p.name for p in PORT_FILES if p.parent.name == d}
              for d in ("data", "training", "runtime", "launch", "examples")}
    assert "pipeline.py" in by_dir["data"]
    assert {"optimizer.py", "grad_compress.py", "train_loop.py"} <= \
        by_dir["training"]
    assert {"checkpoint.py", "monitor.py"} <= by_dir["runtime"]
    assert "train.py" in by_dir["launch"]
    assert {"quickstart.py", "serve_lm.py", "train_lm.py"} <= \
        by_dir["examples"]
    for path in PORT_FILES:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_imports_with_jax_blocked():
    """Import every module of the port (and chip_smoke.py) in a fresh
    interpreter in which `jax` and `repro` cannot be imported."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            .removesuffix(".__init__")
            for p in PORT_FILES if p.name != "chip_smoke.py"]
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and\n"
            "       m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """Without a card, `make_cnn`, `params_from_numpy`, the hardware oracle
    (`PEGrid`, `LogPEThread`) and the end-to-end example raise unless the
    caller asks for the CPU."""
    from repro_torch.core.logmath import LogPEThread
    from repro_torch.core.pe_grid import PEGrid
    from repro_torch.examples import cnn_accelerator_sim as ex
    from repro_torch.examples import quickstart, serve_lm, train_lm
    from repro_torch.launch import train
    from repro_torch.training.train_loop import train_state_from_numpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tcnn.make_cnn("vgg16", 0, n_classes=10,
                                       width_mult=0.125),
                 lambda: tcnn.params_from_numpy({"w": [1.0]}),
                 lambda: PEGrid(mode="log"), lambda: LogPEThread(),
                 lambda: ex.train_quantized_cnn(steps=1),
                 lambda: ex.main([]),
                 lambda: train.main(["--reduced", "--steps", "1"]),
                 lambda: train_state_from_numpy({"step": 0}),
                 lambda: quickstart.main([]), lambda: serve_lm.main([]),
                 lambda: train_lm.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params, _ = tcnn.make_cnn("vgg16", 0, n_classes=10, width_mult=0.125,
                              device="cpu")
    assert params["head"]["w"].device.type == "cpu"
    grid = PEGrid(mode="log", device="cpu")
    assert grid.device.type == grid.thread.lut.device.type == "cpu"


def test_check_supported_is_gone_and_the_engine_refuses_embedding_archs():
    """Every arch builds and runs a forward now (ROADMAP.md queue A, item
    14 closed); the serving engine still refuses the archs fed with
    embeddings, as the JAX engine does."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServeEngine
    assert not hasattr(transformer, "check_supported")
    for arch in ("musicgen-large", "qwen2-vl-2b"):
        cfg = get_config(arch).reduced()
        params = transformer.init_params(cfg, 0, device="cpu")
        cache = transformer.init_cache(cfg, 1, 8, device="cpu")
        assert cache["index"] == 0
        with pytest.raises(ValueError, match="engine serves token archs"):
            ServeEngine(cfg, params)


def test_autotune_modules_stand_alone(tmp_path, monkeypatch):
    """The tuner and `build_autotune_table` are port files like the others
    (no `jax`, no `repro`), the table tool's ``--measure`` refuses without
    a card, and
    the package data ships the packaged table."""
    from repro_torch.tools import build_autotune_table
    files = {p.relative_to(ROOT / "src" / "repro_torch").as_posix(): p
             for p in PORT_FILES if p.name != "chip_smoke.py"}
    for name in ("kernels/autotune.py", "tools/build_autotune_table.py"):
        assert name in files
        for mod in _imported_modules(files[name]):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_autotune_table.main(["--measure",
                                   "--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert '"repro_torch.kernels" = ["csrc/*.cu", "autotune_tables/*.json"]' \
        in pyproject
    assert (ROOT / "src" / "repro_torch" / "kernels" / "autotune_tables"
            / "cuda.json").exists()


@pytest.mark.parametrize("module", [
    "repro_torch.tools.time_autotune_candidates",
    "repro_torch.benchmarks.dispatch_overhead"])
def test_card_timing_scripts_refuse_without_a_card(module, tmp_path,
                                                   monkeypatch):
    """The scripts that time launches on the card (every autotune
    candidate; the host cost of a dispatch) raise without one and write
    nothing."""
    import importlib
    mod = importlib.import_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()


def test_launch_train_refuses_production_naming_the_roadmap():
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="queue A, item 17"):
        train.main(["--production", "--reduced", "--device", "cpu"])


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code != 0
    assert '"ok": true' not in capsys.readouterr().out
