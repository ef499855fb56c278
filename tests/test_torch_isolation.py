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
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tcnn.make_cnn("vgg16", 0, n_classes=10,
                                       width_mult=0.125),
                 lambda: tcnn.params_from_numpy({"w": [1.0]}),
                 lambda: PEGrid(mode="log"), lambda: LogPEThread(),
                 lambda: ex.train_quantized_cnn(steps=1),
                 lambda: ex.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params, _ = tcnn.make_cnn("vgg16", 0, n_classes=10, width_mult=0.125,
                              device="cpu")
    assert params["head"]["w"].device.type == "cpu"
    grid = PEGrid(mode="log", device="cpu")
    assert grid.device.type == grid.thread.lut.device.type == "cpu"


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
