import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def bench_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def tiny_cell(bench_json):
    """A cell of the benchmark at a size the CPU runs in a second: 32 px
    images, batches of 2, every width as configured."""
    import harness

    def make(name):
        cell = harness.Cell(bench_json, name, ROOT)
        cell.config["image_size"] = 32
        cell.traffic.update(batch=2, pool_batches=2, warmup_queries=1,
                            check_queries=2, trace_queries=2)
        return cell
    return make


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
