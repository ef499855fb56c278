"""Torch twins of the JAX package's kernel and telemetry benches
(`benchmarks/conv_kernels.py`, `attention_kernels.py`,
`telemetry_overhead.py`), timed on the card.

    python -m repro_torch.benchmarks.run                      # on the card
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only conv_kernels \
        --device cpu

Each module has ``run(device=None, root=None, ...) -> dict`` and writes
``BENCH_torch_<name>.json`` (`common.write_json`): at the repository root
by default, under ``root`` when one is given.
"""
