"""Torch twins of the JAX package's benches (`benchmarks/`): the paper's
figures and tables (`fig1_quant`, `fig17_pe_cost`, `fig19_utilization`,
`fig20_throughput`, `table2_comparison`, `table3_latency`), the
gradient-compression ablation (`ablation_grad_compress`), and the kernel
and telemetry benches (`conv_kernels`, `attention_kernels`,
`telemetry_overhead`), timed on the card.

    python -m repro_torch.benchmarks.run                      # on the card
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only conv_kernels \
        --device cpu

Each module has ``run(device=None, root=None, ...) -> dict``.  The five
analytic paper benches touch no device and write no JSON, as in JAX; the
others write ``BENCH_torch_<name>.json`` (`common.write_json`): at the
repository root by default, under ``root`` when one is given.
"""
