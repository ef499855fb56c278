"""§Perf hillclimb harness: trace one (arch × shape) cell with a named
config variant on the 16×16 production mesh, take the three roofline terms
at the H100's peaks, and append the iteration to
results/perf/<arch>__<shape>.jsonl.

Counterpart of `repro.launch.perf`, with its names, its 23 variants and
its CLI:

    PYTHONPATH=src python -m repro_torch.launch.perf --arch gemma3-1b \\
        --shape train_4k --variant heads_tp

Variants are config transforms registered in VARIANTS — the baseline is the
paper-faithful config ("baseline"); each hillclimb hypothesis is one named
variant.  The trace and its counters are the dry run's
(`launch.dryrun._compile` under a ``fake`` group of 256 ranks): one trace
counts every layer, so there is no unroll-diff; ``compile_s`` keeps JAX's
name and holds the trace's seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from ..analysis.roofline import Roofline, model_flops_for
from ..configs.base import SHAPES
from ..configs.registry import ARCH_NAMES, get_config
from .dryrun import _compile, _memory, _plain_cost, fake_group
from .mesh import make_production_mesh

# ----------------------------------------------------------------- variants


def _v(**kw):
    return lambda cfg: dataclasses.replace(cfg, **kw)


def _chain(*fns):
    def apply(cfg):
        for f in fns:
            cfg = f(cfg)
        return cfg
    return apply


BF16 = torch.bfloat16

VARIANTS = {
    "baseline": _v(),
    # H1: Megatron-style head sharding for q/k/v + attention out
    "heads_tp": _v(attn_shard="heads"),
    # H2: bf16 attention math (running stats stay f32)
    "attn_bf16": _v(attn_acc_dtype=BF16),
    # H3: GQA via broadcast einsum (no kv repeat)
    "gqa_bcast": _v(gqa_broadcast=True),
    # combinations
    "heads+bf16": _v(attn_shard="heads", attn_acc_dtype=BF16),
    "heads+bf16+bcast": _v(attn_shard="heads", attn_acc_dtype=BF16,
                           gqa_broadcast=True),
    # H4: paper technique on serving weights — packed logq6 codes
    "logq6": _v(quant="logq6"),
    "heads+bf16+logq6": _v(attn_shard="heads", attn_acc_dtype=BF16,
                           quant="logq6"),
    # H5: block size sweeps for the blockwise attention
    "block2048": _v(attn_block_k=2048),
    "block4096": _v(attn_block_k=4096),
    # H6: no remat (memory for flops trade)
    "noremat": _v(remat=False),
    "heads+bf16+noremat": _v(attn_shard="heads", attn_acc_dtype=BF16,
                             remat=False),
    # H7: sequence parallelism (query/residual seq-sharded over model)
    "seq_tp": _v(attn_shard="seq"),
    "seq_tp+res": _v(attn_shard="seq", residual_shard="seq"),
    "seq_tp+res+bf16": _v(attn_shard="seq", residual_shard="seq",
                          attn_acc_dtype=BF16),
    "seq_tp+res+bf16+bcast": _v(attn_shard="seq", residual_shard="seq",
                                attn_acc_dtype=BF16, gqa_broadcast=True),
    # H8: decode combos — head-whole layouts + no kv repeat + packed 6-bit
    # serving weights
    "heads+bcast": _v(attn_shard="heads", gqa_broadcast=True),
    "heads+bcast+logq6": _v(attn_shard="heads", gqa_broadcast=True,
                            quant="logq6"),
    "bcast+logq6": _v(gqa_broadcast=True, quant="logq6"),
    # H9: bf16 parameters — halves FSDP weight gathers and grad reductions
    "params_bf16": _v(param_dtype=BF16),
    "seq+all+params_bf16": _v(attn_shard="seq", residual_shard="seq",
                              attn_acc_dtype=BF16, gqa_broadcast=True,
                              param_dtype=BF16),
    # H10: Megatron-SP — activations gathered at block input, weights stay
    # TP-sharded, residual reduce-scattered
    "megatron_sp": _v(attn_shard="seq", residual_shard="seq",
                      sp_style="megatron", attn_acc_dtype=BF16,
                      gqa_broadcast=True),
    "megatron_sp+heads": _v(attn_shard="heads", residual_shard="seq",
                            sp_style="megatron", attn_acc_dtype=BF16,
                            gqa_broadcast=True),
}


def run_variant(arch: str, shape_name: str, variant: str, *,
                out_dir: str = "results/perf", note: str = "") -> dict:
    cfg = VARIANTS[variant](get_config(arch))
    sh = SHAPES[shape_name]
    t0 = time.time()
    with fake_group(256):
        mesh = make_production_mesh(device="cpu")
        _, count = _compile(cfg, shape_name, mesh)
    mem, cost, coll = _memory(count), _plain_cost(count), count.collectives()
    true = {"flops": cost["flops"], "bytes": cost["bytes"],
            "collective_bytes": coll["total"]}
    r = Roofline(arch=arch, shape=shape_name, mesh="single", chips=256,
                 flops_per_dev=true["flops"], bytes_per_dev=true["bytes"],
                 coll_bytes_per_dev=true["collective_bytes"],
                 model_flops=model_flops_for(cfg, sh),
                 memory_per_dev=mem["temp_bytes"] + mem["argument_bytes"])
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "note": note, "cost_true": true, "coll_by_type": coll["by_type"],
           "memory": mem, "row": r.row(),
           "compile_s": round(time.time() - t0, 1)}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"{arch}/{shape_name} [{variant}] "
          f"comp={r.t_compute*1e3:.1f}ms mem={r.t_memory*1e3:.1f}ms "
          f"coll={r.t_collective*1e3:.1f}ms → {r.bottleneck} "
          f"| step≥{r.step_time*1e3:.1f}ms mfu={r.mfu*100:.1f}% "
          f"| hbm/dev={r.memory_per_dev/2**30:.1f}GiB "
          f"({time.time()-t0:.0f}s)")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--variant", default="baseline",
                    choices=list(VARIANTS), nargs="+")
    ap.add_argument("--note", default="")
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args(argv)
    for v in (args.variant if isinstance(args.variant, list)
              else [args.variant]):
        run_variant(args.arch, args.shape, v, note=args.note, out_dir=args.out)


if __name__ == "__main__":
    main()
