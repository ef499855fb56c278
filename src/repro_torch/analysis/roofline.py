"""Three-term roofline from dry-run records, at one NVIDIA H100's peaks.

    compute    = flops_per_dev  / PEAK_FLOPS
    memory     = bytes_per_dev  / HBM_BW
    collective = coll_bytes     / NVLINK_BW

Counterpart of `repro.analysis.roofline` with the record schema unchanged:
a record holds ``cost_true.{flops,bytes,collective_bytes}`` (per device),
``memory.{temp_bytes,argument_bytes}`` and ``model_flops``, as the JAX
package's dry run writes them.  The port's dry run (ROADMAP.md queue A,
item 17) is to write the same records.

What stays out: JAX's ``collective_bytes()`` and its regexes, which read
the collectives out of XLA's optimized HLO text.  The port compiles no HLO;
its dry run is to count the collectives that its DTensor placements issue
(queue A, item 17) and put their bytes under ``collective_bytes``.

Hardware model: one NVIDIA H100 SXM, from NVIDIA's data sheet (dense
rates, no sparsity, at the 700 W power limit): 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s of HBM3, and
NVLink 900 GB/s a GPU in both directions together (18 fourth-generation
links), so 450 GB/s of sends: ``NVLINK_BW`` takes the place of JAX's
per-link ICI rate.  These constants are the port's one definition of the
card's peaks; `repro_torch.benchmarks.common` and ``chip_smoke.py`` import
them from here.
"""

from __future__ import annotations

import dataclasses
import json
import os

PEAK_FLOPS = 989e12          # bf16 / card, tensor cores
PEAK_FP32_FLOPS = 67e12      # fp32 / card, CUDA cores
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s a card sends over NVLink


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float          # per device, as the dry run counts them
    bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops: float            # 6·N_active·D (train) or 2·N_active·D
    memory_per_dev: float         # peak: temp + argument bytes

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower bound: perfectly overlapped terms → max; report max."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / device FLOPs — catches remat/redundancy waste."""
        total_hlo = self.flops_per_dev * self.chips
        return self.model_flops / total_hlo if total_hlo else float("nan")

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline-bound step time."""
        t = self.step_time
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / t if t else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_mfu": self.mfu,
            "mem_gb_per_dev": self.memory_per_dev / 2**30,
        }


def model_flops_for(cfg, shape: dict) -> float:
    """Analytic MODEL_FLOPS for the cell: 6·N_active·D (train) /
    2·N_active·D (inference), D = tokens processed in the step."""
    n = cfg.active_param_count()
    if shape["step"] == "train":
        tokens = shape["seq_len"] * shape["global_batch"]
        return 6.0 * n * tokens
    if shape["step"] == "prefill":
        tokens = shape["seq_len"] * shape["global_batch"]
        return 2.0 * n * tokens
    return 2.0 * n * shape["global_batch"]  # decode: 1 token/seq


def from_record(rec: dict) -> Roofline:
    """Build a Roofline from one dry-run JSON record."""
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        chips=rec["chips"],
        flops_per_dev=rec["cost_true"]["flops"],
        bytes_per_dev=rec["cost_true"]["bytes"],
        coll_bytes_per_dev=rec["cost_true"]["collective_bytes"],
        model_flops=rec["model_flops"],
        memory_per_dev=rec["memory"]["temp_bytes"]
        + rec["memory"]["argument_bytes"])


def load_records(directory: str) -> list[dict]:
    recs = []
    for f in sorted(os.listdir(directory)):
        if f.endswith(".json"):
            with open(os.path.join(directory, f)) as fh:
                recs.append(json.load(fh))
    return recs


def table(directory: str) -> str:
    """Markdown roofline table from a directory of dry-run records.  A
    record without costs (a failed compile) is left out, as
    `report.roofline_table` leaves it; JAX's `table` raises on one."""
    rows = []
    for rec in load_records(directory):
        if rec.get("skipped") or rec.get("mesh") != "single" \
                or "cost_true" not in rec:
            continue
        rows.append(from_record(rec).row())
    hdr = ("| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
           "bottleneck | useful | roofline-MFU | GB/dev |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']*1e3:.2f} "
            f"| {r['t_memory_s']*1e3:.2f} | {r['t_collective_s']*1e3:.2f} "
            f"| {r['bottleneck']} | {r['useful_ratio']:.2f} "
            f"| {r['roofline_mfu']*100:.1f}% | {r['mem_gb_per_dev']:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args(argv)
    print(table(args.dir))


if __name__ == "__main__":
    main()
