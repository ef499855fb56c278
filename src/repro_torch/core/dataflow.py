"""Analytical model of the 2D weight-broadcast dataflow (§5, Figs. 6-16),
counterpart of `repro.core.dataflow`.

`core/pe_grid.py` executes the dataflow; this module *counts* it — cycles,
thread utilization, psum-storage fraction and DDR traffic for arbitrary layer
shapes — fast enough to walk whole CNNs (Fig. 19/20, Tables 2/3).

Derivation (verified against the paper's own worked examples):

3×3, stride s (§5.1):  a 6-row band × 3-col window slides one column per
cycle → positions = ceil((W' - 2) / s) cycles per band, bands = ceil(H'/6),
one input channel per PE matrix (6 in flight), one filter per pass:
    cycles = ceil(C/6) · P · bands · positions
Paper example 12×6 input, s=1: 2 bands × 4 positions = 8 cycles, 360 MACs
→ 45 OPS/cycle = 83.3 % of one matrix's 54 threads, 3/18 psums stored.

1×1 (§5.2):  3 channels per PE (one per thread), 18 pixel slots per matrix,
18 channels in flight across 6 matrices, channel accumulation at net-1:
    cycles = ceil(HW/18) · P · ceil(C/18)
Paper example 6×6×6 × (1×1×6 ×6): 2 pixel tiles × 6 filters = 12 cycles,
1296 MACs → 108 OPS/cycle = 100 % of the two active matrices.

K∈{4,5} (§5.3): width > 3 needs ceil(K/3) column loads per position
(Fig. 14), outputs assembled from old+new psums (eqs. 9-10).

Depthwise 3×3: one filter per channel → the P factor collapses to 1.
"""

from __future__ import annotations

import dataclasses
import math

from .pe_grid import N_MATRICES, PE_COLS, PE_ROWS, THREADS, TOTAL_THREADS

CLOCK_HZ = 200e6                       # Zynq-7020 processing clock
PEAK_OPS_PER_CYCLE = TOTAL_THREADS     # 324 (1 MAC = 1 OP, §5.1 accounting)
PEAK_GOPS_PAPER = 324.0                # Table-2 accounting: util × 324 GOPS


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One CNN layer as the accelerator sees it."""
    name: str
    kind: str          # conv | dwconv | pwconv (1x1) | pool
    H: int             # input height
    W: int             # input width
    C: int             # input channels
    P: int             # output channels (== C for dwconv/pool)
    K: int = 3         # kernel size
    stride: int = 1
    pad: int = 0

    @property
    def Ho(self) -> int:
        return (self.H + 2 * self.pad - self.K) // self.stride + 1

    @property
    def Wo(self) -> int:
        return (self.W + 2 * self.pad - self.K) // self.stride + 1

    @property
    def macs(self) -> int:
        per_out = self.K * self.K * (1 if self.kind in ("dwconv", "pool") else self.C)
        return self.Ho * self.Wo * self.P * per_out


@dataclasses.dataclass
class LayerPerf:
    spec: LayerSpec
    cycles: int
    useful_macs: int
    stored_psum_frac: float
    ddr_bytes_log: int     # 7-bit codes (6+sign), weights+ifmap+ofmap
    ddr_bytes_fp16: int    # 16-bit baseline for the same traffic

    @property
    def utilization(self) -> float:
        return self.useful_macs / (self.cycles * PEAK_OPS_PER_CYCLE)

    @property
    def latency_ms(self) -> float:
        return self.cycles / CLOCK_HZ * 1e3

    @property
    def gops_paper(self) -> float:
        """Table-2 accounting (throughput = utilization × 324 GOPS)."""
        return self.utilization * PEAK_GOPS_PAPER

    @property
    def gmacs_per_s(self) -> float:
        return self.useful_macs / (self.cycles / CLOCK_HZ) / 1e9


def _traffic(spec: LayerSpec) -> tuple[int, int]:
    """DDR bytes moved for the layer (no psum traffic — §4.1: all psums stay
    on-chip).  ifmap + weights + ofmap, once each (weight/input reuse in SRAM)."""
    n_in = spec.H * spec.W * spec.C
    n_w = spec.K * spec.K * (1 if spec.kind in ("dwconv", "pool") else spec.C) * spec.P
    n_out = spec.Ho * spec.Wo * spec.P
    bits_log = 7 * (n_in + n_out) + 7 * n_w        # 6-bit log + sign
    bits_fp16 = 16 * (n_in + n_out + n_w)
    return (bits_log + 7) // 8, (bits_fp16 + 7) // 8


def analyze_layer(spec: LayerSpec) -> LayerPerf:
    Hp = spec.H + 2 * spec.pad
    Wp = spec.W + 2 * spec.pad
    if spec.kind == "pwconv" or spec.K == 1:
        pix_tiles = math.ceil(spec.H * spec.W / (PE_ROWS * PE_COLS))
        cgroups = math.ceil(spec.C / (N_MATRICES * THREADS))
        cycles = pix_tiles * spec.P * cgroups
        stored_frac = 0.0
    elif spec.kind == "dwconv":
        bands = spec.Ho * spec.stride / PE_ROWS  # streamed (VAR-len SR)
        positions = spec.Wo
        cycles = math.ceil(math.ceil(spec.C / N_MATRICES) * bands * positions)
        stored_frac = 3.0 / 18.0
    elif spec.kind == "pool":
        # pooling reuses the conv path with the chosen stride/kernel (§5.3)
        bands = spec.Ho * spec.stride / PE_ROWS
        positions = spec.Wo
        cycles = math.ceil(math.ceil(spec.C / N_MATRICES) * bands * positions)
        stored_frac = 0.0
    else:  # standard conv, K in {3, 4, 5}
        col_loads = math.ceil(spec.K / PE_COLS)
        # Bands stream row-continuously: the boundary psums ride the VAR-len
        # shift registers, so band count is fractional Ho·s/6 (each band pass
        # yields 6/s output rows).  This reproduces the paper's Table-3
        # per-layer latencies to ≤2 % (except conv1_1 — see EXPERIMENTS.md).
        bands = spec.Ho * spec.stride / PE_ROWS
        positions = spec.Wo
        cycles = math.ceil(math.ceil(spec.C / N_MATRICES) * spec.P
                           * bands * positions * col_loads)
        stored_frac = 3.0 / 18.0 if spec.K == 3 else 5.0 / 18.0
    d_log, d_fp16 = _traffic(spec)
    return LayerPerf(spec=spec, cycles=int(cycles), useful_macs=spec.macs,
                     stored_psum_frac=stored_frac,
                     ddr_bytes_log=d_log, ddr_bytes_fp16=d_fp16)


@dataclasses.dataclass
class NetworkPerf:
    name: str
    layers: list

    @property
    def total_cycles(self) -> int:
        return sum(l.cycles for l in self.layers)

    @property
    def total_macs(self) -> int:
        return sum(l.useful_macs for l in self.layers)

    @property
    def avg_utilization(self) -> float:
        """Cycle-weighted average utilization (what throughput realises)."""
        c = self.total_cycles
        return self.total_macs / (c * PEAK_OPS_PER_CYCLE) if c else 0.0

    @property
    def mean_layer_utilization(self) -> float:
        """Unweighted per-layer mean (Fig-19 'average utilization')."""
        ls = [l.utilization for l in self.layers]
        return sum(ls) / len(ls) if ls else 0.0

    @property
    def latency_ms(self) -> float:
        return self.total_cycles / CLOCK_HZ * 1e3

    @property
    def throughput_gops_paper(self) -> float:
        """Fig 20 accounting: (unweighted per-layer mean util) × 324 GOPS —
        this is exactly how the paper's 307.8/281.8/268.9 figures decompose."""
        return self.mean_layer_utilization * PEAK_GOPS_PAPER

    @property
    def ddr_bytes_log(self) -> int:
        return sum(l.ddr_bytes_log for l in self.layers)

    @property
    def ddr_bytes_fp16(self) -> int:
        return sum(l.ddr_bytes_fp16 for l in self.layers)


def analyze_network(name: str, specs: list) -> NetworkPerf:
    return NetworkPerf(name=name, layers=[analyze_layer(s) for s in specs])
