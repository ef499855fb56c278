#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Builds the CUDA kernels from `src/repro_torch/kernels/csrc/` at first use,
then runs, failing (non-zero exit, no final line) on the first phase that
goes wrong:

  1. the card (`nvidia-smi` name and power limit) and the fp32 settings:
     TF32 is switched off for cuDNN and matmul, so the plain versions are
     full fp32;
  2. the kernel build and its time;
  3. the decode table: all 128 codes through a 1x1 conv (scale = 1), bit
     for bit against `decode_codes`, on the depthwise path (x = 1) and on
     both load paths of the dense path: the gather (Cin = 2, x = (1, 0))
     and the 16-byte cp.async copies (Cin = 16, x one-hot);
  4. the kernel against `log_conv2d_ref` and `log_conv2d_blockwise` on the
     conv sweeps of the tests, on shapes whose reduction falls on either
     side of a share boundary of the split-K geometry (`SPLIT_SHAPES`), on
     depthwise shapes at the edges of the depthwise tiles (`DW_SHAPES`, and
     one with x 4 bytes past a 16-byte boundary, which the kernel gathers)
     and on the 61 conv shapes of the four paper CNNs at batch 1 (tolerance
     1e-4 * (max|y_ref| + 1)); every case is run twice and must give the
     same bits, and the geometry of each depthwise and split shape (tile,
     blocks and load; tiles, shares and blocks) is printed;
  5. the slice: VGG-16, MobileNet v1, ResNet-34 and SqueezeNet at full
     width, 224 px, 1000 classes, batch 8, random weights from a seed,
     packed by `quantize_cnn_params(conv_layout="lane_packed")` and run with
     ``conv_impl="auto"``.  The kernel's launch count must rise by the net's
     conv count (13/27/36/26); in a second forward each conv's output must
     match ``"blockwise"`` on the same input, and the logits must match the
     ``"blockwise"`` forward's.  Each net's forward is timed and profiled
     (device busy time, idle share, top kernels);
  6. per-conv times at batch 8 over the 61 distinct shapes: the kernel (at
     the packaged autotune tier's knobs, which the main path launches;
     where they differ, also at the heuristic's) and the library call (`F.conv2d` on weights decoded in advance, the same
     yardstick as the LM kernels', layout copies included) as device time,
     the sum of a call's kernels in a `torch.profiler` window, with the
     CUDA-event mean of a loop of calls beside each; the plain version (im2col
     x matmul) and decode + `F.conv2d` by CUDA events; TFLOP/s, blocks,
     the bound max(bytes / 3.35 TB/s, FLOP / 989 TFLOP/s), the bf16
     tensor-core peak the dense path runs on, and the fp32 bound
     (FLOP / 67 TFLOP/s) beside it.  Per net, the dense and the depthwise
     convs are also summed apart; the depthwise convs (whose x and y fit the
     50 MB L2) are read a second time with a cold L2, kernel and library:
     256 MB are written before each call, and those fills are left out of
     the sum;
  7. the log_matmul kernel against `ref_log_matmul`: the decode table bit
     for bit through a 1 x 128 product, the shapes of
     `tests/test_kernels_log_matmul.py`, ragged shapes, K on either side
     of a share boundary of the split-K geometry, and M in {1, 4, 32} at
     every (K, N) of gemma-2b's and rwkv6-1.6b's dense layers, in fp32
     (tolerance 1e-4 * (max|y| + 1)) and bf16 (8e-3 * (max|y| + 1)); every
     case is run twice and must give the same bits;
  8. the attention kernel against `ref_attention` and the blockwise
     version: the sweeps of `tests/test_kernels_attention.py` (Hkv in
     {1, 2, 8} x window x ragged T), per-row decode offsets, the ring
     offset, gemma-2b's shapes (prefill B=1, T in {32, 2048}; decode
     B=4, Tq=1, Tk in {64, 8192}), decode keys on either side of a split
     boundary of the split-KV variant (Tk in {4096, 4097, 8193}), splits
     emptied by a window and by keys at positions < 0, a row with no key
     (held to 0, the TPU kernel's output), bf16 prefill on the tensor
     cores at ragged T and at T a multiple of 64 under a window, the split
     variant's four dtype pairs, and k and v rows off 16-byte boundaries;
     tolerance 2e-4 * (max|o| + 1) in fp32 (8e-3 with bf16 queries), and
     each tensor-core case also element by element within
     `mma_error_limit`; every case is run twice and must give the same
     bits, and the variant, blocks and splits of each are printed;
  9. the LM slice: gemma-2b at full width with random weights from the
     seed, packed by `quantize_params` and served by the port's
     `ServeEngine` at `launch/serve.py`'s defaults (8 requests, 16 new
     tokens, 4 slots, greedy).  log_matmul must launch 126 times and
     attention 18 times per forward (prefills + decode steps, from
     `engine.stats`); in one prefill and one decode step every log_matmul
     and attention call is held against its plain version on the same
     input; a second engine on blockwise attention and the plain matmul
     gives the greedy-token agreement and the prefill logit difference
     (tolerance 0.02 * (max|l| + 1)); with random weights each request
     mostly repeats one token, so the greedy agreement is printed but
     proves little: the per-call checks carry correctness.  Prefill ms
     per bucket, decode-step ms, tokens/s and one profiled decode step are
     printed;
 10. per-kernel times at the slice's shapes: log_matmul over one decode
     step's 126 products (M = 4) and over the same products at M = 16,
     and attention over its 18 calls, a B=4 decode over 8192 keys (fp32)
     and a causal T=2048 prefill (bf16), with the plain version, the
     library call (`torch.matmul` on pre-decoded weights;
     `F.scaled_dot_product_attention` with the kv head expanded) and the
     bound (attention at the peak of the unit its variant runs on: 67
     TFLOP/s fp32 for split-KV, 989 bf16 for the tensor cores).  Kernels
     and library calls are read as device time, the sum of their kernels
     in a `torch.profiler` window, beside the CUDA-event time of the loop
     of calls (and, for log_matmul, the wrapper's host time a call);
 11. the wkv6 kernel against `ref_wkv6` (and `wkv6_chunked` where its
     closed form is finite), for o and the final state: the shapes of
     `tests/test_kernels_wkv6.py` (K != V included), rwkv6-1.6b's decode
     (B=4, T=1, H=32, K=V=64, carried state), prefill (T in {3, 15}) and a
     T=2048 call, T on either side of the variant threshold (4 | 5), of a
     sub-chunk (16 | 17) and of a chunk (32 | 33) of the chunked variant,
     V = 40 (not a multiple of the 16-column tile) in both variants, K = 24
     and V = 37 (element copies), fp32 and bf16 r/k/v (tolerance 1e-4 and
     8e-3 times (max|y| + 1)), two halves against the whole, and strong
     decays (logw = -7, the clip's floor -e^2 at T = 2048, and -20), where
     the kernel must be finite; it prints whether the chunked plain version
     gave NaN there.  Every case is run twice and must give the same bits,
     and its variant, blocks and tile (`wkv6_geometry`) are printed;
 12. the RWKV slice: rwkv6-1.6b at full width served as in 9.  log_matmul
     must launch 192 times and wkv6 24 times per forward; every log_matmul
     and wkv6 call of one prefill and one decode step is held against its
     plain version; a plain engine (decode-then-matmul, sequential WKV)
     gives the prefill logit difference and the greedy agreement.  With
     random weights the RWKV stack amplifies a single bf16 rounding to
     O(1) logit differences, so that difference is printed for bf16 and
     held in fp32 activations (tolerance 0.02 * (max|l| + 1)).  Prefill
     ms per prompt length (exact length: a pad token would enter the
     state), decode-step ms, tokens/s and one profiled decode step are
     printed;
 13. wkv6 times: kernel (`torch.profiler` device time, with the CUDA-event
     time beside it), plain versions (`ref_wkv6`, `wkv6_chunked`, CUDA
     events) and the bound (bytes at 3.35 TB/s or FLOP at the 67 TFLOP/s
     fp32 peak, the larger), with the variant, the blocks and the share of
     the bound, summed over one decode step's 24 calls,
     over a 15-token prefill's 24 calls, and for one T=2048 call (where a
     profiler window missed at most 2 % of the kernels, as in 10, their
     mean stands in for the missing ones), in a process of its own
     (``chip_smoke.py --wkv6-times``, on the layers' u and states saved to
     a file), whose profiler windows start fresh.  No single
     PyTorch call computes the recurrence, so there is no library time.
     Then log_matmul over rwkv6-1.6b's 192 products at M = 4 and 16, read
     as in 10;
 14. the hardware oracle at the paper's layer sizes: VGG-16's 13 convs at
     224 px (`accelerator.vgg16_layers`, input padded by the layer's pad,
     VALID, batch 1), MobileNet v1's stride-2 depthwise layer at 112 x 112 x
     64 and its 1x1 layer at 14 x 14 x 512 -> 512, |normal| activations and
     normal weights from a numpy seed, through `PEGrid(mode="log",
     quant_cfg=LogQuantConfig(per_channel=False), out_frac_bits=16)` on the
     card.  The conv kernel (one launch a layer) on the dequantized x and
     the packed per-tensor weights must agree with the grid within
     5e-3 * (max|y| + 1) (`tests/test_conv2d.py`), its error printed as a
     share of the LUT bound 1.5 * taps * 2^-16 * xscale * wscale; the
     dataflow model's cycles must lie in [0.6, 1] x the grid's on each
     VGG-16 layer (`tests/test_pe_grid.py`; printed for the other two).  A
     medium layer (56 x 56 padded to 58, 64 -> 32) runs on the card and on
     the CPU: equal GridStats, y within 1e-6 * (max|y| + 1), and one band's
     `cycle_psums_batch` psums bit-identical.  Per layer: grid ms on the
     card, thread products, grid and model cycles, the modelled FPGA's
     latency;
 15. the end-to-end example (`repro_torch.examples.cnn_accelerator_sim`)
     on the card: 250 QAT steps of the tiny SqueezeNet, packed serving
     through the conv kernel (26 launches a forward) within the example's
     drift limit 1e-3 * (max|l| + 1) of the fake-quant logits, and the
     dataflow walk of the four nets (the modelled Zynq-7020).  The same
     250 steps run on the CPU too, and that model, moved to the card, is
     served through the kernel under the same checks.  Each trained model
     must have learned: its fake-quant logits differ between images and
     across classes, and its train accuracy exceeds chance (1/8) by 1/16.

 16. the Griffin slice: recurrentgemma-2b at full width and depth (26
     layers, pattern (rec, rec, local), LRU width 2560, local window 2048)
     served as in 9.  Launches a forward come from the layer pattern
     (`launches_per_forward`): log_matmul 18 rec layers x 3 FFN matrices +
     8 local layers x 7 = 110 and attention 8 (the RG-LRU blocks keep fp32
     weights, as in JAX, and launch no kernel); every log_matmul and
     attention call of one prefill and one decode step is held against its
     plain version; a plain engine gives the prefill logit difference
     (tolerance 0.02 * (max|l| + 1)).  Prefill runs at the exact prompt
     length (a pad token would enter the RG-LRU state);
 17. the MoE slice: granite-moe-3b-a800m at full width and depth (32
     layers, 40 experts, top-8, capacity factor 1.25) served as in 9:
     log_matmul 32 x 4 = 128 a forward (the router and the experts stay
     fp32, as in JAX, and are cast to bf16 on every call) and attention
     32; per-call checks as in 16.  In bf16 a rounding of a router input
     can turn a near-tie between the 8th and 9th expert, which moves the
     random-weight logits by O(max|l|) (as in the JAX package,
     `tests/test_torch_moe.py`): the plain-engine logit check is held in
     fp32 activations, and the bf16 difference is printed with the top-8
     expert sets of both engines' prefill compared layer by layer
     (`_routing_flips`: tokens flipped per layer, the first flip's margin
     against the layer's median).

     Phases 9, 12, 16 and 17 end with one more decode step under the
     kernel-dispatch profiler (`repro_torch.obs.kernel_profile`): a record
     a shape key (op, calls, µs by CUDA events, bytes, GB/s, the bytes
     bound);
 18. the kernel-dispatch profiler on the card: gemma-2b's engine (phase
     9's) serves the 8 requests with the profiler on: its prefill and
     decode programs, per op the records' calls equal to the wrapper's
     launches, every record of impl and backend ``cuda``, with a steady
     time of its own and the bytes of the model (`conv_traffic_bytes`,
     `attention_traffic_bytes`, the log_matmul and wkv6 formulas) computed
     from each call's tensors; its decode step with the profiler off and
     on.  Then one batch-8 forward of each net under the profiler (calls
     = launches 13/27/36/26, as above, the bytes the models' at the knobs
     each call launched); every conv shape of the zoo in a host-paced loop
     of 20 calls after a first one, in a process of its own
     (``chip_smoke.py --profiled-loops``, whose profiler windows start
     fresh), a record's steady µs against the `torch.profiler` device time
     of the same call taken right before the loop, held within
     [0.9, 1.25] x + 10 µs for VGG-16's 13 shapes and printed for the
     rest; `ops.wkv6` at rwkv6-1.6b's decode shape; the top ten records by
     total time;
 19. the bench twins (`repro_torch.benchmarks`: conv_kernels at 224 px,
     attention_kernels, telemetry_overhead) through their CLI in a process
     of their own, their JSON under `chiprun_out/`; the conv and attention
     twins' correctness and traffic gates must hold, the telemetry
     overhead is printed;
 20. LM training (`repro_torch.training`, `launch/train.py`), which runs
     no kernel: attention and the RWKV recurrence take their plain,
     differentiable versions (``attn_impl="blockwise"``).  (a) One step of
     the trainer (SGD with momentum, whose update is linear in the
     gradient) on reduced gemma-2b, rwkv6-1.6b, recurrentgemma-2b,
     granite-moe-1b-a400m and musicgen-large (embedding inputs), fp32
     activations, from the same params and batch on the CPU and the card:
     loss and gradient norm within 1e-4 relative, every updated leaf
     within 1e-4 * (max|p| + 1).  (b) `launch/train.py` at gemma-2b, full
     width and depth, its defaults (batch 8 x 128, AdamW, remat, bf16
     activations) but ``--steps 8 --log-every 1``, in a process of its own
     (``chip_smoke.py --train-gemma``): every loss and gradient norm finite
     and printed, each step's time (its ``train_step`` trace span, which
     the loop's step event makes with the histogram's sample), their
     median after the first step, tokens/s at it, the peak device memory,
     and one more step of a fresh state under `torch.profiler` (busy ms,
     kernels, the top five).  (c) The four wrappers' launch counts read 0
     across (a) and (b), and each wrapper raises on a card input that
     requires grad.  (d) `resume_check` in a process of its own
     (``chip_smoke.py --resume-check``, ``CUBLAS_WORKSPACE_CONFIG=:4096:8``
     set before CUDA starts): a 2-layer gemma-2b of width 512 trained 6
     steps straight against 3, a checkpoint, a restore and 3 more, bit for
     bit under `torch.use_deterministic_algorithms` (with the default
     algorithms the differing leaves are printed);
 21. the example twins on the card: `examples/train_lm` at its defaults
     (300 steps of the ~115M logq6 model with compressed gradients; its
     assertion that the loss falls by more than 1.0), `serve_lm` (its spot
     check against naive decode; the attention kernel must launch) and
     `quickstart` (step 5 launches B2 once);
 22. the autotune tables (`repro_torch.kernels.autotune`), in a process
     of its own (``chip_smoke.py --autotune``) and an empty user tier of
     its own: (a) the cold-start gate: one batch-8
     forward of each net and gemma-2b's serve run resolve every conv and
     attention dispatch from the packaged tier (no miss, no sweep,
     hit_warm = the lookups = the distinct keys; knobs are resolved once a
     shape), with B1 launched 13/27/36/26 times; (b) every packaged conv
     config at batch 8 run twice for the same bits and held against
     `log_conv2d_blockwise` within 1e-4 * (max|y_ref| + 1), every packaged
     attention config held as in 8; (c) `build_autotune_table`'s ``--measure`` sweep
     over ResNet-34's three 1x1 stride-2 convs, MobileNet v1's 56² and 28²
     stride-1 depthwise convs and gemma-2b's decode attention (each
     candidate held against the plain version first), with the device µs
     of the heuristic's, the packaged and the winning knobs and of the
     library call; the split tickets read zero after each; (d) each net's
     forward ms and busy ms with the packaged tier and with it emptied,
     printed.

Phases 5, 9, 12, 14, 15, 16, 17 and 22(a) drive the main paths: the
kernels' launch counts are set to 0 just before each and read just after.
The autotune user tier is an empty file of the run's own, so every main
path launches the packaged tier's knobs.

The build log must show the log_conv2d and log_matmul kernels at no more
than 128 registers a thread, the attention and wkv6 kernels at no more
than 255, and no spill.  A `torch.profiler` window that lost kernel events
is taken again after a wait that doubles from half a second (0.5, 1, 2,
4 s), up to five windows in all; then the run fails.
Each retake is printed and listed in the details.  Details go to
`chiprun_out/chip_smoke.json`.  The last three lines are the
kernel table as JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks from NVIDIA's data sheet: fp32 on the CUDA cores, dense
# bf16 on the tensor cores, HBM3
from repro_torch.benchmarks.common import (  # noqa: E402
    PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_HBM_BYTES, retake_wait)

BATCH, IMG, N_CLASSES, SEED = 8, 224, 1000, 0
CONVS_PER_NET = {"vgg16": 13, "mobilenet_v1": 27, "resnet34": 36,
                 "squeezenet": 26}
LM_ARCH = "gemma-2b"
RWKV_ARCH = "rwkv6-1.6b"
RG_ARCH = "recurrentgemma-2b"
MOE_ARCH = "granite-moe-3b-a800m"
GEMMA_KN = [(2048, 2048), (2048, 256), (2048, 16384), (16384, 2048)]
RWKV_KN = [(2048, 7168), (7168, 2048)]    # and (2048, 2048), as gemma-2b's
MM_SHAPES = ([(128, 128, 128), (256, 384, 128), (64, 128, 256),
              (130, 257, 129), (8, 512, 64),      # test_kernels_log_matmul
              (3, 1000, 77), (33, 4097, 300), (5, 31, 16),   # ragged
              # K on either side of a share boundary (128 rows at M = 4),
              # K = 1, and a share of one row
              (4, 127, 2048), (4, 129, 2048), (4, 1, 2048), (8, 2049, 256)]
             + [(m, k, n) for m in (1, 4, 32)
                for k, n in GEMMA_KN + RWKV_KN])

SHAPES = [  # B, H, W, C, K, P, stride, padding, groups (tests/test_conv2d.py)
    (2, 8, 8, 5, 3, 7, 1, "SAME", 1),
    (1, 9, 7, 4, 3, 6, 2, "SAME", 1),
    (2, 8, 8, 6, 3, 6, 1, "VALID", 6),
    (1, 10, 10, 4, 1, 8, 1, "VALID", 1),
    (1, 8, 8, 6, 3, 4, 2, "SAME", 2),
    (1, 8, 8, 3, 5, 4, 2, 2, 1),
    (1, 8, 8, 3, 3, 5, 1, ((1, 2), (0, 1)), 1),
    (1, 10, 10, 4, 3, 6, 2, "SAME", 1),
    (1, 9, 9, 4, 3, 5, 2, "VALID", 1),
]
LANE_SHAPES = [
    (1, 8, 8, 6, 3, 6, 1, "SAME", 6),
    (1, 8, 8, 6, 3, 12, 1, "SAME", 6),
    (1, 9, 7, 12, 3, 8, 2, "SAME", 4),
    (1, 8, 8, 8, 3, 8, 1, "VALID", 4),
    (2, 8, 8, 16, 5, 8, 2, 2, 4),
    (1, 8, 8, 4, 3, 8, 1, ((1, 2), (0, 1)), 4),
]

# the conv kernel's split-K: R on either side of a share boundary of
# `log_conv2d_geometry` (one 128 x 64 tile: R = 8432 gives 264 shares of one
# stage of 32, R = 8464 gives 133 shares of two, the last one half a stage),
# a gathered R, a half stage in the last share, grouped and ragged-N tiles
SPLIT_SHAPES = [
    (1, 4, 4, 8432, 1, 64, 1, "VALID", 1),
    (1, 4, 4, 8464, 1, 64, 1, "VALID", 1),
    (1, 4, 4, 8440, 1, 64, 1, "VALID", 1),
    (1, 4, 4, 48, 1, 64, 1, "VALID", 1),
    (1, 6, 6, 64, 3, 64, 1, "SAME", 2),
    (2, 5, 5, 96, 3, 72, 2, "SAME", 1),
]

# depthwise shapes at the edges of the depthwise kernel's tiles
# (tests/test_torch_conv2d.py): H, W and C not multiples of a tile, stride 2
# with odd H and asymmetric SAME pads, K = 5, channel multiplier 2, batch 3,
# and the gather load on tiles of several channel quads
DW_SHAPES = [
    (1, 19, 21, 8, 3, 8, 1, "SAME", 8),
    (3, 11, 13, 10, 3, 10, 1, "SAME", 10),
    (1, 15, 16, 12, 3, 12, 2, "SAME", 12),
    (3, 14, 9, 36, 3, 36, 2, "SAME", 36),
    (2, 12, 11, 8, 5, 8, 1, "SAME", 8),
    (1, 13, 14, 8, 5, 8, 2, "SAME", 8),
    (1, 10, 9, 4, 3, 8, 1, "SAME", 4),
    (3, 9, 10, 6, 3, 12, 2, "SAME", 6),
    (1, 37, 41, 40, 3, 40, 1, "SAME", 40),
    (2, 9, 9, 16, 3, 16, 2, "VALID", 16),
    (2, 28, 30, 24, 3, 48, 1, "SAME", 24),
    (4, 40, 36, 30, 3, 30, 2, "SAME", 30),
]


def fail(msg: str):
    print(f"FAILED: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_kernels(fn, reps: int = 1,
                   opener: bool = False) -> list[tuple[str, float]]:
    """(name, ms) of each CUDA kernel of ``reps`` calls of ``fn``, from a
    `torch.profiler` trace taken after one warm-up call.  With ``opener``
    the window opens with a throwaway fill kernel (named ``FillFunctor``),
    since the profiler may drop an event at its edge."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if opener:
            torch.ones(1, device="cuda")
            torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def profile_forward(fn) -> dict:
    """Device time of one call of ``fn`` from a `torch.profiler` trace: the
    sum of its CUDA kernels' durations, the kernel count and the kernels
    that take the most time."""
    kernels = device_kernels(fn)
    by_name: dict[str, float] = {}
    for name, ms in kernels:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"device_busy_ms": sum(by_name.values()),
            "device_kernels": len(kernels), "top_kernels_ms": top,
            "attention_ms": sum(ms for name, ms in by_name.items()
                                if "attn_" in name),
            "log_matmul_ms": sum(ms for name, ms in by_name.items()
                                 if "log_matmul" in name)}


def check_registers(log: str, limit: int) -> None:
    """Fail unless every kernel in a ``-Xptxas -v`` log uses at most
    ``limit`` registers a thread and spills nothing."""
    import re
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
    if not regs or max(regs) > limit or any(spills):
        fail(f"ptxas: registers {regs} (limit {limit}), spill bytes "
             f"{spills}")
    print(f"  {len(regs)} kernels at {min(regs)}-{max(regs)} registers a "
          f"thread (limit {limit}), no spill")


def conv_cost(r: dict) -> tuple[int, int]:
    """(bytes, flops) of one conv: each input read once, each output
    written once (`conv_traffic_bytes("min")`); 2 FLOP per multiply-add."""
    from repro_torch.kernels.log_conv2d import (_out_size,
                                                conv_traffic_bytes,
                                                normalize_padding)
    B, H, W, C, K, Cout = (r[k] for k in ("B", "H", "W", "C", "K", "Cout"))
    kw = {k: r[k] for k in ("stride", "padding", "groups")}
    pads = normalize_padding(r["padding"], K, r["stride"], H, W)
    Ho = _out_size(H, K, r["stride"], pads[0])
    Wo = _out_size(W, K, r["stride"], pads[1])
    nbytes = conv_traffic_bytes("min", B, H, W, C, K, Cout, **kw)["total"]
    return nbytes, 2 * B * Ho * Wo * Cout * K * K * (C // r["groups"])


def make_conv(r: dict, rng, dev):
    """Random activations and packed codes for one conv record → (x, qt,
    HWIO codes, codes as the kernel gets them, lane meta): grouped codes
    lane-packed as `quantize_cnn_params` bakes depthwise ones."""
    from repro_torch.core.logquant import quantize_tensor
    from repro_torch.kernels.log_conv2d import (lane_pack_codes,
                                                lane_pack_geometry)
    B, H, W, C, K, Cout, G = (r[k] for k in ("B", "H", "W", "C", "K", "Cout",
                                             "groups"))
    x = torch.as_tensor(rng.normal(size=(B, H, W, C)).astype(np.float32),
                        device=dev)
    fan_in = K * K * C // G
    w = rng.normal(size=(K, K, C // G, Cout)) * (2.0 / fan_in) ** 0.5
    qt = quantize_tensor(torch.as_tensor(w.astype(np.float32), device=dev))
    hwio = qt.packed
    codes, lane_meta = hwio, None
    lp = lane_pack_geometry(G, C // G)
    if lp["g_b"] > 1:
        codes = lane_pack_codes(hwio, G, lp["g_b"], lp["cin_lane"])
        lane_meta = (lp["g_b"], lp["cin_lane"])
    return x, qt, hwio, codes, lane_meta


def phase_decode(dev) -> None:
    from repro_torch.kernels.log_conv2d import decode_codes, log_conv2d_fused
    codes = torch.arange(128, dtype=torch.int8, device=dev)
    want = decode_codes(codes).view(torch.int32)
    ones = torch.ones(128, device=dev)
    # Cin = 1: the depthwise path; Cin = 2 with x = (1, 0): the dense path's
    # gather; Cin = 16 with x one-hot: its cp.async path
    y1 = log_conv2d_fused(torch.ones((1, 1, 1, 1), device=dev),
                          codes.reshape(1, 1, 1, 128), ones, padding="VALID")
    w2 = torch.stack([codes, codes.flip(0)]).reshape(1, 1, 2, 128)
    x2 = torch.tensor([1.0, 0.0], device=dev).reshape(1, 1, 1, 2)
    y2 = log_conv2d_fused(x2, w2.contiguous(), ones, padding="VALID")
    w16 = torch.stack([codes.roll(j) for j in (5, 0, 77, 3)] * 4)
    x16 = torch.zeros((1, 1, 1, 16), device=dev)
    x16[..., 1] = 1.0
    y16 = log_conv2d_fused(x16, w16.reshape(1, 1, 16, 128).contiguous(), ones,
                           padding="VALID")
    torch.cuda.synchronize()
    for path, y in (("depthwise", y1), ("dense gather", y2),
                    ("dense cp.async", y16)):
        bad = int((y.reshape(-1).view(torch.int32) != want).sum())
        print(f"decode table, {path} path: {128 - bad}/128 codes bit-exact")
        if bad:
            fail(f"{bad} decoded codes differ from decode_codes ({path})")


def depthwise_load(fn, what: str) -> str:
    """The load the depthwise kernel took in one call of ``fn``, read from
    the template argument in its name (``..._kernel<K, S, ASYNC>``):
    ``cp.async`` or ``gather``."""
    for attempt in range(WINDOWS):
        retake_wait(attempt)
        names = [n for n, _ in device_kernels(fn, opener=True)
                 if "log_conv2d_depthwise_kernel" in n]
        if len(names) == 1:
            args = names[0].split("log_conv2d_depthwise_kernel<")[1]
            flag = args.split(">")[0].split(",")[-1].strip()
            if flag in ("true", "false"):
                return "cp.async" if flag == "true" else "gather"
            fail(f"{what}: cannot read the load from {names[0]!r}")
    fail(f"{what}: the profiler saw no single depthwise kernel in "
         f"{WINDOWS} windows")


def check_conv(r: dict, rng, dev, label: str, offset: bool = False) -> dict:
    """Kernel (HWIO and, where the group layout packs, lane-packed codes)
    against ref and blockwise on one shape; each kernel call is made twice
    and must give the same bits.  With ``offset`` x lies 4 bytes past a
    16-byte boundary (the kernel then gathers x)."""
    from repro_torch.kernels.log_conv2d import (log_conv2d_blockwise,
                                                log_conv2d_fused,
                                                log_conv2d_geometry,
                                                log_conv2d_ref)
    x, qt, hwio, codes, lane = make_conv(r, rng, dev)
    if offset:
        x = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x)
        if x.data_ptr() % 16 != 4:
            fail(f"{label}: x is not 4 bytes past a 16-byte boundary")
    kw = dict(stride=r["stride"], padding=r["padding"], groups=r["groups"])
    y_ref = log_conv2d_ref(x, hwio, qt.scale, **kw)
    y_bw = log_conv2d_blockwise(x, hwio, qt.scale, **kw)
    outs = {"hwio": [log_conv2d_fused(x, hwio, qt.scale, **kw)
                     for _ in range(2)]}
    if lane is not None:
        outs["lane"] = [log_conv2d_fused(x, codes, qt.scale, lane=lane, **kw)
                        for _ in range(2)]
    torch.cuda.synchronize()
    tol = 1e-4 * (float(y_ref.abs().max()) + 1)
    geo = log_conv2d_geometry(*(r[k] for k in ("B", "H", "W", "C", "K",
                                               "Cout", "stride", "padding",
                                               "groups")),
                              n_sm=torch.cuda.get_device_properties(dev)
                              .multi_processor_count)
    res = {"shape": label, "tol": tol,
           "geometry": {k: geo[k] for k in ("path", "load", "tile",
                                            "threads", "smem_bytes", "tiles",
                                            "splits", "stages_per_split",
                                            "blocks") if k in geo}}
    if geo["path"] == "depthwise":
        # the kernel picks its load itself; it must be the geometry's, and
        # the gather where x lies off a 16-byte boundary
        ran = depthwise_load(lambda: log_conv2d_fused(x, hwio, qt.scale, **kw),
                             label)
        if ran != ("gather" if offset else geo["load"]):
            fail(f"{label}: the depthwise kernel took the {ran} load, "
                 f"geometry says {geo['load']}, x offset {offset}")
        res["geometry"]["load"] = ran
    for name, (y, again) in outs.items():
        if y.shape != y_ref.shape or not bool(torch.isfinite(y).all()):
            fail(f"{label} {name}: shape {tuple(y.shape)} or non-finite")
        if not torch.equal(y.view(torch.int32), again.view(torch.int32)):
            fail(f"{label} {name}: two calls on the same inputs gave "
                 f"different bits")
        res[f"{name}_vs_ref"] = float((y - y_ref).abs().max())
        res[f"{name}_vs_blockwise"] = float((y - y_bw).abs().max())
        if max(res[f"{name}_vs_ref"], res[f"{name}_vs_blockwise"]) > tol:
            fail(f"{label} {name}: {res} exceeds tol {tol:.3e}")
    return res


def sweep_record(s) -> dict:
    B, H, W, C, K, P, stride, padding, groups = s
    return dict(B=B, H=H, W=W, C=C, K=K, Cout=P, stride=stride,
                padding=padding, groups=groups)


def sig(r: dict) -> tuple:
    return tuple(str(r[k]) for k in ("B", "H", "W", "C", "K", "Cout",
                                     "stride", "padding", "groups"))


def phase_sweeps(dev) -> tuple[list, float]:
    from repro_torch.models.cnn import zoo_conv_shapes
    rng = np.random.default_rng(SEED)
    rows = [check_conv(sweep_record(s), rng, dev, f"sweep {s}")
            for s in SHAPES + LANE_SHAPES + SPLIT_SHAPES + DW_SHAPES]
    # the depthwise gather where C % 4 == 0: x off a 16-byte boundary
    s_off = DW_SHAPES[0]
    rows.append(check_conv(sweep_record(s_off), rng, dev,
                           f"sweep {s_off}, x 4 bytes off", offset=True))
    print(f"sweeps: {len(rows)} shapes within tol, each bit-identical over "
          f"two calls, max |kernel - ref| "
          f"{max(r['hwio_vs_ref'] for r in rows):.3e}")
    for r in rows:
        if r["geometry"]["path"] == "depthwise" or \
                r["geometry"]["splits"] > 1:
            print(f"  {r['shape']}: {r['geometry']}")
    zoo = zoo_conv_shapes(batch=1, img=IMG, n_classes=N_CLASSES)
    if len(zoo) != 61:
        fail(f"expected 61 zoo conv shapes, traced {len(zoo)}")
    zrows = [check_conv(r, rng, dev, "zoo " + "/".join(sig(r)[1:]))
             for r in zoo]
    for r in zrows:
        g = r["geometry"]
        if g["path"] == "depthwise":
            print(f"  {r['shape']}: depthwise ({g['load']}), tile "
                  f"{g['tile']} (rows, columns, channels), {g['threads']} "
                  f"threads, {g['smem_bytes']} B shared, {g['blocks']} "
                  f"blocks")
            continue
        print(f"  {r['shape']}: {g['path']} ({g['load']}), {g['tiles']} "
              f"tiles x {g['splits']} shares of {g['stages_per_split']} "
              f"stages = {g['blocks']} blocks")
    err = max(max(r.get("lane_vs_ref", 0.0), r["hwio_vs_ref"]) for r in zrows)
    worst = max(max(r.get("lane_vs_ref", 0.0), r["hwio_vs_ref"]) / r["tol"]
                for r in zrows + rows)
    print(f"zoo shapes at batch 1: {len(zrows)} within tol, each "
          f"bit-identical over two calls, max |kernel - ref| {err:.3e}, "
          f"worst err/tol (sweeps and zoo) {worst:.3e}")
    return rows + zrows, err


def phase_slice(dev) -> tuple[list, int]:
    from repro_torch.kernels import ops
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    from repro_torch.models.cnn import CNNS, make_cnn
    from repro_torch.serving.quantize import quantize_cnn_params
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((BATCH, IMG, IMG, 3), generator=gen, device=dev)
    nets = {}
    for name in CNNS:
        params, _ = make_cnn(name, SEED, n_classes=N_CLASSES, device=dev)
        nets[name] = quantize_cnn_params(params, conv_layout="lane_packed")

    def forward(name, quant, impl):
        with torch.no_grad():
            return CNNS[name][1](nets[name], x, quant=quant, conv_impl=impl)

    def checked_forward(name, quant):
        """A forward on the kernel in which every conv's output is also held
        against blockwise on the very same input → (logits, launches,
        worst err/tol over the net's convs)."""
        conv, ratios = ops.conv2d, []

        def checked(xin, qt, **kw):
            y = conv(xin, qt, **kw)
            yb = conv(xin, qt, **dict(kw, impl="blockwise"))
            tol = 1e-4 * (float(yb.abs().max()) + 1)
            ratios.append(float((y - yb).abs().max()) / tol)
            return y

        ops.conv2d = checked
        try:
            before = log_conv2d_fused.launches
            out = forward(name, quant, "auto")
            torch.cuda.synchronize()
        finally:
            ops.conv2d = conv
        return out, log_conv2d_fused.launches - before, max(ratios)

    # the main path: the repo's default model configuration, quant="logq6";
    # the launch count is zeroed just before it and read just after it
    log_conv2d_fused.launches = 0
    for name in CNNS:
        before = log_conv2d_fused.launches
        forward(name, "logq6", "auto")
        torch.cuda.synchronize()
        launched = log_conv2d_fused.launches - before
        if launched != CONVS_PER_NET[name]:
            fail(f"{name}: kernel launched {launched} times on the main "
                 f"path, expected {CONVS_PER_NET[name]}")
    main_launches = log_conv2d_fused.launches
    print(f"main path: {main_launches} kernel launches for one forward of "
          f"each net ({CONVS_PER_NET})")

    rows = []
    for quant in ("logq6", None):
        for name in CNNS:
            out, launched, worst = checked_forward(name, quant)
            if launched != CONVS_PER_NET[name]:
                fail(f"{name}: kernel launched {launched} times, expected "
                     f"{CONVS_PER_NET[name]}")
            if worst > 1.0:
                fail(f"{name} quant={quant}: a conv exceeds its tolerance "
                     f"against blockwise on the same input (err/tol "
                     f"{worst:.3e})")
            if tuple(out.shape) != (BATCH, N_CLASSES) or \
                    not bool(torch.isfinite(out).all()):
                fail(f"{name}: logits {tuple(out.shape)} or non-finite")
            ref = forward(name, quant, "blockwise")
            drift = float((out - ref).abs().max())
            row = {"net": name, "quant": quant, "launches": launched,
                   "conv_err_over_tol": worst, "drift": drift,
                   "max_abs_logit": float(ref.abs().max()),
                   "top1_agree": float((out.argmax(-1) == ref.argmax(-1))
                                       .float().mean())}
            if quant:
                # logq6 re-quantizes every activation after its ReLU.  A sum
                # within fp32 rounding of a half-step boundary takes the
                # other code under another summation order; that √2 step
                # moves the next layer's sums enough to flip more codes, and
                # at full size the flips cascade through the net.  So two
                # correct versions differ in their logits by percents (the
                # control measures it between the two plain versions); the
                # per-conv check above is the tight one.
                rel = 0.25
                row["control_drift"] = float(
                    (forward(name, quant, "ref") - ref).abs().max())
            else:
                rel = 1e-3  # tests/test_cnn.py:106
            row["tol"] = tol = rel * (row["max_abs_logit"] + 1)
            if drift > tol:
                fail(f"{name} quant={quant}: |logits - blockwise| {drift:.3e}"
                     f" > tol {tol:.3e}")
            msg = ""
            if quant:
                row["forward_ms"] = time_ms(
                    lambda: forward(name, quant, "auto"), 3)
                row["blockwise_forward_ms"] = time_ms(
                    lambda: forward(name, quant, "blockwise"), 3)
                row["images_per_s"] = BATCH / row["forward_ms"] * 1e3
                row.update(profile_forward(
                    lambda: forward(name, quant, "auto")))
                # no device events means the profiler saw nothing: the idle
                # share is then not measured
                row["idle_share"] = (1 - row["device_busy_ms"]
                                     / row["forward_ms"]
                                     if row["device_kernels"] else None)
                msg = (f", ref-vs-blockwise control {row['control_drift']:.3e}"
                       f"; forward {row['forward_ms']:.3f} ms "
                       f"({row['images_per_s']:.1f} images/s), blockwise "
                       f"forward {row['blockwise_forward_ms']:.3f} ms; "
                       f"profiled: {row['device_kernels']} device kernels, "
                       f"busy {row['device_busy_ms']:.3f} ms, idle share "
                       f"{row['idle_share']}, top {row['top_kernels_ms'][:3]}")
            rows.append(row)
            print(f"slice {name:12s} quant={quant}: launches {launched}, "
                  f"worst conv err/tol {worst:.3e}, |logits - blockwise| "
                  f"{drift:.3e} (tol {tol:.3e}, max|l| "
                  f"{row['max_abs_logit']:.3e}, top-1 agree "
                  f"{row['top1_agree']:.3f}){msg}")
    return rows, main_launches


WINDOWS = 5   # profiler windows a measurement may take before the run fails
RETAKEN: list = []   # (what, seconds into the run, kernels each lost window saw)


def complete_window(fn, what: str, reps: int, keep,
                    expect: int | None = None,
                    min_share: float = 1.0) -> list[float]:
    """ms of each kernel that ``keep(name)`` accepts over ``reps`` calls of
    ``fn``, from the first `torch.profiler` window that saw all of them:
    ``expect`` a call where given (at least ``min_share`` of those and no
    more), else a non-zero multiple of ``reps`` (every call launches the
    same kernels).
    The profiler on the card's machine now and then loses every event of
    the windows of a short span; so a window that lost events is taken
    again after a wait that doubles from half a second (`retake_wait`),
    up to ``WINDOWS`` windows, and then the run fails.  Each retake is
    recorded in ``RETAKEN``."""
    seen = []
    for attempt in range(WINDOWS):
        retake_wait(attempt)
        kern = [ms for name, ms in device_kernels(fn, reps, opener=True)
                if keep(name)]
        if kern and (min_share * expect * reps <= len(kern) <= expect * reps
                     if expect is not None else len(kern) % reps == 0):
            if seen:
                RETAKEN.append((what, round(time.perf_counter() - T_START,
                                            2), seen))
                print(f"  {what}: the profiler lost kernel events in "
                      f"{len(seen)} window(s) (saw {seen} for {reps} "
                      f"calls); window {attempt + 1} saw {len(kern)}")
            return kern
        seen.append(len(kern))
    fail(f"{what}: the profiler lost kernel events in {WINDOWS} windows "
         f"(saw {seen} for {reps} calls"
         f"{'' if expect is None else f', expected {expect * reps}'})")


def _device_ms(fn, what: str, reps: int = 5, match: str | None = None,
               expect: int | None = None) -> tuple[float, float]:
    """(ms a call, kernels a call) of ``fn``: the sum of every CUDA kernel
    it launches (or of those whose name holds ``match``; ``expect`` of them
    a call where given), from a `torch.profiler` window over ``reps`` calls
    that saw them all (`complete_window`)."""
    kern = complete_window(
        fn, what, reps, lambda name: "FillFunctor" not in name
        and (match is None or match in name), expect)
    return sum(kern) / reps, len(kern) / reps


FLUSH_BYTES = 256 << 20   # written before each cold-L2 call: 5x the L2


def _cold_device_ms(fn, what: str, flush_buf, expect: int,
                    reps: int = 5) -> float:
    """Device ms a call of ``fn`` with a cold L2: ``flush_buf`` (at least
    ``FLUSH_BYTES``) is filled before each call, and the sum leaves out the
    fill (and any memset) kernels; ``expect`` kernels a call must be
    seen."""
    def cold():
        flush_buf.fill_(1)
        return fn()
    kern = complete_window(
        cold, what, reps, lambda name: "FillFunctor" not in name
        and "Memset" not in name, expect)
    return sum(kern) / reps


def _conv_key(r: dict) -> str:
    from repro_torch.kernels.autotune import conv_key
    return conv_key(*(r[k] for k in ("B", "H", "W", "C", "K", "Cout")),
                    stride=r["stride"], padding=r["padding"],
                    groups=r["groups"])


def packaged_conv_knobs(r: dict) -> dict:
    """The launch knobs of the packaged autotune tier for one conv record
    (the knobs the main path launches it with; the heuristic's where the
    tier has no entry)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.log_conv2d import knob_args
    return knob_args(autotune._load_packaged("cuda").get(_conv_key(r), {})
                     .get("config"))


def phase_conv_times(dev) -> tuple[dict, list]:
    """Per-conv times at batch 8 over the 61 distinct conv shapes of the
    four nets, at the packaged tier's knobs (the main path's; where they
    differ from the heuristic's, the heuristic's device time beside).
    Kernel and library (`F.conv2d` on weights decoded in
    advance, layout copies included) are read as device time, the sum of
    the kernels of a call in a `torch.profiler` window; the CUDA-event mean
    of a loop of calls stands beside them.  Bound: max(bytes / 3.35 TB/s,
    FLOP / 989 TFLOP/s), the bf16 tensor-core peak the dense path runs on;
    the fp32 bound (FLOP / 67 TFLOP/s) is kept beside it.  Depthwise convs
    are also read with a cold L2 (`_cold_device_ms`), kernel and library:
    their x and y fit the 50 MB L2, so warm repetitions can read it from
    there."""
    from repro_torch.kernels.log_conv2d import (conv_nhwc, decode_codes,
                                                log_conv2d_blockwise,
                                                log_conv2d_fused,
                                                log_conv2d_geometry,
                                                log_conv2d_ref,
                                                normalize_padding)
    from repro_torch.models.cnn import CNNS, trace_conv_shapes, \
        zoo_conv_shapes
    rng = np.random.default_rng(SEED + 2)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    times = {}
    with torch.no_grad():
        for r in zoo_conv_shapes(batch=BATCH, img=IMG, n_classes=N_CLASSES):
            x, qt, hwio, codes, lane = make_conv(r, rng, dev)
            kw = dict(stride=r["stride"], padding=r["padding"],
                      groups=r["groups"])
            nbytes, flops = conv_cost(r)
            pads = normalize_padding(r["padding"], r["K"], r["stride"],
                                     r["H"], r["W"])
            w = decode_codes(hwio) * qt.scale.reshape(-1)

            knobs = packaged_conv_knobs(r)

            def kernel(knobs=knobs):
                return log_conv2d_fused(x, codes, qt.scale, lane=lane,
                                        config=knobs, **kw)

            def library():
                return conv_nhwc(x, w, stride=r["stride"], pads=pads,
                                 groups=r["groups"])
            ms, n_kern = _device_ms(kernel, f"kernel {sig(r)}")
            lib_ms, n_lib = _device_ms(library, f"library {sig(r)}")
            geo = log_conv2d_geometry(*(r[k] for k in (
                "B", "H", "W", "C", "K", "Cout", "stride", "padding",
                "groups")), n_sm=n_sm, **knobs)
            heur = log_conv2d_geometry(*(r[k] for k in (
                "B", "H", "W", "C", "K", "Cout", "stride", "padding",
                "groups")), n_sm=n_sm)
            # where the table departs from the heuristic, its time too
            heur_ms = ms if heur == geo else _device_ms(
                lambda: kernel(None), f"kernel heuristic {sig(r)}")[0]
            t = {"ms": ms, "kernels_per_call": n_kern,
                 "knobs": knobs, "heuristic_ms": heur_ms,
                 "time": "device time by torch.profiler",
                 "event_ms": time_ms(kernel, 5),
                 "library_ms": lib_ms, "library_kernels_per_call": n_lib,
                 "library_event_ms": time_ms(library, 5),
                 "decode_conv_ms": time_ms(lambda: log_conv2d_blockwise(
                     x, hwio, qt.scale, **kw), 5),
                 "plain_ms": time_ms(lambda: log_conv2d_ref(
                     x, hwio, qt.scale, **kw), 2),
                 "bytes_ms": nbytes / PEAK_HBM_BYTES * 1e3,
                 "ops_ms": flops / PEAK_BF16_FLOPS * 1e3,
                 "fp32_bound_ms": max(nbytes / PEAK_HBM_BYTES,
                                      flops / PEAK_FP32_FLOPS) * 1e3,
                 "gflop": flops / 1e9, "blocks": geo["blocks"],
                 "splits": geo["splits"], "path": geo["path"]}
            t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
            t["bound_by"] = ("operations" if t["ops_ms"] >= t["bytes_ms"]
                             else "bytes")
            t["tflops"] = flops / ms / 1e9
            msg = ""
            if geo["path"] == "depthwise":
                t["tile"], t["load"] = geo["tile"], geo["load"]
                t["cold_ms"] = _cold_device_ms(
                    kernel, f"kernel cold {sig(r)}", flush_buf,
                    round(n_kern))
                t["cold_library_ms"] = _cold_device_ms(
                    library, f"library cold {sig(r)}", flush_buf,
                    round(n_lib))
                msg = (f"; tile {geo['tile']}, cold L2: kernel "
                       f"{t['cold_ms']:.4f}, library "
                       f"{t['cold_library_ms']:.4f}")
            times[sig(r)] = t
            if heur != geo:
                msg += (f"; heuristic {heur['splits']} shares / tile "
                        f"{heur.get('tile')}: {heur_ms:.4f} ms")
            print(f"conv {'/'.join(sig(r))} ({','.join(r['nets'])}): kernel "
                  f"{ms:.4f} ms device ({t['tflops']:.1f} TFLOP/s, "
                  f"{geo['blocks']} blocks, {geo['splits']} shares; events "
                  f"{t['event_ms']:.4f}), library {lib_ms:.4f} ms device "
                  f"({n_lib:.0f} kernels; events {t['library_event_ms']:.4f})"
                  f", decode + conv {t['decode_conv_ms']:.4f}, plain "
                  f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} "
                  f"({t['bound_by']}), fp32 bound {t['fp32_bound_ms']:.4f}"
                  f"{msg}")
            del x, qt, hwio, codes, w
            torch.cuda.empty_cache()
    nets = []
    for name in CNNS:
        recs = trace_conv_shapes(name, batch=BATCH, img=IMG,
                                 n_classes=N_CLASSES)
        tot = {k: sum(times[sig(r)][k] for r in recs)
               for k in ("ms", "heuristic_ms", "event_ms", "library_ms",
                         "library_event_ms", "plain_ms", "decode_conv_ms",
                         "bound_ms", "fp32_bound_ms", "bytes_ms", "ops_ms",
                         "gflop")}
        tot["net"], tot["convs"] = name, len(recs)
        tot["dense_ms"] = sum(times[sig(r)]["ms"] for r in recs
                              if times[sig(r)]["path"] == "dense")
        tot["dense_library_ms"] = sum(
            times[sig(r)]["library_ms"] for r in recs
            if times[sig(r)]["path"] == "dense")
        dw = [times[sig(r)] for r in recs
              if times[sig(r)]["path"] == "depthwise"]
        tot["depthwise_convs"] = len(dw)
        for k in ("ms", "library_ms", "bound_ms", "cold_ms",
                  "cold_library_ms"):
            tot[f"depthwise_{k}"] = sum(t[k] for t in dw)
        nets.append(tot)
        print(f"convs {name:12s} x{len(recs)} at batch {BATCH}: kernel "
              f"{tot['ms']:.3f} ms device (heuristic's knobs "
              f"{tot['heuristic_ms']:.3f}; events {tot['event_ms']:.3f}; "
              f"dense convs {tot['dense_ms']:.3f}), library "
              f"{tot['library_ms']:.3f} ms device (events "
              f"{tot['library_event_ms']:.3f}; dense convs "
              f"{tot['dense_library_ms']:.3f}), decode + conv "
              f"{tot['decode_conv_ms']:.3f} ms, plain {tot['plain_ms']:.3f} "
              f"ms, bound {tot['bound_ms']:.3f} ms (fp32 bound "
              f"{tot['fp32_bound_ms']:.3f}; {tot['gflop']:.1f} GFLOP, "
              f"{tot['gflop'] / tot['ms']:.2f} TFLOP/s)")
        if dw:
            bound = tot["depthwise_bound_ms"]
            for k in ("ms", "library_ms", "cold_ms", "cold_library_ms"):
                tot[f"depthwise_share_of_bound_{k}"] = \
                    bound / tot[f"depthwise_{k}"]
            print(f"  depthwise convs x{len(dw)}: kernel "
                  f"{tot['depthwise_ms']:.4f} ms device, library "
                  f"{tot['depthwise_library_ms']:.4f}; bytes bound "
                  f"{bound:.4f} ms, share of bound "
                  f"{tot['depthwise_share_of_bound_ms']:.3f} (library "
                  f"{tot['depthwise_share_of_bound_library_ms']:.3f}); cold "
                  f"L2: kernel {tot['depthwise_cold_ms']:.4f} ms, library "
                  f"{tot['depthwise_cold_library_ms']:.4f}, share of bound "
                  f"{tot['depthwise_share_of_bound_cold_ms']:.3f} (library "
                  f"{tot['depthwise_share_of_bound_cold_library_ms']:.3f})")
    return times, nets


# ---------------------------------------------------------------------------
# the LM slice: log_matmul (B2) and attention (B3)
# ---------------------------------------------------------------------------


def _err_tol(y, want, rel: float) -> tuple[float, float]:
    tol = rel * (float(want.float().abs().max()) + 1)
    return float((y.float() - want.float()).abs().max()), tol


def phase_log_matmul(dev) -> tuple[list, float]:
    from repro_torch.core.logquant import quantize_tensor
    from repro_torch.kernels.log_conv2d import decode_codes
    from repro_torch.kernels.log_matmul import (log_matmul_cuda,
                                                log_matmul_geometry)
    from repro_torch.kernels.ref import ref_log_matmul
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    codes = torch.arange(128, dtype=torch.int8, device=dev).reshape(1, 128)
    y = log_matmul_cuda(torch.ones((1, 1), device=dev), codes,
                        torch.ones(128, device=dev))
    torch.cuda.synchronize()
    bad = int((y.reshape(-1).view(torch.int32)
               != decode_codes(codes).reshape(-1).view(torch.int32)).sum())
    print(f"log_matmul decode table: {128 - bad}/128 codes bit-exact")
    if bad:
        fail(f"{bad} codes decoded by log_matmul differ from decode_codes")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows, max_err = [], 0.0
    for m, k, n in MM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev)
        qt = quantize_tensor(torch.randn((k, n), generator=gen, device=dev)
                             * k ** -0.5)
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 8e-3)):
            xd = x.to(dtype)
            got = log_matmul_cuda(xd, qt.packed, qt.scale)
            again = log_matmul_cuda(xd, qt.packed, qt.scale)
            want = ref_log_matmul(xd, qt.packed, qt.scale)
            torch.cuda.synchronize()
            err, tol = _err_tol(got, want, rel)
            if got.dtype != dtype or got.shape != want.shape or err > tol \
                    or not bool(torch.isfinite(got).all()):
                fail(f"log_matmul {m}x{k}x{n} {dtype}: |kernel - ref| "
                     f"{err:.3e} > tol {tol:.3e} (or shape/dtype/finite)")
            if not torch.equal(got.view(torch.uint8), again.view(torch.uint8)):
                fail(f"log_matmul {m}x{k}x{n} {dtype}: two calls on the same "
                     f"inputs gave different bits")
            rows.append({"m": m, "k": k, "n": n, "dtype": str(dtype),
                         "err": err, "tol": tol,
                         "blocks": log_matmul_geometry(m, k, n, n_sm)[
                             "blocks"]})
            max_err = max(max_err, err)
    worst = max(r["err"] / r["tol"] for r in rows)
    print(f"log_matmul: {len(rows)} cases within tol (fp32 and bf16), each "
          f"bit-identical over two calls, max |kernel - ref| {max_err:.3e}, "
          f"worst err/tol {worst:.3e}")
    return rows, max_err


def phase_attention(dev) -> tuple[list, float]:
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_geometry,
                                                     mma_error_limit)
    from repro_torch.kernels.ops import AttentionConfig, attention
    from repro_torch.kernels.ref import ref_attention
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    f32, bf16 = torch.float32, torch.bfloat16
    rows4 = torch.tensor([63, 40, 17, 5], device=dev)
    cases = [((1, 48, 48, 8, hkv, 16), dict(window=w), f32, f32)
             for hkv in (1, 2, 8) for w in (None, 16)]
    cases += [
        ((1, 128, 128, 4, 4, 64), {}, f32, f32),
        ((2, 256, 256, 8, 2, 64), {}, f32, f32),
        ((1, 256, 256, 4, 1, 64), dict(window=64), f32, f32),
        ((1, 130, 130, 4, 2, 64), {}, f32, f32),
        ((3, 1, 32, 8, 2, 16), dict(q_offset=torch.tensor(
            [5, 20, 40], device=dev), k_offset=torch.tensor(
            [-26, -11, 9], device=dev), window=16), f32, f32),
        ((1, 1, 32, 4, 2, 16), dict(window=8, q_offset=22, k_offset=-9),
         f32, f32),
        ((1, 32, 32, 8, 1, 256), {}, f32, f32),
        ((1, 2048, 2048, 8, 1, 256), {}, f32, f32),
        ((4, 1, 64, 8, 1, 256), dict(q_offset=rows4), f32, f32),
        ((4, 1, 8192, 8, 1, 256), dict(q_offset=rows4 * 128 + 63), f32, f32),
        ((4, 1, 64, 8, 1, 256), dict(q_offset=rows4), bf16, f32),
        ((1, 2048, 2048, 8, 1, 256), {}, bf16, bf16),
    ]
    # the split-KV variant: Tk on either side of a split boundary (at B = 4
    # and one kv head, 4096 keys are 32 splits of 128, 8192 are 32 of 256;
    # one more key adds a split), splits emptied by a window and by keys at
    # positions < 0 (a ring), a row with no key at all
    for tk in (4096, 4097, 8193):
        for qdt in (f32, bf16):
            cases.append(((4, 1, tk, 8, 1, 256), dict(q_offset=torch.tensor(
                [tk - 1, tk - 2, 700, 0], device=dev)), qdt, f32))
    cases += [
        ((2, 1, 1000, 8, 1, 256), dict(window=100, q_offset=999), f32, f32),
        ((2, 1, 700, 8, 1, 256), dict(q_offset=199, k_offset=-500), bf16,
         f32),
        ((2, 1, 700, 8, 1, 256), dict(q_offset=torch.tensor(
            [699, 650], device=dev), k_offset=torch.tensor(
            [-500, -1000], device=dev)), f32, f32),
        # bf16 prefill on the tensor cores at ragged T, GQA and MHA widths
        ((1, 33, 33, 8, 1, 256), {}, bf16, bf16),
        ((1, 130, 130, 8, 1, 256), {}, bf16, bf16),
        ((2, 40, 40, 8, 2, 64), dict(window=16), bf16, bf16),
        ((1, 100, 100, 4, 4, 128), {}, bf16, bf16),
        # the tensor cores' heaviest-first row blocks (T a multiple of 64)
        # under a window, where outputs are O(0.1)
        ((1, 1024, 1024, 8, 1, 256), dict(window=100), bf16, bf16),
        ((2, 128, 128, 8, 2, 64), dict(window=48), bf16, bf16),
        # the split variant's other dtype pairs: bf16 decode over a bf16
        # cache, an fp32 q over bf16 keys, bf16 prefill at a head_dim the
        # tensor cores do not take
        ((4, 1, 64, 8, 1, 256), dict(q_offset=rows4), bf16, bf16),
        ((4, 1, 64, 8, 1, 256), dict(q_offset=rows4), f32, bf16),
        ((1, 40, 40, 8, 1, 40), {}, bf16, bf16),
        ((2, 40, 40, 8, 2, 40), dict(window=16), bf16, bf16),
        # k and v rows off 16-byte boundaries: element copies instead of
        # cp.async, for either kv dtype and for bf16 prefill
        ((4, 1, 1000, 8, 1, 256), dict(q_offset=rows4 * 15 + 63), bf16, f32,
         "unaligned"),
        ((2, 1, 700, 8, 1, 256), dict(q_offset=699), f32, bf16, "unaligned"),
        ((1, 64, 64, 8, 2, 64), {}, bf16, bf16, "unaligned"),
    ]
    rows, max_err, variants = [], 0.0, {}
    for (b, tq, tk, h, hkv, d), kw, qdt, kvdt, *layout in cases:
        q = torch.randn((b, tq, h, d), generator=gen, device=dev).to(qdt)
        k, v = (torch.randn((b, tk, hkv, d), generator=gen,
                            device=dev).to(kvdt) for _ in range(2))
        if layout:
            k, v = (_unaligned(a) for a in (k, v))
        geo = flash_attention_geometry(b, tq, tk, h, hkv, d, qdt, kvdt, n_sm,
                                       aligned=not layout)
        got = flash_attention_cuda(q, k, v, causal=True, **kw)
        again = flash_attention_cuda(q, k, v, causal=True, **kw)
        want = ref_attention(q, k, v, causal=True, **kw)
        bw = attention(q, k, v, causal=True, impl="blockwise",
                       config=AttentionConfig(block_k=1024), **kw)
        torch.cuda.synchronize()
        # a row with no key gives 0 in the kernel (the TPU kernel's l -> 1
        # guard) but uniform weights in the plain versions: it is held to 0
        dead = ~attention_rows_alive(q, tk, kw)
        want = torch.where(dead, torch.zeros((), device=dev, dtype=q.dtype),
                           want)
        bw = torch.where(dead, torch.zeros((), device=dev, dtype=q.dtype), bw)
        rel = 2e-4 if qdt == f32 else 8e-3
        err_r, tol = _err_tol(got, want, rel)
        err_b, _ = _err_tol(got, bw, rel)
        label = (f"attention B={b} Tq={tq} Tk={tk} H={h} Hkv={hkv} D={d} "
                 f"{ {k_: (v_.tolist() if torch.is_tensor(v_) else v_) for k_, v_ in kw.items()} } "
                 f"q {qdt} kv {kvdt}{' unaligned' if layout else ''} "
                 f"[{geo['variant']}, {geo['blocks']} blocks, "
                 f"{geo['splits']} splits]")
        if got.shape != q.shape or got.dtype != q.dtype \
                or max(err_r, err_b) > tol \
                or not bool(torch.isfinite(got).all()):
            fail(f"{label}: |kernel - ref| {err_r:.3e}, |kernel - "
                 f"blockwise| {err_b:.3e}, tol {tol:.3e}")
        if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
            fail(f"{label}: two calls on the same inputs gave different bits")
        row = {"case": label, "variant": geo["variant"],
               "blocks": geo["blocks"], "splits": geo["splits"],
               "err_ref": err_r, "err_blockwise": err_b, "tol": tol,
               "rows_with_no_key": int(dead[..., 0, 0].sum())}
        note = ""
        if geo["variant"] == "mma":
            # the tensor cores' own limit, element by element, from the
            # variant's arithmetic (`mma_error_limit`)
            o, limit = mma_error_limit(q, k, v, causal=True, **kw)
            err = (got.float() - o).abs()
            over = err > limit
            row["err_over_mma_limit"] = float(
                (err / limit).nan_to_num(posinf=float("inf")).max())
            if bool(over.any()):
                fail(f"{label}: {int(over.sum())} elements outside "
                     f"mma_error_limit (worst |kernel - o| "
                     f"{float(err[over].max()):.3e} against its limit "
                     f"{float(limit[over][err[over].argmax()]):.3e})")
            note = f", err/mma limit {row['err_over_mma_limit']:.3e}"
            del o, limit, err, over
        rows.append(row)
        variants[geo["variant"]] = variants.get(geo["variant"], 0) + 1
        max_err = max(max_err, err_r, err_b)
        print(f"  {label}: err/tol {max(err_r, err_b) / tol:.3e}{note}")
    worst = max(max(r["err_ref"], r["err_blockwise"]) / r["tol"]
                for r in rows)
    worst_mma = max(r.get("err_over_mma_limit", 0.0) for r in rows)
    print(f"attention: {len(rows)} cases within tol ({variants}), each "
          f"bit-identical over two calls, max |kernel - plain| {max_err:.3e}, "
          f"worst err/tol {worst:.3e}; tensor-core cases within "
          f"mma_error_limit, worst err/limit {worst_mma:.3e}")
    return rows, max_err


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a view one element into a wider buffer: unit stride along
    head_dim, rows that do not start on 16-byte boundaries."""
    wide = torch.zeros((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                       device=t.device)
    wide[..., 1:] = t
    return wide[..., 1:]


def attention_rows_alive(q, tk: int, kw: dict) -> torch.Tensor:
    """Boolean ``[B, Tq, 1, 1]`` (broadcast over heads and D): the query row
    sees at least one key under the causal, window and ``kpos < 0``
    masks."""
    from repro_torch.kernels.ref import attention_mask
    m = attention_mask(q.shape[1], tk, causal=True, window=kw.get("window"),
                       q_offset=kw.get("q_offset", 0),
                       k_offset=kw.get("k_offset", 0), device=q.device)
    return m.any(dim=-1).expand(q.shape[0], q.shape[1])[..., None, None]


def _serve_args(arch: str):
    from repro_torch.launch import serve
    # launch/serve.py's defaults, on the card, with the engine's telemetry
    # (host-clock histograms) on
    return serve.parse_args(["--arch", arch, "--device", "cuda",
                             "--telemetry", "on"])


# archs whose plain-engine logit check is held in fp32 activations, with the
# bf16 figure printed: random-weight RWKV amplifies a bf16 rounding through
# its stack, and in random-weight MoE a rounding turns a near-tie of the
# router, which moves the logits by O(max|l|) (both shown on the CPU for
# the JAX package too: tests/test_torch_rwkv.py, tests/test_torch_moe.py)
FP32_HELD = {RWKV_ARCH, MOE_ARCH}
# how many plain versions each per-call check holds a call against
PLAIN_CHECKS = {"log_matmul": 1, "attention": 2, "wkv6": 1}


def launches_per_forward(cfg) -> dict:
    """Kernel launches of one forward, counted from the layer pattern: an
    attention layer ("attn", "local") launches log_matmul for its four
    projections and attention once; a dense FFN launches log_matmul for
    each matrix (3 for GeGLU / SwiGLU, else 2), a MoE FFN none (its router
    and experts stay fp32, as in JAX); an RG-LRU mixer ("rec") launches
    nothing; an RWKV layer launches log_matmul for its 8 projections and
    wkv6 once.  gemma-2b: 18 x 7 = 126 and 18; rwkv6-1.6b: 192 and 24;
    recurrentgemma-2b: 18 rec x 3 + 8 local x 7 = 110 and 8;
    granite-moe-3b-a800m: 32 x 4 = 128 and 32."""
    ffn = 0 if cfg.is_moe else 3 if cfg.ffn in ("swiglu", "geglu") else 2
    n = {"log_matmul": 0, "attention": 0, "wkv6": 0}
    for unit, n_rep in cfg.segments:
        for kind in unit:
            if kind == "rwkv":
                n["log_matmul"] += 8 * n_rep
                n["wkv6"] += n_rep
                continue
            attn = kind != "rec"
            n["log_matmul"] += n_rep * (ffn + 4 * attn)
            n["attention"] += n_rep * attn
    return n


def _wrappers() -> dict:
    """The kernel wrapper of each op, whose ``launches`` count the kernel's
    launches."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_matmul import log_matmul_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda
    return {"log_matmul": log_matmul_cuda, "attention": flash_attention_cuda,
            "wkv6": wkv6_cuda}


def _checked_ops(ratios: dict) -> dict:
    """Stand-ins for `ops.log_matmul` / `ops.attention` / `ops.wkv6` that
    also run the plain versions on the same input and record err/tol."""
    from repro_torch.kernels import ops
    lm, at, wk = ops.log_matmul, ops.attention, ops.wkv6

    def log_matmul(x, qt, **kw):
        y = lm(x, qt, **kw)
        err, tol = _err_tol(y, lm(x, qt, impl="blockwise"),
                            1e-4 if y.dtype == torch.float32 else 8e-3)
        ratios["log_matmul"].append(err / tol)
        return y

    def attention(q, k, v, **kw):
        y = at(q, k, v, **kw)
        rel = 2e-4 if y.dtype == torch.float32 else 8e-3
        for impl in ("ref", "blockwise"):
            err, tol = _err_tol(y, at(q, k, v, **dict(kw, impl=impl)), rel)
            ratios["attention"].append(err / tol)
        return y

    def wkv6(r, k, v, logw, u, state=None, **kw):
        o, s = wk(r, k, v, logw, u, state, **kw)
        o_r, s_r = wk(r, k, v, logw, u, state, impl="ref")
        rel = 1e-4 if o.dtype == torch.float32 else 8e-3
        err_o, tol_o = _err_tol(o, o_r, rel)
        err_s, tol_s = _err_tol(s, s_r, rel)
        ratios["wkv6"].append(max(err_o / tol_o, err_s / tol_s))
        return o, s

    return {"log_matmul": log_matmul, "attention": attention, "wkv6": wkv6}


def _plain_ops() -> dict:
    """`ops` entries that run the plain versions: decode-then-matmul and
    the sequential WKV oracle (attention is made plain by the engine's
    ``attn_impl``)."""
    from repro_torch.kernels import ops
    lm, wk = ops.log_matmul, ops.wkv6
    return {"log_matmul": lambda x, qt, **kw: lm(x, qt, impl="blockwise"),
            "wkv6": lambda *a, **kw: wk(*a, **dict(kw, impl="ref"))}


class _patched:
    """Swap attributes of `repro_torch.kernels.ops` inside a with block."""

    def __init__(self, **fns):
        self.fns, self.saved = fns, {}

    def __enter__(self):
        from repro_torch.kernels import ops
        for name, fn in self.fns.items():
            self.saved[name] = getattr(ops, name)
            setattr(ops, name, fn)

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for name, fn in self.saved.items():
            setattr(ops, name, fn)
        return False


def _traced_prefill(eng, prompt) -> tuple:
    """``eng._prefill(0, prompt)`` → (logits, the router probabilities
    [Tpad, E] of each MoE layer in order; empty without MoE)."""
    from repro_torch.models import moe
    probs, route = [], moe.route

    def spy(p, xt, cfg, T, capacity=None):
        rt = route(p, xt, cfg, T, capacity)
        probs.append(rt["probs"].float())
        return rt
    moe.route = spy
    try:
        logits = eng._prefill(0, prompt).float()
    finally:
        moe.route = route
    return logits, probs


def _routing_flips(kern: list, plain: list, k: int, t: int) -> dict:
    """Top-k expert sets of the kernel and the plain engine, MoE layer by
    layer, over the ``t`` real tokens of a prefill: per layer the tokens
    whose set differs; for the first such layer, each flipped token's
    margin in the plain engine (log p of its k-th over its (k+1)-th
    expert) beside the median margin of the layer's tokens, and the largest
    move of a log-probability between the two engines, centred over the
    experts (a flip needs margin <= 2 x move: a near-tie is a margin far
    below the median that roundings of the router's input can turn)."""
    per_layer, first = [], None
    for layer, (a, b) in enumerate(zip(kern, plain)):
        a, b = a[:t], b[:t]
        sa = a.topk(k, dim=-1).indices.sort(dim=-1).values
        sb = b.topk(k, dim=-1).indices.sort(dim=-1).values
        flip = (sa != sb).any(dim=-1)
        per_layer.append(int(flip.sum()))
        if first is None and bool(flip.any()):
            lb = b.clamp_min(1e-30).log()
            top = lb.sort(dim=-1, descending=True).values
            margin = top[:, k - 1] - top[:, k]
            d = a.clamp_min(1e-30).log() - lb
            move = (d - d.mean(dim=-1, keepdim=True)).abs().amax(dim=-1)
            first = {"layer": layer, "tokens": flip.nonzero()[:, 0].tolist(),
                     "margin": margin[flip].tolist(),
                     "median_margin": float(margin.median()),
                     "move": move[flip].tolist(),
                     "median_move": float(move.median())}
    return {"tokens_flipped_per_layer": per_layer,
            "layers_with_flips": sum(n > 0 for n in per_layer),
            "first_flip": first}


def _vs_plain(engine, args, act_dtype=None) -> dict:
    """A kernel engine and an engine on the plain versions (blockwise
    attention, decode-then-matmul, the sequential WKV), on the engine's
    weights and in ``act_dtype`` (default: the config's): the prefill
    logits of the first request's prompt and the greedy tokens of the
    whole request set; for MoE archs also the routing of that prefill in
    both engines (`_routing_flips`)."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    cfg = engine.cfg if act_dtype is None else dataclasses.replace(
        engine.cfg, act_dtype=act_dtype)
    sizes = dict(max_batch=args.max_batch, max_prompt=args.max_prompt,
                 max_len=args.max_len)
    prompt = serve.make_requests(args, cfg.vocab)[0].prompt
    outs, logits, probs = {}, {}, {}
    for name, ecfg, ops_ in (
            ("kernel", EngineConfig(**sizes), {}),
            ("plain", EngineConfig(**sizes, attn_impl="blockwise"),
             _plain_ops())):
        eng = ServeEngine(cfg, engine.params, ecfg)
        with _patched(**ops_):
            for r in serve.make_requests(args, cfg.vocab):
                eng.submit(r)
            outs[name] = {r.uid: r.output for r in eng.run()}
            logits[name], probs[name] = _traced_prefill(eng, prompt)
    torch.cuda.synchronize()
    kern, plain = outs["kernel"], outs["plain"]
    prefix = [next((i for i, (a, b) in enumerate(zip(kern[u], plain[u]))
                    if a != b), len(plain[u])) for u in plain]
    res = {
        "prefill_logit_diff": float((logits["kernel"]
                                     - logits["plain"]).abs().max()),
        "max_abs_logit": float(logits["plain"].abs().max()),
        "same_top1": int(logits["kernel"].argmax())
        == int(logits["plain"].argmax()),
        "requests_identical": sum(p == args.max_new for p in prefix),
        "agreeing_prefix_tokens": prefix,
        "requests_of_one_token": sum(len(set(o)) == 1
                                     for o in kern.values()),
        "token_agreement": float(np.mean([kern[u][i] == plain[u][i]
                                          for u in plain
                                          for i in range(args.max_new)]))}
    if cfg.is_moe:
        res["routing"] = _routing_flips(probs["kernel"], probs["plain"],
                                        cfg.top_k, len(prompt))
    return res


def phase_serving(dev, arch: str) -> dict:
    """One arch of the LM slice served end to end by the port's engine:
    the main path with its launch counts, a steady run, prefill times,
    per-call checks, a plain engine and a profiled decode step."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    args = _serve_args(arch)
    wrappers = _wrappers()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = serve.build_engine(args)
    torch.cuda.synchronize()
    cfg = engine.cfg
    per_fwd = launches_per_forward(cfg)
    ops_run = [op for op, n in per_fwd.items() if n]
    res = {"arch": cfg.name, "build_s": time.perf_counter() - t0,
           "attn_impl": cfg.attn_impl,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_forward": per_fwd,
           "args": {k: v for k, v in vars(args).items()}}
    print(f"slice {cfg.name}: built and packed in {res['build_s']:.2f} s, "
          f"attn_impl={cfg.attn_impl}, {cfg.param_count() / 1e9:.3f} G "
          f"params, peak {res['peak_gib']:.2f} GiB; a forward launches "
          f"{per_fwd} (layer pattern {cfg.layer_pattern} over "
          f"{cfg.n_layers} layers)")
    if cfg.attn_impl != "cuda":
        fail(f"the engine resolved attn_impl to {cfg.attn_impl!r}, not cuda")

    # the main path: the counts are zeroed just before it and read just after
    reqs = serve.make_requests(args, cfg.vocab)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {op: w.launches for op, w in wrappers.items()}
    st = engine.stats
    fwd = st["prefill_calls"] + st["decode_steps"]
    want = {op: per_fwd[op] * fwd for op in wrappers}
    res.update(launches=launches, expected_launches=want, stats=st,
               first_run_s=wall)
    print(f"main path: {len(done)} requests, {st} ({fwd} forwards); kernel "
          f"launches {launches}, expected {want}; {wall:.3f} s cold")
    if launches != want:
        fail("kernel launch counts on the main path do not match the "
             "engine's forwards")
    if len(done) != args.requests or any(
            len(r.output) != args.max_new or min(r.output) < 0
            or max(r.output) >= cfg.vocab for r in done):
        fail("a request came back with the wrong number of tokens or an "
             "out-of-vocabulary token")
    outputs = {r.uid: r.output for r in done}

    # steady timing: the same requests again, on a fresh engine over the
    # same (warm) weights and kernels
    steady = ServeEngine(cfg, engine.params, engine.ecfg)
    t0 = time.perf_counter()
    for r in serve.make_requests(args, cfg.vocab):
        steady.submit(r)
    done2 = steady.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done2)
    hist = steady.metrics_snapshot()["engine"]["histograms"]
    step, pre = hist["serve_decode_step_s"], hist["serve_prefill_s"]
    res.update(steady_s=wall, tokens=toks, tokens_per_s=toks / wall,
               decode_step_ms_mean=step["mean"] * 1e3,
               decode_step_ms_p50=step["p50"] * 1e3,
               decode_step_ms_min=step["min"] * 1e3,
               prefill_ms_mean=pre["mean"] * 1e3,
               ttft_ms_p50=hist["serve_ttft_s"]["p50"] * 1e3,
               repeat_identical=all(r.output == outputs[r.uid]
                                    for r in done2))
    print(f"steady run: {toks} tokens in {wall:.3f} s ({toks / wall:.1f} "
          f"tokens/s); decode step mean {res['decode_step_ms_mean']:.3f} ms"
          f" (min {res['decode_step_ms_min']:.3f}, p50 bucket "
          f"{res['decode_step_ms_p50']:.3f}); prefill mean "
          f"{res['prefill_ms_mean']:.3f} ms; outputs repeat the first run: "
          f"{res['repeat_identical']}")

    # prefill per prompt length (attention-only archs pad to 4, 8 or 16
    # tokens; recurrent ones run the exact length)
    res["prefill_ms"] = {}
    for T in (3, 8, 15):
        prompt = np.arange(1, T + 1)
        ms = 1e3 * _host_time(lambda: steady._prefill(0, prompt), 5)
        label = (f"T={T} bucket {1 << (T - 1).bit_length()}"
                 if steady._pad_prefill else f"T={T}")
        res["prefill_ms"][label] = ms
    print(f"prefill ms per prompt length: {res['prefill_ms']}")

    # one prefill and one decode step with every call held against plain
    ratios = {op: [] for op in ops_run}
    eng_c = ServeEngine(cfg, engine.params, engine.ecfg)
    eng_c.submit(serve.make_requests(args, cfg.vocab)[0])
    checked = _checked_ops(ratios)
    with _patched(**{op: checked[op] for op in ops_run}):
        eng_c.step()
        torch.cuda.synchronize()
    res["per_call"] = {k: {"calls": len(v) // PLAIN_CHECKS[k],
                           "worst_err_over_tol": max(v)}
                       for k, v in ratios.items()}
    print(f"per-call check over one prefill and one decode step: "
          f"{res['per_call']}")
    if any(len(ratios[op]) != 2 * per_fwd[op] * PLAIN_CHECKS[op]
           for op in ops_run) \
            or max(max(v) for v in ratios.values()) > 1.0:
        fail("a kernel call of the slice disagrees with its plain version "
             "(or was not seen)")

    # the kernel engine against an engine on the plain versions, on the
    # same weights, within 0.02 * (max|l| + 1).  Random-weight RWKV
    # amplifies one bf16 rounding of a WKV output (about 0.3 % after the
    # group norm) to O(1) logit differences over its 24 layers, and in
    # random-weight granite a bf16 rounding of a router input turns a
    # near-tie between the 8th and 9th expert, so two correct bf16 versions
    # differ by about max|l| there: their limit is held in fp32 activations,
    # and the bf16 difference (with granite's routing flips) is printed.
    res["vs_plain"] = _vs_plain(engine, args)
    print(f"vs plain engine (blockwise attention, decode-then-matmul, "
          f"sequential WKV), {cfg.act_dtype}: {res['vs_plain']}")
    held = res["vs_plain"]
    if arch in FP32_HELD:
        held = res["vs_plain_fp32"] = _vs_plain(engine, args, torch.float32)
        print(f"vs plain engine, fp32 activations: {held}")
    held["tol"] = tol = 0.02 * (held["max_abs_logit"] + 1)
    if held["prefill_logit_diff"] > tol:
        fail(f"prefill logits differ from the plain engine's by "
             f"{held['prefill_logit_diff']:.3e} > tol {tol:.3e}")

    # one profiled decode step with all slots busy
    eng_d = ServeEngine(cfg, engine.params, engine.ecfg)
    for r in serve.make_requests(args, cfg.vocab)[:args.max_batch]:
        eng_d.submit(r)
    eng_d.step()           # prefills + one decode
    eng_d.step()
    step_ms = 1e3 * _host_time(eng_d.step, 3)
    prof = profile_forward(eng_d.step)
    prof["step_ms"] = step_ms
    prof["idle_share"] = (1 - prof["device_busy_ms"] / step_ms
                          if prof["device_kernels"] else None)
    res["profiled_decode_step"] = prof
    print(f"profiled decode step ({args.max_batch} busy slots): "
          f"{step_ms:.3f} ms host clock, {prof['device_kernels']} device "
          f"kernels, busy {prof['device_busy_ms']:.3f} ms, idle share "
          f"{prof['idle_share']}, log_matmul kernels "
          f"{prof['log_matmul_ms']:.4f} ms, attention kernels "
          f"{prof['attention_ms']:.4f} ms, top {prof['top_kernels_ms']}")

    # one more decode step with the kernel-dispatch profiler on: a record a
    # shape key, each beside its bytes bound
    res["profiled_keys"] = profiled_records(
        eng_d.step, f"{cfg.name} decode step ({args.max_batch} busy slots)")
    res["engine"] = engine
    return res


def record_row(r: dict) -> dict:
    """One kernel-dispatch profiler record, with its time (the steady mean,
    or the first call where there is no steady one), its rate and the
    least time its bytes take at 3.35 TB/s."""
    us = r["steady_us"] if r["steady_us"] is not None else r["first_us"]
    nbytes = r["bytes"]["total"]
    return {"op": r["op"], "impl": r["impl"], "key": r["key"],
            "calls": r["calls"], "first_us": r["first_us"],
            "steady_us": r["steady_us"], "us": us, "bytes": nbytes,
            "gb_per_s": nbytes / us / 1e3,
            "share_of_hbm_rate": nbytes / us / 1e3 / (PEAK_HBM_BYTES / 1e9),
            "bytes_bound_us": nbytes / PEAK_HBM_BYTES * 1e6,
            "total_us": us * r["calls"]}


def print_records(rows: list, what: str, n: int = 10) -> None:
    """The ``n`` records that take the most time in all."""
    print(f"{what}: {len(rows)} kernel-dispatch records, the top {n} by "
          f"total time (op, key, calls, steady µs, bytes, GB/s, share of "
          f"3.35 TB/s):")
    for r in sorted(rows, key=lambda r: -r["total_us"])[:n]:
        print(f"  {r['op']:10s} {r['key']:58s} {r['calls']:5d} "
              f"{r['us']:10.2f} {r['bytes']:11d} {r['gb_per_s']:8.1f} "
              f"{r['share_of_hbm_rate']:.3f}")


def profiled_records(fn, what: str) -> list:
    """The kernel-dispatch profiler's records of one call of ``fn``."""
    from repro_torch.obs import kernel_profile as kprof
    kprof.clear()
    kprof.set_enabled(True)
    try:
        fn()
        rows = [record_row(r) for r in kprof.snapshot()["records"]]
    finally:
        kprof.set_enabled(None)
        kprof.clear()
    print_records(rows, what)
    return rows


def _host_time(fn, reps: int) -> float:
    """Mean host-clock seconds of ``fn`` over ``reps`` calls that each end
    in a device synchronisation, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def _attention_work(q, k, mask) -> tuple[int, int]:
    """(bytes, FLOP) one attention call needs on this data: q read and the
    output written once; K and V read once for each key that some query of
    the batch row attends (the kernel skips fully masked tiles); 4·D FLOP
    per query head for each unmasked (query, key) pair."""
    B, _, H, D = q.shape
    m = mask.expand(B, *mask.shape[1:])
    keys = int(m.any(dim=1).sum())
    nbytes = 2 * q.numel() * q.element_size() \
        + 2 * keys * k.shape[2] * D * k.element_size()
    return nbytes, 4 * H * D * int(m.sum())


def _layer_products(engine) -> list:
    """The packed weights of every dense product of one forward, layer by
    layer, as `QuantizedTensor` views of the stacked leaves."""
    from repro_torch.core.logquant import QuantizedTensor
    from repro_torch.models.transformer import _rep

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, QuantizedTensor):
            yield tree
    return [qt for si, (_, n_rep) in enumerate(engine.cfg.segments)
            for r in range(n_rep)
            for qt in leaves(_rep(engine.params["segments"][f"seg{si}"], r))]


def phase_matmul_times(dev, engine, arch: str) -> dict:
    """log_matmul at an LM's own shapes: its products of one forward (each
    with its own layer's codes) at M = max_batch rows (a decode step) and
    M = 16, in the activation dtype.  Kernel and library (`torch.matmul`
    on weights decoded in advance) are read as device time, the sum of
    their kernels in a `torch.profiler` window; beside them the CUDA-event
    time of the loop of calls, the wrapper's host time a call, the plain
    version, the bound and the blocks per launch."""
    from repro_torch.kernels.log_conv2d import decode_codes
    from repro_torch.kernels.log_matmul import (log_matmul_cuda,
                                                log_matmul_geometry)
    from repro_torch.kernels.ref import ref_log_matmul
    cfg = engine.cfg
    B = engine.ecfg.max_batch
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    mats = _layer_products(engine)
    if len(mats) != launches_per_forward(cfg)["log_matmul"]:
        fail(f"{arch}: {len(mats)} packed products, expected "
             f"{launches_per_forward(cfg)['log_matmul']} a forward")
    out = {}
    for M in (B, 16):
        xs = {qt.packed.shape[0]: torch.randn(
            (M, qt.packed.shape[0]), generator=gen, device=dev).to(
            cfg.act_dtype) for qt in mats}

        def kernel():
            return [log_matmul_cuda(xs[qt.packed.shape[0]], qt.packed,
                                    qt.scale) for qt in mats]
        reps = 3
        lm = complete_window(kernel, f"{arch} M={M} log_matmul", reps,
                             lambda name: "log_matmul_kernel" in name,
                             expect=len(mats), min_share=0.98)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel()
        host_us = (time.perf_counter() - t0) / len(mats) * 1e6
        torch.cuda.synchronize()
        code_bytes = sum(qt.packed.numel() for qt in mats)
        nbytes = sum(qt.packed.numel() + 2 * M * qt.packed.shape[0]
                     + 4 * qt.packed.shape[1] + 2 * M * qt.packed.shape[1]
                     for qt in mats)
        flops = sum(2 * M * qt.packed.numel() for qt in mats)
        # the sum over one pass of the products; where the profiler dropped
        # an event (at most 2 % of them), the mean of those it saw stands in
        # for it
        t = {"calls": len(mats),
             "ms": sum(lm) / reps * reps * len(mats) / len(lm),
             "time": "device time by torch.profiler, sum over the calls",
             "profiler_kernels_seen": f"{len(lm)} of {reps * len(mats)}",
             "event_loop_ms": time_ms(kernel, 5),
             "host_us_per_call": host_us,
             "bytes_ms": nbytes / PEAK_HBM_BYTES * 1e3,
             "ops_ms": flops / PEAK_FP32_FLOPS * 1e3, "gbytes": nbytes / 1e9,
             "code_gbytes": code_bytes / 1e9}
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["code_tb_per_s"] = code_bytes / t["ms"] / 1e9
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        if M == B:
            t["plain_ms"] = time_ms(lambda: [ref_log_matmul(
                xs[qt.packed.shape[0]], qt.packed, qt.scale)
                for qt in mats], 2)
        w_lib = [(decode_codes(qt.packed) * qt.scale).to(cfg.act_dtype)
                 for qt in mats]

        def library():
            return [torch.matmul(xs[w.shape[0]], w) for w in w_lib]
        lib = [k for k in device_kernels(library, reps, opener=True)
               if "FillFunctor" not in k[0]]
        t["library_ms"] = sum(ms for _, ms in lib) / reps
        t["library_kernels"] = len(lib) / reps
        t["library_event_loop_ms"] = time_ms(library, 5)
        del w_lib
        torch.cuda.empty_cache()
        t["blocks"] = {f"{k}x{n}": log_matmul_geometry(M, k, n, n_sm)[
            "blocks"] for k, n in sorted({tuple(qt.packed.shape)
                                          for qt in mats})}
        out[f"log_matmul M={M}"] = t
        print(f"log_matmul x{len(mats)} ({arch}, one forward) at M={M}: "
              f"device {t['ms']:.4f} ms ({t['code_tb_per_s']:.3f} TB/s of "
              f"{t['code_gbytes']:.3f} GB of codes, {t['share_of_bound']:.3f}"
              f" of the bound), library device {t['library_ms']:.4f} ms "
              f"({t['library_kernels']:.0f} kernels), bound {t['bound_ms']:.4f} "
              f"ms; event loop {t['event_loop_ms']:.4f} ms (library "
              f"{t['library_event_loop_ms']:.4f}), host "
              f"{t['host_us_per_call']:.1f} us a call, plain "
              f"{t.get('plain_ms', float('nan')):.3f} ms; blocks per launch "
              f"{t['blocks']}")
    return out


def phase_lm_times(dev, engine) -> dict:
    """Kernel, plain, library and bound of the attention kernel at the
    slice's own shapes: the 18 calls of one decode step over the engine's
    cache (bf16 q, fp32 cache, per-row offsets), a B = 4 decode over 8192
    keys (fp32) and a causal T = 2048 prefill (bf16).  Kernel and library
    (SDPA with the kv head expanded and the mask given) are read as device
    time, the sum of their kernels in a `torch.profiler` window, with the
    CUDA-event time of the loop of calls beside each.  The bound takes the peak of the unit each variant
    runs on: fp32 for split-KV, bf16 tensor cores for the mma variant."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (attention_traffic_bytes,
                                                     flash_attention_cuda,
                                                     flash_attention_geometry)
    from repro_torch.kernels.ref import attention_mask, ref_attention
    from repro_torch.models.transformer import _rep
    cfg = engine.cfg
    B = engine.ecfg.max_batch
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {}

    def measure(name, calls, kern, plain, lib, q, k, mask, plain_reps,
                knobs):
        geo = flash_attention_geometry(q.shape[0], q.shape[1], k.shape[1],
                                       q.shape[2], k.shape[2], q.shape[3],
                                       q.dtype, k.dtype, n_sm, **knobs)
        peak = PEAK_BF16_FLOPS if geo["variant"] == "mma" else PEAK_FP32_FLOPS
        ms, _ = _device_ms(kern, f"{name} kernel", reps=3, match="attn_",
                           expect=calls)
        nbytes, flops = (calls * x for x in _attention_work(q, k, mask))
        t = {"calls": calls, "variant": geo["variant"],
             "blocks": geo["blocks"], "splits": geo["splits"], "ms": ms,
             "time": "device time by torch.profiler, sum over the calls",
             "event_ms": time_ms(kern, 10),
             "library_ms": _device_ms(lib, f"{name} library", reps=3)[0],
             "library_event_ms": time_ms(lib, 10),
             "plain_ms": time_ms(plain, plain_reps),
             "bytes_ms": nbytes / PEAK_HBM_BYTES * 1e3,
             "ops_ms": flops / peak * 1e3,
             "peak_tflops": peak / 1e12, "gflop": flops / 1e9,
             "kernel_traffic_bytes": calls * attention_traffic_bytes(
                 "cuda", q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                 k.shape[2], q.shape[3], itemsize=k.element_size(),
                 config=knobs)["total"]}
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "operations" if t["ops_ms"] >= t["bytes_ms"] \
            else "bytes"
        t["tflops"] = flops / t["ms"] / 1e9
        out[name] = t
        print(f"{name} [{geo['variant']}, {geo['blocks']} blocks, "
              f"{geo['splits']} splits]: kernel {t['ms']:.4f} ms device "
              f"({t['tflops']:.1f} TFLOP/s; events {t['event_ms']:.4f}), "
              f"library {t['library_ms']:.4f} ms device (events "
              f"{t['library_event_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}, "
              f"{t['peak_tflops']:.0f} TFLOP/s peak)")

    # attention of one decode step over the engine's (filled) cache
    caches = [_rep(engine.cache["segments"]["seg0"], r)["l0"]
              for r in range(cfg.n_layers)]
    S = caches[0]["k"].shape[1]
    offs = torch.tensor([S - 1, S - 9, 20, 5], device=dev)[:B]
    q = torch.randn((B, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev).to(cfg.act_dtype)
    mask = attention_mask(1, S, causal=True, window=None, q_offset=offs,
                          k_offset=0, device=dev)
    rep = cfg.n_heads // cfg.n_kv_heads
    lib_kv = [(c["k"].transpose(1, 2).repeat_interleave(rep, 1),
               c["v"].transpose(1, 2).repeat_interleave(rep, 1))
              for c in caches]
    qf = q.float().transpose(1, 2)
    kw = dict(causal=True, q_offset=offs)
    # the knobs the engine's decode launches with (the packaged tier's)
    knobs = ops.attention_knobs(q, caches[0]["k"], caches[0]["v"],
                                causal=True)
    measure(
        "attention decode", cfg.n_layers,
        lambda: [flash_attention_cuda(q, c["k"], c["v"], **kw, config=knobs)
                 for c in caches],
        lambda: [ref_attention(q, c["k"], c["v"], **kw) for c in caches],
        lambda: [F.scaled_dot_product_attention(
            qf, k, v, attn_mask=mask[:, None]) for k, v in lib_kv],
        q, caches[0]["k"], mask, 5, knobs)

    # attention at the long shapes of phase 8, one call each
    for (b, tq, tk), dt in (((4, 1, 8192), torch.float32),
                            ((1, 2048, 2048), torch.bfloat16)):
        qq = torch.randn((b, tq, cfg.n_heads, cfg.head_dim), generator=gen,
                         device=dev).to(dt)
        kk, vv = (torch.randn((b, tk, 1, cfg.head_dim), generator=gen,
                              device=dev).to(dt) for _ in range(2))
        off = tk - tq
        m = attention_mask(tq, tk, causal=True, window=None, q_offset=off,
                           k_offset=0, device=dev)
        kl, vl = (a.transpose(1, 2).expand(b, cfg.n_heads, tk, cfg.head_dim)
                  for a in (kk, vv))
        ql = qq.transpose(1, 2)
        measure(f"attention B={b} Tq={tq} Tk={tk} {dt}", 1,
                lambda: flash_attention_cuda(qq, kk, vv, causal=True,
                                             q_offset=off),
                lambda: ref_attention(qq, kk, vv, causal=True, q_offset=off),
                lambda: F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=m[:, None]),
                qq, kk, m, 2, {"splits": None})
    return out


# ---------------------------------------------------------------------------
# the RWKV slice: wkv6 (B4)
# ---------------------------------------------------------------------------


def _wkv_inputs(gen, dev, b, t, h, kd, vd, dtype=torch.float32, logw=None,
                state=True):
    """r, k, v (in ``dtype``), logw and u (fp32) as
    `tests/test_kernels_wkv6.py` draws them (log decay in about
    [-2, -0.02] unless ``logw`` fixes it), and a random fp32 state."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    r, k = randn(b, t, h, kd) * 0.5, randn(b, t, h, kd) * 0.5
    v = randn(b, t, h, vd) * 0.5
    lw = -torch.exp(randn(b, t, h, kd) * 0.5 - 1.5)
    if logw is not None:
        lw = torch.full_like(lw, logw)
    u = randn(h, kd) * 0.3
    s0 = randn(b, h, kd, vd) * 0.5 if state else None
    return [a.to(dtype) for a in (r, k, v)] + [lw, u, s0]


def phase_wkv6(dev) -> tuple[list, float]:
    """The wkv6 kernel against `ref_wkv6` (and `wkv6_chunked` where its
    closed form is finite), for o and S_T: the shapes of
    `tests/test_kernels_wkv6.py`, rwkv6-1.6b's decode, prefill and a long
    call, fp32 and bf16 r/k/v, a carried state and a strong decay."""
    from repro_torch.kernels.ref import ref_wkv6
    from repro_torch.kernels.wkv6 import (wkv6_chunked, wkv6_cuda,
                                          wkv6_geometry)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    H, hs = 32, 64                               # rwkv6-1.6b's heads
    cases = [((1, 64, 2, 32, 32), {}), ((2, 96, 2, 16, 32), {}),
             ((1, 33, 1, 8, 8), {}),             # test_kernels_wkv6 shapes
             ((2, 96, 2, 16, 32), dict(state=False)),
             ((4, 1, H, hs, hs), {}),            # decode, 4 slots
             ((1, 3, H, hs, hs), dict(state=False)),   # prefill
             ((1, 15, H, hs, hs), dict(state=False)),
             ((1, 2048, H, hs, hs), {}),         # a long call
             # either side of the variant threshold (T = 4 | 5), of a
             # sub-chunk (16 | 17) and of a chunk (32 | 33)
             ((1, 4, H, hs, hs), {}), ((1, 5, H, hs, hs), {}),
             ((1, 16, H, hs, hs), {}), ((1, 17, H, hs, hs), {}),
             ((1, 32, H, hs, hs), {}), ((1, 33, H, hs, hs), {}),
             # V not a multiple of the tile (40 = 16 + 16 + 8), in both
             # variants, and rows that take element copies (K = 24, V = 37)
             ((1, 40, 2, hs, 40), {}), ((3, 3, 2, hs, 40), {}),
             ((1, 70, 2, 24, 37), {}),
             # strong decays: -7, the clip's floor -e^2 at the long call's
             # length, and -20
             ((1, 64, H, hs, hs), dict(logw=-7.0)),
             ((1, 2048, H, hs, hs), dict(logw=-float(np.e ** 2))),
             ((1, 100, H, hs, hs), dict(logw=-20.0))]
    rows, max_err = [], 0.0
    for (b, t, h, kd, vd), kw in cases:
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 8e-3)):
            r, k, v, lw, u, s0 = _wkv_inputs(gen, dev, b, t, h, kd, vd,
                                             dtype, **kw)
            o, s = wkv6_cuda(r, k, v, lw, u, s0)
            o2, s2 = wkv6_cuda(r, k, v, lw, u, s0)
            o_r, s_r = ref_wkv6(r, k, v, lw, u, s0)
            o_c, s_c = wkv6_chunked(r, k, v, lw, u, s0,
                                    chunk=min(64, max(16, t)))
            torch.cuda.synchronize()
            geo = wkv6_geometry(b, t, h, kd, vd)
            label = (f"wkv6 B={b} T={t} H={h} K={kd} V={vd} {dtype} "
                     f"{kw or ''}")
            if o.shape != o_r.shape or o.dtype != dtype \
                    or s.dtype != torch.float32 \
                    or not bool(torch.isfinite(o).all()) \
                    or not bool(torch.isfinite(s).all()):
                fail(f"{label}: shape, dtype or non-finite output")
            if not (torch.equal(o, o2) and torch.equal(s, s2)):
                fail(f"{label}: two calls gave different bits")
            row = {"case": label, "variant": geo["variant"],
                   "tile": geo["tile"], "blocks": geo["blocks"]}
            if dtype == torch.float32:
                print(f"  {label}: {geo['variant']}, {geo['blocks']} blocks "
                      f"of {geo['tile']} columns")
            chunked_finite = bool(torch.isfinite(o_c.float()).all())
            row["chunked_finite"] = chunked_finite
            plains = {"ref": (o_r, s_r)}
            if chunked_finite:
                plains["chunked"] = (o_c, s_c)
            for name, (po, ps) in plains.items():
                for part, got, want in (("o", o, po), ("S", s, ps)):
                    err, tol = _err_tol(got, want, rel)
                    row[f"{part}_vs_{name}"] = err
                    row[f"{part}_tol"] = tol
                    if err > tol:
                        fail(f"{label}: |kernel {part} - {name}| {err:.3e} "
                             f"> tol {tol:.3e}")
                    max_err = max(max_err, err)
            rows.append(row)
            if "logw" in kw and dtype == torch.float32:
                print(f"strong decay logw={kw['logw']}: kernel finite, "
                      f"|o - ref| {row['o_vs_ref']:.3e}; the chunked plain "
                      f"version gave NaN: {not chunked_finite}")

    # state carry: two halves on the kernel equal the whole
    r, k, v, lw, u, s0 = _wkv_inputs(gen, dev, 1, 64, H, hs, hs)
    o_w, s_w = wkv6_cuda(r, k, v, lw, u, s0)
    o1, s1 = wkv6_cuda(*(a[:, :40].contiguous() for a in (r, k, v, lw)), u,
                       s0)
    o2, s2 = wkv6_cuda(*(a[:, 40:].contiguous() for a in (r, k, v, lw)), u,
                       s1)
    torch.cuda.synchronize()
    err_o, tol_o = _err_tol(torch.cat([o1, o2], 1), o_w, 1e-4)
    err_s, tol_s = _err_tol(s2, s_w, 1e-4)
    rows.append({"case": "state carry 40 + 24 vs 64", "o_vs_whole": err_o,
                 "S_vs_whole": err_s, "o_tol": tol_o, "S_tol": tol_s})
    if err_o > tol_o or err_s > tol_s:
        fail(f"wkv6 state carry: |halves - whole| {err_o:.3e} / {err_s:.3e}")
    worst = max(max(v_ / r_[f"{p}_tol"] for p in ("o", "S")
                    for k_, v_ in r_.items() if k_.startswith(f"{p}_vs"))
                for r_ in rows)
    print(f"wkv6: {len(rows)} cases within tol (fp32 and bf16, o and S_T), "
          f"each bit-identical over two calls, max |kernel - plain| "
          f"{max_err:.3e}, worst err/tol {worst:.3e}")
    return rows, max_err


def phase_wkv6_times(dev, engine) -> dict:
    """Kernel, plain (`ref_wkv6`, `wkv6_chunked`) and bound for the wkv6
    calls of the RWKV slice: the 24 calls of one decode step (4 slots,
    bf16 r/k/v, fp32 logw, each layer's own u and state from the engine's
    cache), the 24 calls of a 15-token prefill and one T = 2048 call.

    The timing runs in a process of its own (``chip_smoke.py
    --wkv6-times``, `wkv6_times_check`) on the layers' u and states saved
    to a file: late in a long process the `torch.profiler` windows lose
    kernel events (phase 19 runs apart for the same reason)."""
    import os
    import tempfile
    from repro_torch.models.transformer import _rep
    cfg, params = engine.cfg, engine.params
    layers = [(_rep(params["segments"]["seg0"], r)["l0"]["rwkv"]["u"].cpu(),
               _rep(engine.cache["segments"]["seg0"], r)["l0"]["wkv"].cpu())
              for r in range(cfg.n_layers)]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-wkv6-") as tmp:
        path = os.path.join(tmp, "layers.pt")
        torch.save({"layers": layers, "d_model": cfg.d_model,
                    "head_size": cfg.rwkv_head_size,
                    "act_dtype": str(cfg.act_dtype).removeprefix("torch."),
                    "max_batch": engine.ecfg.max_batch}, path)
        out = _subprocess("--wkv6-times", CHIP_SMOKE_WKV6_LAYERS=path)
    RETAKEN.extend(out.pop("profiler_windows_retaken"))
    return out


def wkv6_times_check() -> int:
    """``chip_smoke.py --wkv6-times``: phase 13's wkv6 timing in a fresh
    process, on the layers saved by `phase_wkv6_times`; prints its result
    as the last line, ``{"wkv6_times": {...}}``."""
    import os
    dev = torch.device("cuda", 0)
    saved = torch.load(os.environ["CHIP_SMOKE_WKV6_LAYERS"],
                       map_location=dev)
    out = _wkv6_times(dev, saved["layers"], saved["d_model"],
                      saved["head_size"],
                      getattr(torch, saved["act_dtype"]), saved["max_batch"])
    out["profiler_windows_retaken"] = RETAKEN
    print(json.dumps({"wkv6_times": out}, default=str))
    return 0


def _wkv6_times(dev, layers, d_model, hs, act_dtype, max_batch) -> dict:
    from repro_torch.kernels.ref import ref_wkv6
    from repro_torch.kernels.wkv6 import (wkv6_chunked, wkv6_cuda,
                                          wkv6_geometry, wkv6_work)
    H = d_model // hs
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {}
    for label, (b, t), reps in (("decode step", (max_batch, 1), 10),
                                ("prefill T=15", (1, 15), 5),
                                ("T=2048", (1, 2048), 3)):
        calls = layers if t < 2048 else layers[:1]
        ins = []
        for u, s in calls:  # the engine passes a state at prefill too
            r, k, v, lw, _, _ = _wkv_inputs(gen, dev, b, t, H, hs, hs,
                                            act_dtype, state=False)
            ins.append((r, k, v, lw, u, s[:b]))
        chunk = min(64, max(16, t))

        def kernel():
            return [wkv6_cuda(*a) for a in ins]
        # as for log_matmul: where the profiler dropped an event (at most
        # 2 % of them; a window loses one or two, also when it holds only
        # 50 T = 2048 calls), the mean of those it saw stands in for it, so
        # a window holds at least 100 kernels
        n_win = max(5, -(-100 // len(ins)))
        seen = complete_window(kernel, f"wkv6 {label}", n_win,
                               lambda name: "wkv6_decode_kernel" in name
                               or "wkv6_chunked_kernel" in name,
                               expect=len(ins), min_share=0.98)
        tt = {"calls": len(ins), "ms": sum(seen) / len(seen) * len(ins),
              "time": "device time by torch.profiler; the others by CUDA "
              "events",
              "profiler_kernels_seen": f"{len(seen)} of {n_win * len(ins)}",
              "event_ms": time_ms(kernel, reps),
              "plain_ms": time_ms(lambda: [ref_wkv6(*a) for a in ins],
                                  1 if t == 2048 else 2),
              "chunked_plain_ms": time_ms(lambda: [wkv6_chunked(
                  *a, chunk=chunk) for a in ins], 2),
              "library_ms": None}
        nbytes = flops = 0
        for r, _, v, lw, _, _ in ins:
            nb, fl = wkv6_work(r, v, lw)
            nbytes, flops = nbytes + nb, flops + fl
        tt.update(bytes_ms=nbytes / PEAK_HBM_BYTES * 1e3,
                  ops_ms=flops / PEAK_FP32_FLOPS * 1e3, mbytes=nbytes / 1e6)
        tt["bound_ms"] = max(tt["bytes_ms"], tt["ops_ms"])
        tt["bound_by"] = ("operations" if tt["ops_ms"] >= tt["bytes_ms"]
                          else "bytes")
        tt["bound_share"] = tt["bound_ms"] / tt["ms"]
        geo = wkv6_geometry(b, t, H, hs, hs)
        tt.update(variant=geo["variant"], blocks=geo["blocks"],
                  tile=geo["tile"])
        out[f"wkv6 {label}"] = tt
        print(f"wkv6 x{len(ins)} ({label}, B={b}, T={t}, H={H}, K=V={hs}, "
              f"{act_dtype} r/k/v; {geo['variant']}, {geo['blocks']} "
              f"blocks of {geo['tile']} columns): kernel {tt['ms']:.4f} ms "
              f"device (events {tt['event_ms']:.4f}), plain "
              f"{tt['plain_ms']:.4f} ms (chunked {tt['chunked_plain_ms']:.4f}"
              f" ms), bound {tt['bound_ms']:.5f} ms ({tt['bound_by']}, "
              f"{tt['mbytes']:.2f} MB), {tt['bound_share']:.3f} of the bound;"
              f" no single PyTorch call computes the recurrence")
    return out


# the hardware oracle's layers (phase 14): VGG-16's 13 convs at 224 px, and
# MobileNet v1's first stride-2 depthwise layer and a 14x14 1x1 layer
ORACLE_MOBILENET = ("DW2", "PW7")
# one medium layer run on both the card and the CPU (<= 1e8 thread products):
# 56 x 56 (padded to 58), 64 -> 32 channels, 11 groups of which the last
# holds 4 channels, 10 bands
ORACLE_CPU_LAYER = (58, 58, 64, 32)


def _grid_run(grid, spec, x, w):
    """One layer through the grid → (y, GridStats, grid ms by the host
    clock around a synchronised call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if spec.kind == "dwconv":
        y, stats = grid.conv2d_depthwise(x, w, stride=spec.stride)
    elif spec.kind == "pwconv":
        y, stats = grid.conv2d_1x1(x, w)
    else:
        y, stats = grid.conv2d(x, w, stride=spec.stride)
    torch.cuda.synchronize()
    return y, stats, (time.perf_counter() - t0) * 1e3


def _oracle_inputs(spec, rng):
    """|normal| (post-ReLU) activations padded by the layer's pad, normal
    weights: numpy float32."""
    x = np.abs(rng.normal(size=(spec.H, spec.W, spec.C))).astype(np.float32)
    p = spec.pad
    x = np.pad(x, ((p, p), (p, p), (0, 0)))
    if spec.kind == "dwconv":
        w = rng.normal(size=(3, 3, spec.C))
    elif spec.kind == "pwconv":
        w = rng.normal(size=(spec.C, spec.P))
    else:
        w = rng.normal(size=(spec.K, spec.K, spec.C, spec.P))
    return x, w.astype(np.float32)


def phase_oracle(dev) -> dict:
    """14: the hardware oracle at the paper's layer sizes, B1 against it, the
    dataflow model against its cycle counts, and the oracle on the card
    against the oracle on the CPU."""
    from repro_torch.core import accelerator
    from repro_torch.core.dataflow import LayerSpec, analyze_layer
    from repro_torch.core.logquant import LogQuantConfig, quantize_tensor
    from repro_torch.core.pe_grid import PEGrid
    from repro_torch.kernels import ops
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    cfg = LogQuantConfig(per_channel=False)
    grid = PEGrid(mode="log", quant_cfg=cfg, out_frac_bits=16)
    if grid.device.type != "cuda":
        fail(f"the grid runs on {grid.device}, not the card")
    mobilenet = {s.name: s for s in accelerator.mobilenet_v1_layers()}
    specs = accelerator.vgg16_layers() + [mobilenet[n]
                                          for n in ORACLE_MOBILENET]
    rows = []
    log_conv2d_fused.launches = 0   # the oracle path: one B1 launch a layer
    for i, spec in enumerate(specs):
        x, w = _oracle_inputs(spec, np.random.default_rng(SEED + 100 + i))
        y, stats, grid_ms = _grid_run(grid, spec, x, w)
        _, _, _, xscale, xd = grid._codes(x)
        wscale = grid._codes(w)[3]
        if spec.kind == "dwconv":
            w4, groups, taps = w[:, :, None, :], spec.C, 9
        elif spec.kind == "pwconv":
            w4, groups, taps = w[None, None], 1, spec.C
        else:
            w4, groups, taps = w, 1, 9 * spec.C
        qt = quantize_tensor(torch.as_tensor(w4, device=dev), cfg)
        before = log_conv2d_fused.launches
        y_b1 = ops.conv2d(xd[None], qt, stride=spec.stride, padding="VALID",
                          groups=groups, impl="cuda")[0]
        torch.cuda.synchronize()
        if log_conv2d_fused.launches - before != 1:
            fail(f"oracle {spec.name}: B1 launched "
                 f"{log_conv2d_fused.launches - before} times, expected 1")
        if y_b1.shape != y.shape or not bool(torch.isfinite(y).all()):
            fail(f"oracle {spec.name}: grid {tuple(y.shape)}, B1 "
                 f"{tuple(y_b1.shape)}, or a non-finite grid output")
        err = float((y_b1 - y).abs().max())
        tol = 5e-3 * (float(y.abs().max()) + 1)   # tests/test_conv2d.py:235
        lut_bound = 1.5 * taps * 2.0 ** -16 * xscale * wscale
        model = analyze_layer(spec)
        ratio = model.cycles / stats.cycles
        row = {"layer": spec.name, "kind": spec.kind, "in": [spec.H, spec.W,
               spec.C], "out_channels": spec.P, "stride": spec.stride,
               "grid_ms": grid_ms, "thread_products":
               stats.active_thread_cycles, "useful_macs": stats.useful_macs,
               "grid_cycles": stats.cycles, "model_cycles": model.cycles,
               "model_over_grid": ratio,
               "modelled_fpga_ms": model.latency_ms, "b1_err": err,
               "tol": tol, "lut_bound": lut_bound,
               "err_over_lut_bound": err / lut_bound,
               "max_abs_y": float(y.abs().max())}
        rows.append(row)
        print(f"oracle {spec.name:8s} {spec.kind:6s} {spec.H}x{spec.W}x"
              f"{spec.C}->{spec.P} s{spec.stride}: grid {grid_ms:.1f} ms on "
              f"the card, {stats.active_thread_cycles:,} thread products, "
              f"cycles grid {stats.cycles:,} model {model.cycles:,} (ratio "
              f"{ratio:.4f}), modelled FPGA (Zynq-7020, 200 MHz) "
              f"{model.latency_ms:.3f} ms; |B1 - grid| {err:.3e} (tol "
              f"{tol:.3e}, {err / lut_bound:.4f} of the LUT bound "
              f"{lut_bound:.3e})")
        if err > tol:
            fail(f"oracle {spec.name}: |B1 - grid| {err:.3e} > tol {tol:.3e}")
        if spec.kind == "conv" and not 0.6 * stats.cycles <= model.cycles \
                <= stats.cycles:   # tests/test_pe_grid.py:107-108
            fail(f"oracle {spec.name}: model cycles {model.cycles} outside "
                 f"[0.6, 1] x grid cycles {stats.cycles}")
    launches = log_conv2d_fused.launches
    if launches != len(specs):
        fail(f"oracle: B1 launched {launches} times for {len(specs)} layers")

    # the same grid on the CPU, at a medium layer
    H, W, C, P = ORACLE_CPU_LAYER
    spec = LayerSpec("MEDIUM", "conv", H, W, C, P, K=3, pad=0)
    x, w = _oracle_inputs(spec, np.random.default_rng(SEED + 200))
    cpu_grid = PEGrid(mode="log", quant_cfg=cfg, out_frac_bits=16,
                      device="cpu")
    codes = [[g._codes(t)[0].cpu() for t in (x, w)]
             for g in (grid, cpu_grid)]
    code_diff = [int((a != b).sum()) for a, b in zip(*codes)]
    y_card, s_card, card_ms = _grid_run(grid, spec, x, w)
    t0 = time.perf_counter()
    y_cpu, s_cpu = cpu_grid.conv2d(x, w)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = float((y_card.cpu() - y_cpu).abs().max())
    tol = 1e-6 * (float(y_cpu.abs().max()) + 1)
    # one band's integer psums (every position and channel, filter 0) from
    # the same codes through cycle_psums_batch on both devices
    xc, _, _, _, _ = cpu_grid._codes(x)
    wc, ws, _, _, _ = cpu_grid._codes(w)
    band = slice(6, 12)
    win = torch.as_tensor(x[band]).unfold(1, 3, 1).permute(1, 2, 0, 3)
    cwin = xc[band].unfold(1, 3, 1).permute(1, 2, 0, 3)
    wt = torch.as_tensor(w[..., 0]).permute(2, 0, 1)
    psums = [g.matrix.cycle_psums_batch(
        win.to(g.device), wt.to(g.device), window_codes=cwin.to(g.device),
        w_codes=wc[..., 0].permute(2, 0, 1).to(g.device),
        w_signs=ws[..., 0].permute(2, 0, 1).to(g.device)).cpu()
        for g in (grid, cpu_grid)]
    same_psums = torch.equal(*psums)
    medium = {"layer": list(ORACLE_CPU_LAYER),
              "thread_products": s_cpu.active_thread_cycles,
              "card_ms": card_ms, "cpu_ms": cpu_ms, "y_err": err, "tol": tol,
              "stats_equal": s_card == s_cpu, "code_differences": code_diff,
              "band_psums": list(psums[1].shape),
              "band_psums_identical": same_psums}
    print(f"oracle card vs CPU at {H}x{W}x{C}->{P} "
          f"({s_cpu.active_thread_cycles:,} thread products): card "
          f"{card_ms:.1f} ms, CPU {cpu_ms:.1f} ms; GridStats equal "
          f"{s_card == s_cpu}; |y_card - y_cpu| {err:.3e} (tol {tol:.3e}); "
          f"codes that differ (x, w) {code_diff}; cycle_psums_batch of one "
          f"band {list(psums[1].shape)} identical {same_psums}")
    if s_card != s_cpu or err > tol or not same_psums:
        fail(f"oracle card vs CPU: {medium}")
    return {"layers": rows, "launches": launches, "card_vs_cpu": medium,
            "grid_ms": sum(r["grid_ms"] for r in rows)}


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    return tree.detach().to(dev) if isinstance(tree, torch.Tensor) else tree


def _served_on_card(ex, name, params, apply_fn, batch, acc) -> dict:
    """One trained example model: it must have learned (logits that differ
    between images and across classes, train accuracy above chance by
    1/16), then its packed serving through B1 must stay within the
    example's drift limit with 26 launches."""
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    with torch.no_grad():
        logits = apply_fn(params, batch["images"])
    spread_img = float((logits - logits[:1]).abs().max())
    spread_cls = float((logits - logits[:, :1]).abs().max())
    floor = 1.0 / ex.N_CLASSES + 1.0 / 16
    if not (spread_img > 0 and spread_cls > 0 and acc > floor):
        fail(f"example ({name}): the trained net learned nothing: train acc "
             f"{acc} (must exceed {floor}), logit spread over images "
             f"{spread_img}, over classes {spread_cls}")
    log_conv2d_fused.launches = 0   # the example's packed forward
    served = ex.serve_packed(params, apply_fn, batch)
    torch.cuda.synchronize()
    launches = log_conv2d_fused.launches
    if launches != CONVS_PER_NET["squeezenet"]:
        fail(f"example ({name}): B1 launched {launches} times in a packed "
             f"forward, expected {CONVS_PER_NET['squeezenet']}")
    if not abs(served["acc"] - acc) < 0.2:
        fail(f"example ({name}): packed serving acc {served['acc']} against "
             f"train acc {acc}")
    return {**served, "launches": launches}


def phase_example(dev) -> dict:
    """15: the end-to-end example on the card: QAT, packed serving through
    B1, the dataflow walk; and a second, CPU-trained model served through
    B1 on the card."""
    from repro_torch.examples import cnn_accelerator_sim as ex
    t0 = time.perf_counter()
    loss, acc, params, apply_fn, batch = ex.train_quantized_cnn()
    if params["stem"]["w"].device.type != "cuda" or \
            not np.isfinite(loss):
        fail(f"example: trained on {params['stem']['w'].device}, loss {loss}")
    train_s = time.perf_counter() - t0
    served = _served_on_card(ex, "card-trained", params, apply_fn, batch,
                             acc)
    perf = ex.dataflow_walk()
    out = {"train_loss": loss, "train_acc": acc, "train_s": train_s,
           "serve_acc": served["acc"], "drift": served["drift"],
           "drift_limit": served["limit"], "launches": served["launches"],
           "wall_s": time.perf_counter() - t0,
           "modelled_fpga_ms": {n: p.latency_ms for n, p in perf.items()}}
    print(f"example: 250 QAT steps in {train_s:.1f} s, train loss {loss:.4f}"
          f" acc {acc:.4f}; packed serving acc {served['acc']:.4f}, drift "
          f"{served['drift']:.3e} (limit {served['limit']:.3e}), "
          f"{served['launches']} B1 launches; wall {out['wall_s']:.1f} s")
    t1 = time.perf_counter()
    loss_c, acc_c, params_c, _, batch_c = ex.train_quantized_cnn(
        device="cpu")
    cpu_s = time.perf_counter() - t1
    served_c = _served_on_card(ex, "CPU-trained", _to_device(params_c, dev),
                               apply_fn, _to_device(batch_c, dev), acc_c)
    out["cpu_trained"] = {"train_loss": loss_c, "train_acc": acc_c,
                          "train_s": cpu_s, **served_c}
    print(f"example, CPU-trained model served on the card: train loss "
          f"{loss_c:.4f} acc {acc_c:.4f} ({cpu_s:.1f} s); packed serving acc "
          f"{served_c['acc']:.4f}, drift {served_c['drift']:.3e} (limit "
          f"{served_c['limit']:.3e}), {served_c['launches']} B1 launches")
    out["launches"] += served_c["launches"]
    return out


# ---------------------------------------------------------------------------
# 18: the kernel-dispatch profiler on the card; 19: the bench twins
# ---------------------------------------------------------------------------

PROFILED_REPS = 20   # steady calls of a loop under the kernel profiler


def _spy_ops(expected: dict, names) -> dict:
    """Stand-ins for the `ops` entries ``names`` that note, for each call,
    the key and the bytes the profiler must record for it, computed from
    the call's own tensors at the launch knobs the call resolves
    (`ops.conv_knobs`, `ops.attention_knobs`; ``expected[key]``: the bytes
    of each call with that key, in order), then run the op."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import attention_key, conv_key
    from repro_torch.kernels.flash_attention import attention_traffic_bytes
    from repro_torch.kernels.log_conv2d import conv_traffic_bytes, sm_count
    orig = {n: getattr(ops, n) for n in names}

    def note(key, nbytes):
        expected.setdefault(key, []).append(nbytes)

    def conv2d(x, qt, *, stride=1, padding="SAME", groups=1, **kw):
        B, H, W, C = x.shape
        K, Cout = qt.shape[0], qt.shape[-1]
        knobs = ops.conv_knobs(x, qt, stride=stride, padding=padding,
                               groups=groups, config=kw.get("config"))
        note(conv_key(B, H, W, C, K, Cout, stride=stride, padding=padding,
                      groups=groups, cfg=qt.cfg),
             conv_traffic_bytes("cuda", B, H, W, C, K, Cout, stride=stride,
                                padding=padding, groups=groups,
                                bits=qt.cfg.bits,
                                n_sm=sm_count(x.device.index),
                                config=knobs))
        return orig["conv2d"](x, qt, stride=stride, padding=padding,
                              groups=groups, **kw)

    def log_matmul(x, qt, **kw):
        K, N = x.shape[-1], qt.packed.shape[-1]
        M, it = x.numel() // K, x.element_size()
        note(f"log_matmul|cuda|m{M}|k{K}|n{N}",
             {"act": M * K * it, "w": K * N, "out": M * N * it,
              "total": M * K * it + K * N + M * N * it})
        return orig["log_matmul"](x, qt, **kw)

    def attention(q, k, v, *, causal=True, window=None, **kw):
        B, Tq, H, D = q.shape
        Tk, Hkv = k.shape[1], k.shape[2]
        knobs = ops.attention_knobs(q, k, v, causal=causal, window=window,
                                    config=kw.get("config"))
        note(attention_key(B, Tq, Tk, H, Hkv, D, causal=causal,
                           window=window),
             attention_traffic_bytes("cuda", B, Tq, Tk, H, Hkv, D,
                                     itemsize=q.element_size(),
                                     kv_itemsize=k.element_size(),
                                     config=knobs))
        return orig["attention"](q, k, v, causal=causal, window=window, **kw)

    def wkv6(r, k, v, logw, u, state=None, **kw):
        B, T, H, K = r.shape
        V, it = v.shape[-1], r.element_size()
        rkw, vb, st = 3 * B * T * H * K * it, 2 * B * T * H * V * it, \
            2 * B * H * K * V * 4
        chunk = kw.get("chunk") or (kw.get("config") or ops.WkvConfig()).chunk
        note(f"wkv6|cuda|b{B}|t{T}|h{H}|k{K}|v{V}|c{chunk}",
             {"rkw": rkw, "v": vb, "state": st, "u": H * K * it,
              "total": rkw + vb + st + H * K * it})
        return orig["wkv6"](r, k, v, logw, u, state, **kw)

    spies = {"conv2d": conv2d, "log_matmul": log_matmul,
             "attention": attention, "wkv6": wkv6}
    return {n: spies[n] for n in names}


def _check_records(recs: list, expected: dict, launches: dict,
                   what: str, steady: bool = True) -> dict:
    """Hold the profiler's records of a run against the wrappers' launch
    counts (summed calls per op) and against the keys and bytes noted by
    `_spy_ops`: impl ``cuda``, a key of backend ``cuda`` that the spies
    saw, the bytes of its first call, and with ``steady`` a steady time of
    its own.  Keys whose calls moved different bytes (the key names no
    dtype) are counted and printed."""
    calls = {op: sum(r["calls"] for r in recs if r["op"] == op)
             for op in launches}
    if calls != launches or not all(launches.values()):
        fail(f"{what}: profiler calls {calls} != kernel launches {launches}")
    for r in recs:
        if r["impl"] != "cuda" or r["key"].split("|")[1] != "cuda":
            fail(f"{what}: record {r['op']} {r['key']} impl {r['impl']}")
        if r["key"] not in expected or r["bytes"] != expected[r["key"]][0]:
            fail(f"{what}: record {r['key']} bytes {r['bytes']} != the "
                 f"model's {expected.get(r['key'])}")
        if steady and (r["steady_source"] != "self"
                       or not r["steady_us"] > 0):
            fail(f"{what}: record {r['key']} has no steady time of its own "
                 f"({r['steady_source']}, {r['steady_us']})")
    mixed = [k for k, v in expected.items()
             if any(b != v[0] for b in v)]
    print(f"{what}: {len(recs)} records, profiler calls {calls} = kernel "
          f"launches; bytes equal the models"
          + (f"; keys with calls of different bytes: {mixed}" if mixed
             else ""))
    return {"records": len(recs), "calls": calls, "mixed_keys": mixed}


def phase_profiler_lm(dev, engine) -> dict:
    """18(c): gemma-2b's engine serving the 8 requests at the serve
    defaults with the profiler on: the prefill and decode programs, the
    records held by `_check_records`; then the decode-step ms with the
    profiler off and on (alternating, min of two)."""
    import copy
    from repro_torch.launch import serve
    from repro_torch.obs import kernel_profile as kprof
    from repro_torch.serving.engine import ServeEngine
    args = _serve_args(LM_ARCH)
    cfg, wrappers, expected = engine.cfg, _wrappers(), {}
    eng = ServeEngine(cfg, engine.params, engine.ecfg)
    kprof.clear()
    kprof.set_enabled(True)
    try:
        for w in wrappers.values():
            w.launches = 0
        with _patched(**_spy_ops(expected, ("log_matmul", "attention"))):
            for r in serve.make_requests(args, cfg.vocab):
                eng.submit(r)
            eng.run()
        torch.cuda.synchronize()
        snap = eng.metrics_snapshot()["kernels"]
    finally:
        kprof.set_enabled(None)
        kprof.clear()
    launches = {op: wrappers[op].launches for op in ("log_matmul",
                                                     "attention")}
    progs = snap["programs"]
    if not all(progs.get(p, {}).get("steady_us") for p in ("prefill",
                                                          "decode")):
        fail(f"{LM_ARCH}: the profiler's programs lack prefill or decode "
             f"steady times: {progs}")
    res = {"programs": progs,
           **_check_records(snap["records"], expected, launches,
                            f"{LM_ARCH} serve run under the profiler")}
    res["rows"] = [record_row(r) for r in snap["records"]]
    print(f"  programs: " + ", ".join(
        f"{n} {p['calls']} calls, first {p['first_us']:.0f} µs, steady "
        f"{p['steady_us']:.0f} µs" for n, p in progs.items()))

    # the decode step with the profiler off and on, on one engine
    a = copy.copy(args)
    a.requests, a.max_new = args.max_batch, 40
    eng = ServeEngine(cfg, engine.params, engine.ecfg)
    for r in serve.make_requests(a, cfg.vocab):
        eng.submit(r)
    eng.step()
    eng.step()
    step = {"off": [], "on": []}
    try:
        for _ in range(2):
            for mode in step:
                kprof.set_enabled(mode == "on")
                step[mode].append(1e3 * _host_time(eng.step, 5))
    finally:
        kprof.set_enabled(None)
        kprof.clear()
    res["decode_step_ms"] = {m: min(v) for m, v in step.items()}
    res["decode_step_ms_trials"] = step
    ms = res["decode_step_ms"]
    print(f"  {LM_ARCH} decode step ({args.max_batch} busy slots, host "
          f"clock, min of two): profiler off {ms['off']:.3f} ms, on "
          f"{ms['on']:.3f} ms")
    return res


def phase_profiler(dev, lm_prof: dict) -> dict:
    """18: the kernel-dispatch profiler on the card.  (a) one batch-8
    forward of each net with the profiler on: the B1 records' calls equal
    the kernel's launches, impl and backend ``cuda``, bytes equal
    `conv_traffic_bytes("cuda")`; (b) every conv shape of the zoo in a
    host-paced loop, its record against a `torch.profiler` device time of
    the same call taken right before the loop (`_profiled_loops`, in a
    process of its own, ``chip_smoke.py --profiled-loops``, whose profiler
    windows start fresh: phase 6's reading, minutes earlier, once put
    CONV1_1 at 1.601x); (d) `ops.wkv6` at
    rwkv6-1.6b's decode shape; (e) the top ten records by total time of
    (a), (c) (`phase_profiler_lm`) and (d)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    from repro_torch.kernels.wkv6 import wkv6_cuda
    from repro_torch.models.cnn import CNNS, make_cnn
    from repro_torch.obs import kernel_profile as kprof
    from repro_torch.serving.quantize import quantize_cnn_params

    def profiled(fn, spies=()):
        """fn() with the profiler on (and the spies in place) → records."""
        kprof.clear()
        kprof.set_enabled(True)
        try:
            with _patched(**dict(spies)):
                fn()
            torch.cuda.synchronize()
            return kprof.snapshot()["records"]
        finally:
            kprof.set_enabled(None)
            kprof.clear()

    res, rows = {"nets": {}}, list(lm_prof["rows"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((BATCH, IMG, IMG, 3), generator=gen, device=dev)
    for name in CNNS:                                     # (a)
        params, _ = make_cnn(name, SEED, n_classes=N_CLASSES, device=dev)
        net = quantize_cnn_params(params, conv_layout="lane_packed")
        expected = {}
        before = log_conv2d_fused.launches
        with torch.no_grad():
            recs = profiled(lambda: CNNS[name][1](
                net, x, quant="logq6", conv_impl="auto"),
                _spy_ops(expected, ("conv2d",)))
        launched = log_conv2d_fused.launches - before
        if launched != CONVS_PER_NET[name]:
            fail(f"{name}: {launched} conv launches under the profiler, "
                 f"expected {CONVS_PER_NET[name]}")
        res["nets"][name] = _check_records(
            recs, expected, {"conv2d": launched},
            f"{name} forward under the profiler", steady=False)
        rows += [record_row(r) for r in recs]
        del params, net
        torch.cuda.empty_cache()

    # (b), in a process of its own (late in this one the torch.profiler
    # windows lose every kernel event)
    res["loops"] = _subprocess("--profiled-loops")
    RETAKEN.extend(res["loops"].pop("profiler_windows_retaken"))

    # (d): wkv6 at rwkv6-1.6b's decode shape
    B, T, H, K = 4, 1, 32, 64
    r_, k_, v_ = (torch.randn((B, T, H, K), generator=gen, device=dev)
                  for _ in range(3))
    logw = -torch.exp(torch.randn((B, T, H, K), generator=gen, device=dev))
    u = torch.randn((H, K), generator=gen, device=dev)
    state = torch.randn((B, H, K, K), generator=gen, device=dev)
    expected, before = {}, wkv6_cuda.launches
    recs = profiled(lambda: [ops.wkv6(r_, k_, v_, logw, u, state)
                             for _ in range(PROFILED_REPS)],
                    _spy_ops(expected, ("wkv6",)))
    res["wkv6"] = _check_records(
        recs, expected, {"wkv6": wkv6_cuda.launches - before},
        f"wkv6 B={B} T={T} H={H} K=V={K} under the profiler")
    rows += [record_row(r) for r in recs]
    print_records(rows, "phase 18 (four nets, gemma-2b's serve run, wkv6)")
    res["top"] = sorted(rows, key=lambda r: -r["total_us"])[:10]
    res["profiler_calls"] = {
        "log_conv2d_fused": sum(n["calls"]["conv2d"]
                                for n in res["nets"].values()),
        "log_matmul_cuda": lm_prof["calls"]["log_matmul"],
        "flash_attention_cuda": lm_prof["calls"]["attention"],
        "wkv6_cuda": res["wkv6"]["calls"]["wkv6"]}
    return res


def _profiled_loops(dev) -> dict:
    """18(b): every conv shape of the zoo in a back-to-back loop of
    ``PROFILED_REPS`` calls after a first one, paced by the host as a
    caller's loop is: a record's steady µs against the device time of the
    same call, taken right before the loop (`_device_ms`: the sum of the
    call's kernels in a `torch.profiler` window over ``PROFILED_REPS``
    calls, retaken under the five-window rule), held within [0.9, 1.25] x
    + 10 µs for VGG-16's 13 shapes and printed for the others, whose
    kernels may take less time than the host's launch, so that the events
    hold host time as well.  A conv record's span starts where the wrapper
    launches (``marks_launch``), after its checks and allocations."""
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import trace_conv_shapes, zoo_conv_shapes
    from repro_torch.obs import kernel_profile as kprof
    vgg = {sig(r) for r in trace_conv_shapes("vgg16", batch=BATCH, img=IMG,
                                             n_classes=N_CLASSES)}
    rng = np.random.default_rng(SEED + 7)
    loops, bad = {}, []
    with torch.no_grad():
        for r in zoo_conv_shapes(batch=BATCH, img=IMG, n_classes=N_CLASSES):
            xs, qt, *_ = make_conv(r, rng, dev)
            kw = {k: r[k] for k in ("stride", "padding", "groups")}

            def call():
                return ops.conv2d(xs, qt, impl="cuda", **kw)

            def loop():
                # outputs are dropped, so the allocator reuses one block:
                # kept ones would make each call allocate within its events
                for _ in range(PROFILED_REPS + 1):
                    call()
            dev_ms, _ = _device_ms(call, f"18(b) device time {sig(r)}",
                                   reps=PROFILED_REPS)
            dev_us = dev_ms * 1e3
            kprof.clear()
            kprof.set_enabled(True)
            try:
                loop()
                torch.cuda.synchronize()
                (rec,) = kprof.snapshot()["records"]
            finally:
                kprof.set_enabled(None)
                kprof.clear()
            held = sig(r) in vgg
            ok = 0.9 * dev_us <= rec["steady_us"] <= 1.25 * dev_us + 10
            loops["/".join(sig(r))] = {
                "steady_us": rec["steady_us"], "device_us": dev_us,
                "ratio": rec["steady_us"] / dev_us, "calls": rec["calls"],
                "held": held, "within": ok}
            print(f"profiled loop {'/'.join(sig(r))}"
                  f"{' (VGG-16, held)' if held else ''}: steady "
                  f"{rec['steady_us']:.2f} µs, device {dev_us:.2f} µs a "
                  f"call, ratio {rec['steady_us'] / dev_us:.3f}"
                  f"{'' if ok else ' OUTSIDE [0.9, 1.25] x + 10 µs'}")
            if held and not ok:
                bad.append(sig(r))
            del xs, qt
    if bad or sum(v["held"] for v in loops.values()) != len(vgg):
        fail(f"VGG-16 conv records outside [0.9, 1.25] x device time + "
             f"10 µs (or missing): {bad}")
    return loops


def profiled_loops_check() -> int:
    """``chip_smoke.py --profiled-loops``: phase 18(b) in a fresh process;
    prints ``{"loops": {...}}`` last."""
    loops = _profiled_loops(torch.device("cuda", 0))
    loops["profiler_windows_retaken"] = RETAKEN
    print(json.dumps({"loops": loops}, default=str))
    return 0


BENCH_FILES = {"conv_kernels": "BENCH_torch_conv.json",
               "attention_kernels": "BENCH_torch_attention.json",
               "telemetry_overhead": "BENCH_torch_telemetry.json"}


def phase_benches() -> dict:
    """19: the bench twins on the card, through their CLI
    (`python -m repro_torch.benchmarks.run --device cuda`) in a process of
    their own, whose profiler windows start fresh (late in this process
    they lost kernel events); their JSON under chiprun_out/.  The conv and
    attention twins' correctness and analytic gates must hold; the
    telemetry overhead (host clock) is printed, not held."""
    import os
    out = ROOT / "chiprun_out"
    for name in BENCH_FILES.values():
        (out / name).unlink(missing_ok=True)
    sys.stdout.flush()
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--device",
         "cuda", "--out", str(out)], cwd=ROOT, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    print(f"bench twins: {time.perf_counter() - t0:.1f} s, exit code "
          f"{run.returncode} (1 where a twin's own gate failed)")
    if run.returncode not in (0, 1) or not all(
            (out / n).exists() for n in BENCH_FILES.values()):
        fail("the bench twins did not run to their end")
    res = {name: json.loads((out / f).read_text())
           for name, f in BENCH_FILES.items()}
    for name in ("conv_kernels", "attention_kernels"):
        if not res[name]["ok"]:
            fail(f"the {name} twin's correctness or traffic gate failed")
    tel = res["telemetry_overhead"]
    print(f"telemetry overhead (host clock, not held here): "
          f"{tel['overhead_pct']:+.2f} % (the bench's own limit "
          f"{tel['threshold_pct']} %); profiler on: "
          f"{tel['profiled_overhead_pct']} %")
    return res


# ---------------------------------------------------------------------------
# 20: LM training on the card; 21: the example twins
# ---------------------------------------------------------------------------

# phase 20(a): one train step each, card against CPU, fp32 activations
TRAIN_ARCHS = ("gemma-2b", "rwkv6-1.6b", "recurrentgemma-2b",
               "granite-moe-1b-a400m", "musicgen-large")
TRAIN_REL = 1e-4   # loss and grad norm: relative; leaves: x (max|p| + 1)


def _train_batch(cfg, b: int = 4, t: int = 16) -> dict:
    """The loader's batch for ``cfg`` (numpy, seed 0); an embedding-input
    arch gets embeddings from a numpy seed in place of the tokens."""
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    batch = ShardedLoader(DataConfig(seq_len=t, global_batch=b,
                                     vocab=cfg.vocab)).batch(0)
    if not cfg.embed_inputs:
        batch["embeds"] = np.random.default_rng(0).normal(
            size=(b, t, cfg.d_model)).astype(np.float32)
        del batch["tokens"]
    return batch


def _one_step(cfg, params, batch):
    """One step of the port's trainer (SGD with momentum: its update is
    linear in the gradient, so two correct gradients give close leaves,
    where AdamW's first step, about lr·sign(g), moves by 2·lr wherever the
    sign of a near-zero element differs) → (params, metrics)."""
    from repro_torch.models import transformer
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)
    tcfg = TrainConfig(opt=OptimizerConfig(name="sgd", lr=1e-2,
                                           warmup_steps=0,
                                           schedule="constant"))
    step = make_train_step(
        lambda p, b: transformer.lm_loss(p, b, cfg, xent_chunk=8), tcfg)
    state, metrics = step(init_train_state(params, tcfg), batch)
    return state["params"], {k: float(v) for k, v in metrics.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaves(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def _train_card_vs_cpu(dev) -> dict:
    """20(a): each arch of `TRAIN_ARCHS`, reduced, one step on the CPU and
    one on the card from the same initial params and batch."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  attn_impl="blockwise")
        # drawn on the CPU twice (the steps update params in place)
        p_cpu = transformer.init_params(cfg, SEED, device="cpu")
        p_card = _to_device(transformer.init_params(cfg, SEED, device="cpu"),
                            dev)
        batch = _train_batch(cfg)
        new_cpu, m_cpu = _one_step(cfg, p_cpu, batch)
        new_card, m_card = _one_step(cfg, p_card, batch)
        worst = 0.0
        for (name, a), (_, c) in zip(_leaves(new_cpu), _leaves(new_card)):
            a = a.detach()
            err = float((c.detach().cpu() - a).abs().max())
            tol = TRAIN_REL * (float(a.abs().max()) + 1)
            worst = max(worst, err / tol)
            if not err <= tol:
                fail(f"training {arch}: leaf {name} differs by {err} on the "
                     f"card (tolerance {tol})")
        for k in ("loss", "grad_norm"):
            if not abs(m_card[k] - m_cpu[k]) <= TRAIN_REL * abs(m_cpu[k]):
                fail(f"training {arch}: {k} {m_card[k]} on the card, "
                     f"{m_cpu[k]} on the CPU")
        out[arch] = {"loss_card": m_card["loss"], "loss_cpu": m_cpu["loss"],
                     "grad_norm_card": m_card["grad_norm"],
                     "grad_norm_cpu": m_cpu["grad_norm"],
                     "leaves": len(_leaves(new_cpu)),
                     "worst_err_over_tol": worst}
        print(f"train step {arch} (reduced, fp32): loss {m_card['loss']:.6f}"
              f" card / {m_cpu['loss']:.6f} CPU, grad norm "
              f"{m_card['grad_norm']:.6f} / {m_cpu['grad_norm']:.6f}; "
              f"{out[arch]['leaves']} leaves, worst err/tol {worst:.4f}")
    return out


def _grad_guard(dev) -> dict:
    """20(c): each kernel wrapper, called on the card with an input that
    requires grad, raises (and under no_grad runs)."""
    from repro_torch.core.logquant import quantize_tensor
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    from repro_torch.kernels.log_matmul import log_matmul_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda
    g = torch.Generator(device=dev).manual_seed(SEED)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    qm = quantize_tensor(rn(64, 32))
    qc = quantize_tensor(rn(3, 3, 4, 8))
    calls = {
        "log_matmul_cuda": (lambda x: log_matmul_cuda(x, qm.packed, qm.scale),
                            (4, 64)),
        "log_conv2d_fused": (lambda x: log_conv2d_fused(x, qc.packed,
                                                        qc.scale),
                             (1, 6, 6, 4)),
        "flash_attention_cuda": (lambda x: flash_attention_cuda(
            x, x[:, :, :1].contiguous(), x[:, :, :1].contiguous()),
            (1, 8, 2, 64)),
        "wkv6_cuda": (lambda x: wkv6_cuda(
            x, x, x, -torch.ones_like(x), torch.zeros(2, 16, device=dev)),
            (1, 3, 2, 16))}
    out = {}
    for name, (call, shape) in calls.items():
        x = rn(*shape).requires_grad_(True)
        try:
            call(x)
        except RuntimeError as e:
            if "has no backward" not in str(e):
                raise
            out[name] = str(e).split(":")[0]
        else:
            fail(f"{name} ran on an input that requires grad")
        with torch.no_grad():
            call(x)
    torch.cuda.synchronize()
    print(f"grad guard: {sorted(out)} raise on an input that requires grad "
          f"on the card, and run under no_grad")
    return out


RESUME_STEPS = 3   # 20(d): 2 x RESUME_STEPS straight against a resume


def resume_check(dev=None) -> int:
    """20(d), in a process of its own (``chip_smoke.py --resume-check``,
    with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts):
    gemma-2b at 2 layers of width 512 (vocab 8192, bf16 activations,
    AdamW), 2·RESUME_STEPS steps straight against RESUME_STEPS, a
    checkpoint, a restore and RESUME_STEPS more, first with the default
    algorithms (printed), then under `torch.use_deterministic_algorithms`
    (bit for bit, or it fails).  Prints one JSON line."""
    import os
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.models import transformer
    from repro_torch.runtime.checkpoint import (load_checkpoint,
                                                save_checkpoint)
    from repro_torch.training.optimizer import OptimizerConfig, tree_map
    from repro_torch.training.train_loop import TrainConfig, train
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != ":4096:8":
        fail("the resume check needs CUBLAS_WORKSPACE_CONFIG=:4096:8")
    dev = dev or torch.device("cuda", 0)
    cfg = dataclasses.replace(
        get_config("gemma-2b"), n_layers=2, d_model=512, d_ff=2048,
        n_heads=8, head_dim=64, vocab=8192, attn_impl="blockwise")
    tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=0,
                                           schedule="constant",
                                           total_steps=10), log_every=1)
    ld = ShardedLoader(DataConfig(seq_len=128, global_batch=8,
                                  vocab=cfg.vocab, seed=1))
    loss_fn = lambda p, b: transformer.lm_loss(p, b, cfg)  # noqa: E731
    fresh = lambda: transformer.init_params(cfg, SEED, device=dev)  # noqa

    def differing(deterministic: bool) -> tuple[list, list, list]:
        torch.use_deterministic_algorithms(deterministic)
        sA, hA = train(loss_fn, fresh(), ld, tcfg,
                       num_steps=2 * RESUME_STEPS)
        sB, _ = train(loss_fn, fresh(), ld, tcfg, num_steps=RESUME_STEPS)
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, RESUME_STEPS, sB)
            tpl = tree_map(lambda t: t.to("meta"), sB)
            sB2, step = load_checkpoint(d, tpl, device=dev)
        sB2, hB = train(loss_fn, None, ld, tcfg, num_steps=RESUME_STEPS,
                        start_step=step, state=sB2)
        bad = [name for (name, a), (_, b) in zip(_leaves(sA["params"]),
                                                 _leaves(sB2["params"]))
               if not torch.equal(a, b)]
        return bad, [h["loss"] for h in hA], [h["loss"] for h in hB]

    bad_default, _, _ = differing(False)
    bad_det, lossA, lossB = differing(True)
    print(json.dumps({"resume": {
        "params": cfg.param_count(), "steps": 2 * RESUME_STEPS,
        "leaves": len(_leaves(fresh())),
        "differing_leaves_default": bad_default,
        "differing_leaves_deterministic": bad_det,
        "loss_straight": lossA, "loss_resumed": lossB}}))
    return 0


def train_gemma_check() -> int:
    """20(b), in a process of its own (``chip_smoke.py --train-gemma``),
    whose `torch.profiler` window starts fresh: `launch/train.py` at
    gemma-2b, full width and depth, its defaults but ``--steps 8
    --log-every 1``; each step's time from its ``train_step`` trace span
    (the loop's step event makes it with the histogram's sample); the four
    wrappers' launches; then one more step of a fresh state under
    `torch.profiler` (after a warm-up step) for the breakdown.  Prints one
    JSON line."""
    import gc
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.obs import trace as obs_trace
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)
    wrappers = dict(_wrappers(), conv2d=log_conv2d_fused)
    args = train.parse_args(["--arch", LM_ARCH, "--steps", "8",
                             "--log-every", "1"])
    obs_trace.set_enabled(True)
    res = train.run(args)
    obs_trace.set_enabled(None)
    step_ms = [ev[3] / 1e6 for ev in obs_trace.events()
               if ev[1] == "train_step"]
    launches = {name: w.launches for name, w in wrappers.items()}
    gc.collect()
    torch.cuda.empty_cache()
    # the launcher's config and trainer, rebuilt for one profiled step
    cfg = dataclasses.replace(get_config(args.arch), attn_impl="blockwise")
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(opt=OptimizerConfig(lr=args.lr, warmup_steps=1,
                                           total_steps=args.steps),
                       xent_chunk=args.seq)
    state = init_train_state(
        transformer.init_params(cfg, args.seed, device=args.device), tcfg)
    step = make_train_step(
        lambda p, b: transformer.lm_loss(p, b, cfg, xent_chunk=args.seq),
        tcfg)
    batch = ShardedLoader(DataConfig(seq_len=args.seq,
                                     global_batch=args.batch,
                                     vocab=cfg.vocab)).batch(0)
    t0 = time.perf_counter()
    prof = profile_forward(lambda: step(state, batch))
    prof["two_steps_wall_ms"] = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"train_gemma": {
        "params": cfg.param_count(),
        "losses": [h["loss"] for h in res["history"]],
        "grad_norms": [h["grad_norm"] for h in res["history"]],
        "step_ms": step_ms,
        "histogram_p50_ms": res["step_s"]["p50"] * 1e3,
        "histogram_p99_ms": res["step_s"]["p99"] * 1e3,
        "peak_gb": res["peak_bytes"] / 1e9, "kernel_launches": launches,
        "profiled_step": prof}}))
    return 0


def _subprocess(flag: str, **env) -> dict:
    """``chip_smoke.py <flag>`` in a process of its own → the value of its
    last JSON line ``{key: value}``."""
    import os
    sys.stdout.flush()
    run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag], cwd=ROOT,
        timeout=600, capture_output=True, text=True,
        env=dict(os.environ, **env))
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
    # the child's report, less its result line (kept in the details)
    print(run.stdout.replace(lines[-1], "")[-12000:] if lines
          else run.stdout[-12000:], end="")
    if run.returncode != 0 or not lines:
        print(run.stderr[-4000:])
        fail(f"chip_smoke.py {flag} did not run to its end")
    return next(iter(json.loads(lines[-1]).values()))


def _gemma_training() -> dict:
    """20(b) through `train_gemma_check`: every loss finite, no kernel
    launched; the step times and the profiled step's breakdown printed."""
    res = _subprocess("--train-gemma")
    losses = res["losses"] + res["grad_norms"]
    if len(res["losses"]) != 8 or not all(np.isfinite(losses)):
        fail(f"gemma-2b training: losses {res['losses']}, grad norms "
             f"{res['grad_norms']}")
    steady = float(np.median(res["step_ms"][1:]))  # the first step warms up
    prof = res["profiled_step"]
    res.update(step_ms_median_after_first=steady,
               tokens_per_s=8 * 128 / (steady / 1e3),
               idle_share=1 - prof["device_busy_ms"] / steady)
    print(f"gemma-2b training ({res['params'] / 1e9:.3f} G params, batch 8 "
          f"x 128): step ms {[round(t, 3) for t in res['step_ms']]} "
          f"(train_step spans), median after the first {steady:.3f} ms, "
          f"{res['tokens_per_s']:.1f} tokens/s at it (histogram p50 bucket "
          f"{res['histogram_p50_ms']:.1f} ms); peak {res['peak_gb']:.2f} GB; "
          f"profiled step: {prof['device_kernels']} device kernels, busy "
          f"{prof['device_busy_ms']:.3f} ms (idle share against the median "
          f"step {res['idle_share']:.3f}), top {prof['top_kernels_ms']}")
    return res


def phase_training(dev) -> dict:
    """20: LM training on the card.  (a) one step card against CPU per arch
    (`_train_card_vs_cpu`); (b) gemma-2b at full width and depth through
    `launch/train.py` (`train_gemma_check`, in a process of its own); (c)
    no kernel launched in (a) and (b), and every wrapper refusing an input
    that requires grad; (d) a bit-exact resume under deterministic
    algorithms (`resume_check`, in a process of its own)."""
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    t0 = time.perf_counter()
    wrappers = dict(_wrappers(), conv2d=log_conv2d_fused)
    for w in wrappers.values():
        w.launches = 0
    out = {"card_vs_cpu": _train_card_vs_cpu(dev)}
    launches = {name: w.launches for name, w in wrappers.items()}
    out["card_vs_cpu_wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["gemma_2b"] = _gemma_training()
    out["gemma_2b"]["wall_s"] = time.perf_counter() - t1
    out["kernel_launches"] = {"card_vs_cpu": launches,
                              "gemma_2b": out["gemma_2b"]["kernel_launches"]}
    if any(v for d in out["kernel_launches"].values() for v in d.values()):
        fail(f"a kernel launched during training: {out['kernel_launches']}")
    out["grad_guard"] = _grad_guard(dev)
    t2 = time.perf_counter()
    res = _subprocess("--resume-check", CUBLAS_WORKSPACE_CONFIG=":4096:8")
    print(f"resume ({res['params'] / 1e6:.1f} M params, bf16, "
          f"{res['steps']} steps, {res['leaves']} leaves): differing leaves "
          f"{len(res['differing_leaves_default'])} with the default "
          f"algorithms ({res['differing_leaves_default'][:4]}), "
          f"{len(res['differing_leaves_deterministic'])} under "
          f"deterministic algorithms; last loss {res['loss_straight'][-1]:.6f}"
          f" straight, {res['loss_resumed'][-1]:.6f} resumed")
    if res["differing_leaves_deterministic"]:
        fail(f"resume under deterministic algorithms differs in "
             f"{res['differing_leaves_deterministic']}")
    out["resume"] = dict(res, wall_s=time.perf_counter() - t2)
    out["wall_s"] = time.perf_counter() - t0
    print(f"training phase: kernel launches {out['kernel_launches']}; wall "
          f"{out['wall_s']:.1f} s ((a) {out['card_vs_cpu_wall_s']:.1f} s, "
          f"(b) {out['gemma_2b']['wall_s']:.1f} s, (d) "
          f"{out['resume']['wall_s']:.1f} s)")
    return out


def phase_example_twins(dev) -> dict:
    """21: the three example twins on the card: `train_lm` at its defaults
    (300 steps of the ~100M logq6 model with compressed gradients, its
    assertion that the loss falls by more than 1.0), `serve_lm` with its
    spot check against naive decode, `quickstart`, whose step 5 must
    launch B2 once."""
    import shutil
    import tempfile
    from repro_torch.examples import quickstart, serve_lm, train_lm
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_matmul import log_matmul_cuda
    out = {}
    t0 = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="train_lm_")
    try:
        hist = train_lm.main(["--ckpt-dir", ckpt])
    except AssertionError as e:
        fail(f"train_lm: {e}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["train_lm"] = {"first_loss": hist[0]["loss"],
                       "final_loss": hist[-1]["loss"],
                       "wall_s": time.perf_counter() - t0}
    print(f"train_lm: loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f} "
          f"(lowest logged {min(h['loss'] for h in hist):.4f}) in "
          f"{hist[-1]['step'] + 1} steps, {out['train_lm']['wall_s']:.1f} s")
    t1 = time.perf_counter()
    flash_attention_cuda.launches = 0
    try:
        done = serve_lm.main([])
    except AssertionError:
        fail("serve_lm: the greedy request does not match naive decode")
    out["serve_lm"] = {"requests": len(done),
                       "attention_launches": flash_attention_cuda.launches,
                       "wall_s": time.perf_counter() - t1}
    if not flash_attention_cuda.launches:
        fail("serve_lm launched no attention kernel")
    log_matmul_cuda.launches = 0
    res = quickstart.main([])
    out["quickstart"] = {**res, "log_matmul_launches":
                         log_matmul_cuda.launches}
    if log_matmul_cuda.launches != 1:
        fail(f"quickstart's step 5 launched B2 {log_matmul_cuda.launches} "
             f"times, expected 1")
    if not res["grid_matches"]:
        fail("quickstart: the PE grid's conv differs from a plain conv")
    out["wall_s"] = time.perf_counter() - t0
    print(f"example twins: serve_lm {len(done)} requests with "
          f"{out['serve_lm']['attention_launches']} attention launches; "
          f"quickstart B2 launches 1; wall {out['wall_s']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# 22: the autotune tables
# ---------------------------------------------------------------------------


def _tickets_zero(dev, what: str) -> None:
    from repro_torch.kernels.log_conv2d import _TICKETS
    torch.cuda.synchronize()
    buf = _TICKETS.get(dev.index)
    if buf is not None and bool(buf.any()):
        fail(f"{what}: {int((buf != 0).sum())} split tickets left non-zero")


def _cold_start_on_card(dev, nets: dict, x) -> dict:
    """22(a): with an empty user tier, one batch-8 forward of each net and
    gemma-2b's serve run resolve every conv and attention dispatch from the
    packaged tier: no miss, no sweep, hit_warm = the lookups = the distinct
    keys dispatched (knobs are resolved once a shape and process).  The
    launch counts are zeroed just before and read just after."""
    from repro_torch.benchmarks.conv_kernels import autotune_counts
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    from repro_torch.launch import serve
    from repro_torch.models import cnn
    autotune.reset_cache()
    before = {op: autotune_counts(op) for op in ("conv2d", "attention")}
    wrappers = _wrappers()
    log_conv2d_fused.launches = 0
    for w in wrappers.values():
        w.launches = 0
    calls, by_net = [], {}
    with torch.no_grad():
        for name, net in nets.items():
            n0, b0 = len(calls), log_conv2d_fused.launches
            with cnn._capture_conv_shapes(calls):
                cnn.CNNS[name][1](net, x, quant="logq6", conv_impl="auto")
            torch.cuda.synchronize()
            by_net[name] = {"dispatches": len(calls) - n0,
                            "launches": log_conv2d_fused.launches - b0}
            if by_net[name]["launches"] != CONVS_PER_NET[name]:
                fail(f"22(a) {name}: {by_net[name]['launches']} conv "
                     f"launches, expected {CONVS_PER_NET[name]}")
    args = _serve_args(LM_ARCH)
    eng = serve.build_engine(args)
    attn_keys, at = set(), ops.attention

    def attention(q, k, v, *, causal=True, window=None, **kw):
        B, Tq, H, D = q.shape
        attn_keys.add(autotune.attention_key(
            B, Tq, k.shape[1], H, k.shape[2], D, causal=causal,
            window=window))
        return at(q, k, v, causal=causal, window=window, **kw)
    for w in wrappers.values():
        w.launches = 0
    with _patched(attention=attention):
        for r in serve.make_requests(args, eng.cfg.vocab):
            eng.submit(r)
        eng.run()
    torch.cuda.synchronize()
    launches = {op: w.launches for op, w in wrappers.items()}
    del eng
    torch.cuda.empty_cache()
    res = {"nets": by_net, "lm_launches": launches}
    for op, keys in (("conv2d", {_conv_key(c) for c in calls}),
                     ("attention", attn_keys)):
        now = autotune_counts(op)
        d = {k: now[k] - before[op][k] for k in now}
        d["lookups"] = d["hit_user"] + d["hit_warm"] + d["miss"]
        d["distinct_keys"] = len(keys)
        d["dispatches"] = (len(calls) if op == "conv2d"
                           else launches["attention"])
        res[op] = d
        if not (d["miss"] == 0 and d["sweeps"] == 0 and d["hit_user"] == 0
                and d["hit_warm"] == d["lookups"] == len(keys) > 0):
            fail(f"22(a) cold start, {op}: {d}")
    print(f"22(a) cold start (empty user tier): conv {res['conv2d']}, "
          f"attention {res['attention']}; B1 launches "
          f"{ {n: v['launches'] for n, v in by_net.items()} }, "
          f"{LM_ARCH} serve run launches {launches}")
    return res


def _packaged_checks(dev) -> dict:
    """22(b): every packaged conv config at batch 8, launched twice (same
    bits), against `log_conv2d_blockwise` within 1e-4·(max|y_ref|+1); every
    packaged attention config against `ref_attention` as phase 8 holds B3
    (tensor-core cases also within `mma_error_limit`)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_geometry,
                                                     mma_error_limit)
    from repro_torch.kernels.log_conv2d import (log_conv2d_blockwise,
                                                log_conv2d_fused)
    from repro_torch.kernels.ref import ref_attention
    from repro_torch.models.cnn import zoo_conv_shapes
    from repro_torch.tools import build_autotune_table as table_tool
    entries = autotune._load_packaged("cuda")
    rng = np.random.default_rng(SEED + 11)
    worst, n = 0.0, 0
    with torch.no_grad():
        for r in zoo_conv_shapes(batch=BATCH, img=IMG, n_classes=N_CLASSES):
            knobs = entries[_conv_key(r)]["config"]
            x, qt, hwio, codes, lane = make_conv(r, rng, dev)
            kw = {k: r[k] for k in ("stride", "padding", "groups")}
            y, again = (log_conv2d_fused(x, codes, qt.scale, lane=lane,
                                         config=knobs, **kw)
                        for _ in range(2))
            want = log_conv2d_blockwise(x, hwio, qt.scale, **kw)
            err, tol = _err_tol(y, want, 1e-4)
            if not torch.equal(y.view(torch.int32), again.view(torch.int32)) \
                    or not err <= tol:
                fail(f"22(b) {sig(r)} at {knobs}: err {err:.3e} (tol "
                     f"{tol:.3e}) or two calls gave different bits")
            worst, n = max(worst, err / tol), n + 1
            del x, qt, hwio, codes, y, again, want
        _tickets_zero(dev, "22(b) convs")
        gen = torch.Generator(device=dev).manual_seed(SEED + 12)
        a_worst, a_n, mma = 0.0, 0, 0
        for a in table_tool.attention_walk():
            B, Tq, Tk, H, Hkv, D, causal, window = a["shape"]
            cfg = entries[table_tool.attention_key_of(a)]["config"]
            qdt = getattr(torch, a["q_dtype"])
            kvdt = getattr(torch, a["kv_dtype"])
            q = torch.randn((B, Tq, H, D), generator=gen, device=dev).to(qdt)
            k, v = (torch.randn((B, Tk, Hkv, D), generator=gen,
                                device=dev).to(kvdt) for _ in range(2))
            kw = dict(causal=causal, window=window, q_offset=Tk - Tq)
            geo = flash_attention_geometry(B, Tq, Tk, H, Hkv, D, qdt, kvdt,
                                           **cfg)
            got, again = (flash_attention_cuda(q, k, v, **kw, config=cfg)
                          for _ in range(2))
            err, tol = _err_tol(got, ref_attention(q, k, v, **kw),
                                2e-4 if qdt == torch.float32 else 8e-3)
            if not torch.equal(got.view(torch.int16),
                               again.view(torch.int16)) or not err <= tol:
                fail(f"22(b) {a['source']} {a['shape']} at {cfg}: err "
                     f"{err:.3e} (tol {tol:.3e}) or different bits")
            if geo["variant"] == "mma":
                o, limit = mma_error_limit(q, k, v, **kw)
                if bool(((got.float() - o).abs() > limit).any()):
                    fail(f"22(b) {a['shape']}: outside mma_error_limit")
                mma += 1
            a_worst, a_n = max(a_worst, err / tol), a_n + 1
        _tickets_zero(dev, "22(b) attention")
    print(f"22(b) packaged configs: {n} conv configs at batch {BATCH} "
          f"bit-identical over two calls, worst err/tol {worst:.3e}; {a_n} "
          f"attention configs ({mma} on the tensor cores, within "
          f"mma_error_limit), worst err/tol {a_worst:.3e}; tickets at zero")
    return {"convs": n, "conv_worst_err_over_tol": worst, "attention": a_n,
            "attention_worst_err_over_tol": a_worst, "mma": mma}


def _measured_sweep(dev) -> dict:
    """22(c): `build_autotune_table`'s ``--measure`` sweep (`measured_conv_winner`,
    `measured_attention_winner`: each candidate held against the plain
    version, then timed) into the user tier, over ResNet-34's three 1x1
    stride-2 convs, MobileNet v1's 56² and 28² stride-1 depthwise convs and
    gemma-2b's decode attention; then, for each shape, device µs (the
    tuner's own timing, `autotune._device_us`) of the heuristic's knobs,
    the packaged ones, the measured winner and the library call (`F.conv2d`
    on decoded weights / SDPA with the kv head expanded)."""
    import torch.nn.functional as F
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_conv2d import (conv_nhwc, decode_codes,
                                                log_conv2d_fused,
                                                normalize_padding)
    from repro_torch.kernels.ref import attention_mask
    from repro_torch.models.cnn import zoo_conv_shapes
    from repro_torch.tools import build_autotune_table as table_tool
    zoo = zoo_conv_shapes(batch=BATCH, img=IMG, n_classes=N_CLASSES)
    shapes = ([r for r in zoo if "resnet34" in r["nets"] and r["K"] == 1
               and r["stride"] == 2]
              + [r for r in zoo if "mobilenet_v1" in r["nets"]
                 and r["groups"] == r["C"] > 1 and r["stride"] == 1
                 and r["H"] in (IMG // 4, IMG // 8)])      # 56², 28²
    if len(shapes) != 5:
        fail(f"22(c): expected 5 conv shapes, found {len(shapes)}")
    us = autotune._device_us
    rng, rows = np.random.default_rng(SEED + 13), []
    with torch.no_grad():
        for r in shapes:
            best, best_us = table_tool.measured_conv_winner(r, table_tool.REPS)
            x, qt, hwio, codes, lane = make_conv(r, rng, dev)
            kw = {k: r[k] for k in ("stride", "padding", "groups")}
            pads = normalize_padding(r["padding"], r["K"], r["stride"],
                                     r["H"], r["W"])
            w = decode_codes(hwio) * qt.scale.reshape(-1)

            def conv(knobs):
                return lambda: log_conv2d_fused(x, codes, qt.scale,
                                                lane=lane, config=knobs,
                                                **kw)
            packaged = packaged_conv_knobs(r)
            row = {"shape": "/".join(sig(r)), "winner": best,
                   "packaged": packaged, "winner_sweep_us": best_us,
                   "heuristic_us": us(conv(None), table_tool.REPS),
                   "packaged_us": us(conv(packaged), table_tool.REPS),
                   "winner_us": us(conv(best), table_tool.REPS),
                   "library_us": us(lambda: conv_nhwc(
                       x, w, stride=r["stride"], pads=pads,
                       groups=r["groups"]), table_tool.REPS)}
            rows.append(row)
            del x, qt, hwio, codes, w
        _tickets_zero(dev, "22(c) conv sweeps")
        a = next(a for a in table_tool.attention_walk()
                 if a["source"] == f"{LM_ARCH} decode")
        best, best_us = table_tool.measured_attention_winner(a, table_tool.REPS)
        B, Tq, Tk, H, Hkv, D, causal, window = a["shape"]
        gen = torch.Generator(device=dev).manual_seed(SEED + 14)
        q = torch.randn((B, Tq, H, D), generator=gen, device=dev).to(
            getattr(torch, a["q_dtype"]))
        k, v = (torch.randn((B, Tk, Hkv, D), generator=gen, device=dev).to(
            getattr(torch, a["kv_dtype"])) for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=Tk - 1)
        mask = attention_mask(Tq, Tk, causal=causal, window=window,
                              q_offset=Tk - 1, k_offset=0, device=dev)
        ql = q.float().transpose(1, 2)
        kl, vl = (t.transpose(1, 2).repeat_interleave(H // Hkv, 1)
                  for t in (k, v))
        packaged = autotune._load_packaged("cuda")[
            table_tool.attention_key_of(a)]["config"]

        def attn(knobs):
            return lambda: flash_attention_cuda(q, k, v, **kw, config=knobs)
        rows.append({
            "shape": f"attention {a['source']} {a['shape']}",
            "winner": best, "packaged": packaged, "winner_sweep_us": best_us,
            "heuristic_us": us(attn(None), table_tool.REPS),
            "packaged_us": us(attn(packaged), table_tool.REPS),
            "winner_us": us(attn(best), table_tool.REPS),
            "library_us": us(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask[:, None]), table_tool.REPS)})
        _tickets_zero(dev, "22(c) attention sweep")
    for row in rows:
        print(f"22(c) {row['shape']}: device µs heuristic "
              f"{row['heuristic_us']:.3f}, packaged {row['packaged']} "
              f"{row['packaged_us']:.3f}, measured winner {row['winner']} "
              f"{row['winner_us']:.3f} (its sweep {row['winner_sweep_us']}),"
              f" library {row['library_us']:.3f}")
    return {"rows": rows, "reps": table_tool.REPS,
            "time": "device time: CUDA events around calls queued behind a "
            "sleep kernel (autotune._device_us)"}


def _forwards_with_without(dev, nets: dict, x) -> dict:
    """22(d): each net's batch-8 forward with the packaged tier against the
    tier emptied (the heuristic's knobs), in this process, alternating
    twice; the lesser forward ms (CUDA events over 3) and the busy ms of a
    profiled forward of each.  Printed, not held."""
    import tempfile
    from repro_torch.kernels import autotune
    from repro_torch.models import cnn
    real = autotune.PACKAGED_DIR
    res = {name: {"packaged": [], "heuristic": []} for name in nets}
    busy = {name: {} for name in nets}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-empty-") as empty, \
            torch.no_grad():
        try:
            for _ in range(2):
                for mode, where in (("packaged", real), ("heuristic", empty)):
                    autotune.PACKAGED_DIR = where
                    autotune.reset_cache()
                    for name, net in nets.items():
                        def fwd(name=name, net=net):
                            return cnn.CNNS[name][1](net, x, quant="logq6",
                                                     conv_impl="auto")
                        res[name][mode].append(time_ms(fwd, 3))
                        if mode not in busy[name]:
                            p = profile_forward(fwd)
                            # no device events: the profiler saw nothing
                            busy[name][mode] = (p["device_busy_ms"]
                                                if p["device_kernels"]
                                                else None)
        finally:
            autotune.PACKAGED_DIR = real
            autotune.reset_cache()
    out = {}
    for name in nets:
        out[name] = {f"{m}_forward_ms": min(v) for m, v in res[name].items()}
        out[name].update({f"{m}_busy_ms": b for m, b in busy[name].items()},
                         trials=res[name])
        o = out[name]
        print(f"22(d) {name:12s}: forward ms packaged "
              f"{o['packaged_forward_ms']:.3f} / heuristic "
              f"{o['heuristic_forward_ms']:.3f} (min of two), busy ms "
              f"{o['packaged_busy_ms']} / {o['heuristic_busy_ms']} (None: "
              f"the profiler saw no kernel)")
    return out


def autotune_check() -> int:
    """``chip_smoke.py --autotune``: phase 22 in a fresh process (its
    forwards are profiled, and late in a long process the `torch.profiler`
    windows lose every event); prints ``{"autotune": {...}}`` last."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = phase_autotune(torch.device("cuda", 0))
    print(json.dumps({"autotune": res}, default=str))
    return 0


def phase_autotune(dev) -> dict:
    """22: the autotune tables on the card, into an empty user tier of its
    own: (a) the cold-start gate, (b) the packaged configs checked, (c) a
    measured sweep, (d) forwards with and without the packaged tier."""
    import os
    import tempfile
    from repro_torch.kernels import autotune
    from repro_torch.models.cnn import CNNS, make_cnn
    from repro_torch.serving.quantize import quantize_cnn_params
    prev = os.environ.get(autotune.ENV_PATH)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tier-") as tmp:
        os.environ[autotune.ENV_PATH] = os.path.join(tmp, "user.json")
        autotune.reset_cache()
        try:
            gen = torch.Generator(device=dev).manual_seed(SEED + 1)
            x = torch.randn((BATCH, IMG, IMG, 3), generator=gen, device=dev)
            nets = {name: quantize_cnn_params(make_cnn(
                name, SEED, n_classes=N_CLASSES, device=dev)[0],
                conv_layout="lane_packed") for name in CNNS}
            res = {"cold_start": _cold_start_on_card(dev, nets, x),
                   "packaged": _packaged_checks(dev),
                   "sweep": _measured_sweep(dev),
                   "forwards": _forwards_with_without(dev, nets, x)}
            res["user_tier_entries"] = len(autotune._load()["entries"])
        finally:
            if prev is None:
                os.environ.pop(autotune.ENV_PATH, None)
            else:
                os.environ[autotune.ENV_PATH] = prev
            autotune.reset_cache()
    del nets
    torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the GPU only")
    import os
    import tempfile
    from repro_torch.kernels import _build, autotune
    dev = torch.device("cuda", 0)
    # the autotune user tier starts empty (and stays this run's own): the
    # main paths take the packaged tier's knobs, as a fresh install does
    tier = tempfile.TemporaryDirectory(prefix="chip-smoke-user-tier-")
    os.environ[autotune.ENV_PATH] = os.path.join(tier.name, "user.json")
    autotune.reset_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(f"fp32 settings: cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(built) or 'nothing (cached)'}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in ("log_conv2d", "log_matmul"):
        if name in built:
            check_registers(built[name]["log"], 128)
    # both attention kernels are launched at 256 threads a block, which lets
    # ptxas use the hardware's cap of 255 registers a thread: for them only
    # the no-spill part of the check can fail
    if "flash_attention" in built:
        check_registers(built["flash_attention"]["log"], 255)
    # both wkv6 kernels are bounded at 256 threads a block and one block an
    # SM, which allows the cap of 255 registers a thread
    if "wkv6" in built:
        check_registers(built["wkv6"]["log"], 255)

    phase_decode(dev)
    checks, max_err = phase_sweeps(dev)
    slice_rows, launches = phase_slice(dev)
    times, nets = phase_conv_times(dev)
    mm_rows, mm_err = phase_log_matmul(dev)
    at_rows, at_err = phase_attention(dev)
    lm = phase_serving(dev, LM_ARCH)
    lm_engine = lm.pop("engine")
    lm_times = phase_matmul_times(dev, lm_engine, LM_ARCH)
    lm_times.update(phase_lm_times(dev, lm_engine))
    lm_prof = phase_profiler_lm(dev, lm_engine)
    del lm_engine
    wk_rows, wk_err = phase_wkv6(dev)
    rw = phase_serving(dev, RWKV_ARCH)
    rw_engine = rw.pop("engine")
    wk_times = phase_wkv6_times(dev, rw_engine)
    rw_mm_times = phase_matmul_times(dev, rw_engine, RWKV_ARCH)
    del rw_engine
    oracle = phase_oracle(dev)
    example = phase_example(dev)
    paths = {}
    for arch in (RG_ARCH, MOE_ARCH):
        paths[arch] = phase_serving(dev, arch)
        del paths[arch]["engine"]
        torch.cuda.empty_cache()
    rg, moe = paths[RG_ARCH], paths[MOE_ARCH]
    prof = phase_profiler(dev, lm_prof)
    benches = phase_benches()
    training = phase_training(dev)
    twins = phase_example_twins(dev)
    tier.cleanup()
    tuned = _subprocess("--autotune")

    tot = {k: sum(n[k] for n in nets)
           for k in ("ms", "heuristic_ms", "event_ms", "plain_ms",
                     "library_ms",
                     "library_event_ms", "decode_conv_ms", "bound_ms",
                     "fp32_bound_ms", "bytes_ms", "ops_ms")}

    def row(name, src, replaces, n, err, t, **extra):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": ("operations" if t["ops_ms"] >= t["bytes_ms"]
                             else "bytes"),
                "library_ms": t["library_ms"],
                "profiler_calls": prof["profiler_calls"][name], **extra}

    mm = lm_times[f"log_matmul M={lm['args']['max_batch']}"]
    conv_launches = {"cnn_slice": launches, "oracle": oracle["launches"],
                     "example": example["launches"]}
    lm_paths = {LM_ARCH: lm, RWKV_ARCH: rw, RG_ARCH: rg, MOE_ARCH: moe}
    by_path = {op: {a: r["launches"][op] for a, r in lm_paths.items()
                    if r["launches"][op]}
               for op in ("log_matmul", "attention")}
    kernels = [
        row("log_conv2d_fused", "log_conv2d.cu",
            "src/repro/kernels/log_conv2d.py:491",
            launches, max_err, tot,
            launches_by_path=conv_launches,
            time=f"device time by torch.profiler, sum over the "
            f"{sum(CONVS_PER_NET.values())} convs of one forward of each "
            f"net, each conv timed alone at the packaged tier's knobs; "
            "heuristic_ms at the heuristic's; plain_ms and "
            "the *_event_ms by CUDA events; bound at the 989 TFLOP/s bf16 "
            "tensor-core peak", event_ms=tot["event_ms"],
            heuristic_ms=tot["heuristic_ms"],
            library_event_ms=tot["library_event_ms"],
            fp32_bound_ms=tot["fp32_bound_ms"],
            decode_conv_ms=tot["decode_conv_ms"],
            dense_ms=sum(n["dense_ms"] for n in nets),
            dense_library_ms=sum(n["dense_library_ms"] for n in nets),
            depthwise_ms=sum(n["depthwise_ms"] for n in nets),
            depthwise_library_ms=sum(n["depthwise_library_ms"] for n in nets),
            depthwise_bound_ms=sum(n["depthwise_bound_ms"] for n in nets),
            depthwise_cold_ms=sum(n["depthwise_cold_ms"] for n in nets),
            depthwise_cold_library_ms=sum(n["depthwise_cold_library_ms"]
                                          for n in nets)),
        row("log_matmul_cuda", "log_matmul.cu",
            "src/repro/kernels/log_matmul.py:95",
            sum(by_path["log_matmul"].values()),
            mm_err, mm, time=f"device time by torch.profiler over the "
            f"{mm['calls']} products of one {LM_ARCH} decode step; "
            f"plain_ms by CUDA events", event_loop_ms=mm["event_loop_ms"],
            launches_by_path=by_path["log_matmul"]),
        row("flash_attention_cuda", "flash_attention.cu",
            "src/repro/kernels/flash_attention.py:125",
            sum(by_path["attention"].values()), at_err,
            lm_times["attention decode"],
            launches_by_path=by_path["attention"],
            time=f"device time by torch.profiler over the {LM_ARCH} decode "
            f"step's 18 calls (split-KV variant, the packaged tier's "
            f"splits); plain_ms by CUDA events",
            splits=lm_times["attention decode"]["splits"],
            event_ms=lm_times["attention decode"]["event_ms"],
            library_event_ms=lm_times["attention decode"]["library_event_ms"],
            long_shapes={k: {f: lm_times[k][f] for f in (
                "variant", "ms", "library_ms", "bound_ms", "bound_by")}
                for k in lm_times if k.startswith("attention B=")}),
        row("wkv6_cuda", "wkv6.cu", "src/repro/kernels/wkv6.py:102",
            rw["launches"]["wkv6"], wk_err, wk_times["wkv6 decode step"],
            time=f"device time by torch.profiler over the {RWKV_ARCH} "
            f"decode step's 24 calls; plain_ms and event_ms by CUDA events",
            event_ms=wk_times["wkv6 decode step"]["event_ms"],
            variant=wk_times["wkv6 decode step"]["variant"],
            long_shapes={k: {f: wk_times[k][f] for f in (
                "variant", "blocks", "ms", "bound_ms", "bound_by")}
                for k in wk_times if k != "wkv6 decode step"})]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "checks": checks,
         "slice": slice_rows, "nets": nets,
         "conv_times": {"/".join(k): v for k, v in times.items()},
         "log_matmul_checks": mm_rows, "attention_checks": at_rows,
         "lm_slice": lm, "lm_times": lm_times, "wkv6_checks": wk_rows,
         "rwkv_slice": rw, "wkv6_times": wk_times,
         "rwkv_log_matmul_times": rw_mm_times, "oracle": oracle,
         "example": example, "recurrentgemma_slice": rg,
         "granite_moe_slice": moe, "lm_profiler": lm_prof,
         "profiler": prof, "benches": benches, "training": training,
         "example_twins": twins, "autotune": tuned,
         "profiler_windows_retaken": RETAKEN}, indent=1, default=str))
    print(f"conv times are sums over one batch-{BATCH} forward of each of "
          f"the four nets ({sum(CONVS_PER_NET.values())} convs; the kernel "
          f"and its library, F.conv2d on weights decoded in advance, as "
          f"torch.profiler device time); log_matmul and attention "
          f"times are sums over one {LM_ARCH} decode step (126 and 18 calls; "
          f"log_matmul, attention and their libraries as torch.profiler "
          f"device time), wkv6 "
          f"times over one {RWKV_ARCH} decode step (24 calls, device time); "
          f"log_matmul "
          f"and attention launches are those of the four LM main "
          f"paths (by path: {by_path}); log_conv2d launches those of "
          f"the CNN slice, whose convs its times cover (the oracle's and the "
          f"example's in launches_by_path: {conv_launches}); "
          f"profiler_calls are the kernel-dispatch profiler's calls of each "
          f"op in phase 18 (the four nets, gemma-2b's serve run, wkv6)")
    print(f"total wall time {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit({"--resume-check": resume_check,
              "--train-gemma": train_gemma_check,
              "--wkv6-times": wkv6_times_check,
              "--profiled-loops": profiled_loops_check,
              "--autotune": autotune_check}.get(
                  " ".join(sys.argv[1:]), main)())
