"""Host cost of one `ops.conv2d` / `ops.attention` call on the card.

    python -m repro_torch.benchmarks.dispatch_overhead [--out FILE]
    PYTHONPATH=<other checkout>/src python <this file> --out FILE

The second form measures another checkout's `ops` with this script, so two
versions compare within one process each and one machine.

For each case the stream is first held by a sleep kernel, then ``CALLS``
calls are launched and the host clock (``time.perf_counter``) reads the
launching loop alone: the kernels run after the loop, so what is read is the
Python dispatch, the wrapper and the launch, not the kernel.  Each case
runs with the kernel-dispatch profiler off (the shipping default) and on;
the figure is the median over ``ROUNDS`` rounds.  The cases are the main
paths' own shapes: VGG-16's first conv and a ResNet-34 1x1 stride-2 conv
at batch 8 (packed logq6 codes), and gemma-2b's decode attention (a bf16
q over its fp32 cache).  It uses only the `ops` entry points, so it runs
against any checkout of the port since the profiler came in.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

CALLS = 100
ROUNDS = 7
SLEEP_CYCLES = 60_000_000    # ~30 ms at the H100's clock: longer than a loop


def _cases(dev):
    from repro_torch.core.logquant import LogQuantConfig, quantize_tensor
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(0)

    def conv(B, H, C, K, Cout, stride):
        x = torch.randn((B, H, H, C), generator=gen, device=dev)
        qt = quantize_tensor(torch.randn((K, K, C, Cout), generator=gen,
                                         device=dev), LogQuantConfig())
        return lambda: ops.conv2d(x, qt, stride=stride, impl="cuda")

    q = torch.randn((4, 1, 8, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((4, 64, 1, 256), generator=gen, device=dev)
            for _ in range(2))
    return {"conv2d 8x224x224x3 -> 64, 3x3": conv(8, 224, 3, 3, 64, 1),
            "conv2d 8x14x14x256 -> 512, 1x1 s2": conv(8, 14, 256, 1, 512, 2),
            "attention 4x1 q, 64 fp32 keys, 8 heads over 1, d256":
                lambda: ops.attention(q, k, v, causal=True, q_offset=63,
                                      impl="cuda")}


def _launch_us(fn) -> float:
    """Host µs a call to launch ``fn`` with the stream held."""
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / CALLS * 1e6


def measure() -> dict:
    from repro_torch.obs import kernel_profile as kprof
    if not torch.cuda.is_available():
        raise RuntimeError("dispatch_overhead times launches on the card, "
                           "and this machine has no CUDA device")
    dev = torch.device("cuda", 0)
    out = {}
    with torch.no_grad():
        for name, fn in _cases(dev).items():
            fn()
            torch.cuda.synchronize()
            row = {}
            for mode in ("off", "on"):
                kprof.set_enabled(mode == "on")
                try:
                    runs = [_launch_us(fn) for _ in range(ROUNDS)]
                finally:
                    kprof.set_enabled(None)
                    kprof.clear()
                row[f"profiler_{mode}_us"] = statistics.median(runs)
                row[f"profiler_{mode}_rounds"] = runs
            out[name] = row
            print(f"{name}: host µs a call, profiler off "
                  f"{row['profiler_off_us']:.2f}, on "
                  f"{row['profiler_on_us']:.2f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the result as JSON here")
    args = ap.parse_args(argv)
    import repro_torch
    res = {"ops_from": repro_torch.__file__, "calls": CALLS,
           "rounds": ROUNDS, "card": torch.cuda.get_device_name(0)
           if torch.cuda.is_available() else None, "cases": measure()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
