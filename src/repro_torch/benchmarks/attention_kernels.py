"""GQA/MQA attention kernel times on the card: the twin of the JAX
package's `benchmarks/attention_kernels.py`.

    python -m repro_torch.benchmarks.run --only attention_kernels  # the card
    PYTHONPATH=src python -m repro_torch.benchmarks.run \
        --only attention_kernels --device cpu

The JAX bench's five serving-shaped ``CASES`` at full size, causal, with
the queries at the end of the keys (``q_offset = Tk - Tq``: a decode query
at position 0 would see one key).  Per case: the blockwise path, the CUDA
kernel (`ops.attention(impl="cuda")`) and
`F.scaled_dot_product_attention` (the kv heads expanded in advance, the
mask given) as `torch.profiler` device time (host clock on the CPU, where
"cuda" runs the kernel's plain version); the bytes of
`attention_traffic_bytes` for ``cuda`` (the kernel's own blocks),
``repeat`` (K/V expanded to H heads before a per-head kernel) and
``blockwise``; and ``native_traffic_win_x``, repeat's K/V term over the
kernel's, gated as in JAX at ≥ 2 where rep ≥ 4 and Tk ≥ 4096.

The cases run in bf16, the dtype in which the kernel's prefill takes the
tensor cores (64 folded rows a block).  In fp32 a prefill takes the
split-KV variant, whose 8-row blocks re-read K/V once per 8 folded rows;
that figure is reported beside it (``native_traffic_win_x_fp32``) and not
gated.

Two probes, each maxdiff < 1e-3 in fp32: the kernel against `ref_attention`
on JAX's ``1×64, H 8/2, D 16``; and a decode at a per-row offset tensor
(two rows at different positions, one offset each) against the same
reference: the counterpart of JAX's traced-offset probe.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attention_traffic_bytes
from repro_torch.kernels.ref import attention_mask, ref_attention

from .common import card_name, device_us, fmt_table, timer_name, write_json

TRAFFIC_WIN_GQA4 = 2.0   # the JAX bench's gate: ≥2x fewer K/V bytes, rep 4
PROBE_LIMIT = 1e-3
DTYPE = torch.bfloat16   # the cases' dtype (see above); the probes are fp32

# (case, B, Tq, Tk, H, Hkv, D): the JAX bench's decode/prefill shapes
CASES = [
    ("decode_gqa4",    1,   1, 4096, 8, 2, 64),
    ("decode_gqa4_8k", 1,   1, 8192, 8, 2, 64),
    ("decode_mqa",     1,   1, 4096, 8, 1, 64),
    ("prefill_gqa4",   1, 128, 4096, 8, 2, 64),
    ("decode_mha",     1,   1, 4096, 8, 8, 64),   # control: no GQA win
]


def _win(B, Tq, Tk, H, Hkv, D, itemsize) -> tuple[dict, float]:
    traffic = {p: attention_traffic_bytes(p, B, Tq, Tk, H, Hkv, D,
                                          itemsize=itemsize)
               for p in ("cuda", "repeat", "blockwise")}
    return traffic, traffic["repeat"]["kv"] / traffic["cuda"]["kv"]


def run(device=None, root=None, reps: int = 5) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, ok = [], True
    with torch.no_grad():
        for case, B, Tq, Tk, H, Hkv, D in CASES:
            q = torch.randn((B, Tq, H, D), generator=gen, device=dev)
            k, v = (torch.randn((B, Tk, Hkv, D), generator=gen, device=dev)
                    .to(DTYPE) for _ in range(2))
            q = q.to(DTYPE)
            kw = dict(causal=True, q_offset=Tk - Tq)
            mask = attention_mask(Tq, Tk, causal=True, window=None,
                                  q_offset=Tk - Tq, k_offset=0,
                                  device=dev)[:, None]
            ql = q.transpose(1, 2)
            kl, vl = (a.transpose(1, 2).repeat_interleave(H // Hkv, 1)
                      for a in (k, v))
            us = {name: device_us(fn, dev, reps) for name, fn in (
                ("kernel", lambda: ops.attention(q, k, v, impl="cuda", **kw)),
                ("blockwise",
                 lambda: ops.attention(q, k, v, impl="blockwise", **kw)),
                ("sdpa", lambda: F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=mask)))}
            traffic, win = _win(B, Tq, Tk, H, Hkv, D, q.element_size())
            win_fp32 = _win(B, Tq, Tk, H, Hkv, D, 4)[1]
            rep = H // Hkv
            gated = rep >= 4 and Tk >= 4096
            row_ok = win >= TRAFFIC_WIN_GQA4 if gated else True
            ok &= row_ok
            rows.append({
                "case": case, "shape": f"{B}x{Tq}/{Tk}x{H}.{Hkv}x{D}",
                "rep": rep, "dtype": str(DTYPE).removeprefix("torch."),
                "kernel_us": us["kernel"], "blockwise_us": us["blockwise"],
                "sdpa_us": us["sdpa"],
                **{f"bytes_{p}": t["total"] for p, t in traffic.items()},
                **{f"kv_bytes_{p}": t["kv"] for p, t in traffic.items()},
                "native_traffic_win_x": win,
                "native_traffic_win_x_fp32": win_fp32,
                "gated": gated, "ok": row_ok})

        # probes in fp32: the kernel against the full-softmax reference,
        # and a decode at per-row offsets
        B, T, H, Hkv, D = 1, 64, 8, 2, 16
        q = torch.randn((B, T, H, D), generator=gen, device=dev)
        k, v = (torch.randn((B, T, Hkv, D), generator=gen, device=dev)
                for _ in range(2))
        want = ref_attention(q, k, v, causal=True)
        d_full = float((ops.attention(q, k, v, impl="cuda")
                        - want).abs().max())
        q2, k2, v2 = (torch.cat([a, a.flip(1)]) for a in (q, k, v))
        want2 = ref_attention(q2, k2, v2, causal=True)
        offs = torch.tensor([T - 1, T // 2], device=dev)
        dec = ops.attention(q2[torch.arange(2), offs][:, None], k2, v2,
                            causal=True, q_offset=offs, impl="cuda")
        d_dec = float((dec[:, 0] - want2[torch.arange(2), offs])
                      .abs().max())
    probes = {"kernel_gqa": {"maxdiff": d_full},
              "kernel_decode_row_offsets": {"maxdiff": d_dec,
                                            "offsets": offs.tolist()}}
    for p in probes.values():
        p["ok"] = p["maxdiff"] < PROBE_LIMIT
        ok &= p["ok"]

    print(fmt_table([{k: (f"{v:.4g}" if isinstance(v, float) else v)
                      for k, v in r.items()} for r in rows],
                    ["case", "shape", "rep", "dtype", "kernel_us",
                     "blockwise_us", "sdpa_us", "bytes_cuda", "bytes_repeat",
                     "native_traffic_win_x", "native_traffic_win_x_fp32",
                     "ok"]))
    for name, p in probes.items():
        print(f"{name} probe: |kernel - ref| = {p['maxdiff']:.2e} "
              f"({'OK' if p['ok'] else 'FAIL'})")
    out = {"rows": rows, "probes": probes, "timer": timer_name(dev),
           "card": card_name(dev),
           "min_gqa4_traffic_win_x": min((r["native_traffic_win_x"]
                                          for r in rows if r["gated"]),
                                         default=None),
           "kernel_maxdiff": max(p["maxdiff"] for p in probes.values()),
           "ok": bool(ok)}
    path = write_json("BENCH_torch_attention.json", out, root)
    print(f"wrote {path}")
    return out
