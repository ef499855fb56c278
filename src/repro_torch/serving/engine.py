"""Batched serving engine: continuous-batching prefill + decode.

Counterpart of `repro.serving.engine` for every token arch the port runs
(attention-only, RG-LRU hybrid, MoE and RWKV):

  · a fixed engine batch of `max_batch` slots, each slot = one sequence;
  · **prefill** runs one slot at a time at its own prompt length.  For
    archs without recurrent layers it is right-padded to a power-of-two
    bucket (pad keys land at positions past the prompt and are causally
    masked, then overwritten during decode, so they are never visible);
    archs with recurrent layers (RG-LRU, RWKV) prefill at the exact
    length, since a pad token would enter the recurrent state.  The slot's
    part of the cache (K/V and every recurrent state alike) is zeroed in
    place first;
  · **decode** is one batched forward for all slots: where the JAX engine
    vmaps over slots, each batch row here carries its own position, in the
    RoPE, in the cache write (a scatter at ``slot_pos[b]``) and in the
    attention offsets, so ragged batches need no padding (recurrent layers
    read no position: each row carries its own state);
  · finished slots are refilled from the FIFO queue between decode steps;
  · sampling is greedy at temperature 0; above it a `torch.Generator`
    seeded with ``seed + len(output)`` draws the token (its stream differs
    from `jax.random`'s, so only greedy decoding matches the JAX engine).

MoE capacity follows the token count of each forward, as in JAX.  A
prefill routes its padded bucket: C = int(cf·Tpad·K/E) counts the pad
tokens, which queue behind the real ones (queue order is token-major), so
a pad token never takes a real token's slot, as in the JAX engine, which
pads alike.  A decode step routes all ``max_batch`` slots as one group of
N tokens where the JAX engine routes each slot alone (N = 1); at T = 1 the
capacity is the whole group in both, so no token drops and every token's
output is the same in both.

The `stats` counters are always kept; with telemetry on, the engine also
records per-request timelines, TTFT / prefill / decode-step / tokens-per-s
histograms and queue / slot gauges on its own metrics registry, and runs
each prefill and decode step as a program of the kernel-dispatch profiler
(`obs.kernel_profile.time_program`: a "prefill" / "decode" span and
first/steady program times while profiling is on).  Times are host-clock
and end in a device synchronisation (the sampled tokens are read back).
`metrics_snapshot()["kernels"]` holds the profiler's per-dispatch records
(op, impl, shape key, analytic bytes, first/steady µs) and programs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_impl
from repro_torch.models import transformer
from repro_torch.obs import kernel_profile as obs_kprof
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [T] int32
    max_new_tokens: int = 16
    temperature: float = 0.0           # 0 → greedy
    seed: int = 0
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    # host-clock lifecycle marks (perf_counter seconds), filled when
    # telemetry is on: enqueue → prefill_start → first_token → retire
    timeline: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    max_prompt: int = 128
    max_len: int = 256                 # cache capacity (prompt + generation)
    eos_id: int = -1                   # -1: never stop on a token
    cache_dtype: Any = torch.float32
    # the attention dispatch for serving, resolved once against the
    # params' device and written into the engine's model config: "auto"
    # (the CUDA kernel on the card, blockwise on the CPU) or any
    # `ops.attention` impl
    attn_impl: str = "auto"
    # "auto": timeline/histogram/span work follows the trace and profiler
    # gates (REPRO_TRACE, REPRO_KERNEL_PROFILE); "on"/"off" force it.
    # `stats` is always kept.
    telemetry: str = "auto"


_NULL_CTX = contextlib.nullcontext()


def _has_recurrence(cfg) -> bool:
    return any(k in ("rwkv", "rec") for k in cfg.layer_pattern)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class ServeEngine:
    def __init__(self, cfg, params, ecfg: EngineConfig = EngineConfig()):
        if not cfg.embed_inputs:
            raise ValueError("engine serves token archs; frontend-stub archs "
                             "(musicgen) feed embeddings")
        transformer.check_supported(cfg)
        if ecfg.telemetry not in ("auto", "on", "off"):
            raise ValueError(f"telemetry must be auto|on|off, got "
                             f"{ecfg.telemetry!r}")
        self.device = params["embed"]["table"].device
        cfg = dataclasses.replace(
            cfg, attn_impl=resolve_impl("attention", ecfg.attn_impl,
                                        self.device))
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        B, L = ecfg.max_batch, ecfg.max_len
        self.cache = transformer.init_cache(cfg, B, L, ecfg.cache_dtype,
                                            device=self.device)
        self._pad_prefill = not _has_recurrence(cfg)
        # per-slot host state
        self.slot_req: list[Request | None] = [None] * B
        self.slot_pos = np.zeros(B, np.int64)      # next write position
        self.slot_last = np.zeros(B, np.int64)     # last emitted token
        self.queue: deque[Request] = deque()       # O(1) FIFO admission
        self.finished: list[Request] = []
        # per-engine registry so concurrent engines (and tests) stay
        # isolated; `stats` below is a view over these counters.
        self.metrics = obs_metrics.MetricsRegistry()
        self._c_prefill = self.metrics.counter("serve_prefill_calls")
        self._c_decode = self.metrics.counter("serve_decode_steps")
        self._c_tokens = self.metrics.counter("serve_tokens_out")
        self._c_retired = self.metrics.counter("serve_requests_retired")
        self._g_queue = self.metrics.gauge("serve_queue_depth")
        self._g_slots = self.metrics.gauge("serve_slots_busy")
        self._h_ttft = self.metrics.histogram("serve_ttft_s")
        self._h_step = self.metrics.histogram("serve_decode_step_s")
        self._h_prefill = self.metrics.histogram("serve_prefill_s")
        self._h_tps = self.metrics.histogram(
            "serve_tokens_per_s", bounds=obs_metrics.RATE_BUCKETS)

    # ----------------------------------------------------------- telemetry
    def _telemetry_on(self) -> bool:
        mode = self.ecfg.telemetry
        if mode == "off":
            return False
        if mode == "on":
            return True
        return obs_trace.TRACER.enabled() or obs_kprof.PROFILER.enabled()

    @property
    def stats(self) -> dict:
        """Counter view (always maintained)."""
        return {"prefill_calls": int(self._c_prefill.value),
                "decode_steps": int(self._c_decode.value),
                "tokens_out": int(self._c_tokens.value)}

    def metrics_snapshot(self) -> dict:
        """One JSON-able dict with everything measured so far: the engine's
        own registry (TTFT/tokens-per-s histograms, gauges, counters), the
        `stats` view, the process-wide kernel-dispatch records (per-op
        impl, bytes moved, first/steady µs, the prefill/decode programs)
        and the default registry (kernel-dispatch histograms)."""
        return {"engine": self.metrics.snapshot(),
                "stats": self.stats,
                "kernels": obs_kprof.PROFILER.snapshot(),
                "global": obs_metrics.REGISTRY.snapshot()}

    # ------------------------------------------------------------ plumbing
    def submit(self, req: Request):
        if len(req.prompt) > self.ecfg.max_prompt:
            raise ValueError("prompt longer than engine max_prompt")
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{req.max_new_tokens} (request {req.uid})")
        self.queue.append(req)
        if self._telemetry_on():
            req.timeline["enqueue"] = time.perf_counter()
            self._g_queue.set(len(self.queue))
            obs_trace.instant("enqueue", uid=req.uid,
                              prompt_len=len(req.prompt))

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _prefill(self, slot: int, prompt) -> torch.Tensor:
        """Zero the slot's cache, run the prompt (bucket-padded unless the
        arch is recurrent) through it → the logits [V] of the last real
        token."""
        T = len(prompt)
        Tpad = min(_next_pow2(T), self.ecfg.max_prompt) \
            if self._pad_prefill else T
        toks = torch.zeros((1, Tpad), dtype=torch.long)
        toks[0, :T] = torch.as_tensor(np.asarray(prompt), dtype=torch.long)
        # every cache leaf is [n_rep, B, ...]: K/V, and the fp32 states of
        # RG-LRU (h, conv) and RWKV alike
        sub = _map(lambda c: c[:, slot:slot + 1].zero_(),
                   self.cache["segments"])
        h, _, _ = transformer.forward(
            self.params, toks.to(self.device), self.cfg,
            cache={"index": 0, "segments": sub})
        return transformer.logits_fn(self.params, h[:, T - 1:T],
                                     self.cfg)[0, 0]

    def _admit(self):
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            tele = self._telemetry_on()
            t0 = time.perf_counter() if tele else 0.0
            with obs_trace.span("prefill", uid=req.uid, slot=slot,
                                tokens=len(req.prompt)) if tele else _NULL_CTX:
                if tele:
                    req.timeline["prefill_start"] = t0
                run_prefill = lambda: self._prefill(slot, req.prompt)
                logits = (obs_kprof.PROFILER.time_program("prefill",
                                                          run_prefill)
                          if tele else run_prefill())
                tok = self._sample(logits, req)
                self.slot_req[slot] = req
                req.output.append(tok)
                self.slot_pos[slot] = len(req.prompt)
                self.slot_last[slot] = tok
            self._c_prefill.inc()
            self._c_tokens.inc()
            if tele:
                now = time.perf_counter()
                req.timeline["first_token"] = now
                self._h_prefill.record(now - t0)
                self._h_ttft.record(now - req.timeline.get("enqueue", t0))
                self._g_queue.set(len(self.queue))

    def _sample(self, logits, req: Request) -> int:
        if req.temperature <= 0:
            return int(torch.argmax(logits))
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(req.seed + len(req.output))
        probs = torch.softmax(logits.to(torch.float32) / req.temperature, -1)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _retire(self):
        tele = self._telemetry_on()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            hit_eos = (self.ecfg.eos_id >= 0 and req.output
                       and req.output[-1] == self.ecfg.eos_id)
            full = self.slot_pos[i] + 1 >= self.ecfg.max_len
            if len(req.output) >= req.max_new_tokens or hit_eos or full:
                req.done = True
                self.finished.append(req)
                self.slot_req[i] = None
                self._c_retired.inc()
                if tele:
                    now = time.perf_counter()
                    req.timeline["retire"] = now
                    dur = now - req.timeline.get("prefill_start", now)
                    if dur > 0 and req.output:
                        self._h_tps.record(len(req.output) / dur)
                    obs_trace.instant("retire", uid=req.uid,
                                      tokens=len(req.output))

    def _decode(self) -> torch.Tensor:
        """All slots, one token each, each at its own position → logits
        [max_batch, V].  Idle slots run too, as in the JAX engine; their
        rows are ignored and a later prefill zeroes their cache."""
        lp = torch.from_numpy(np.stack([self.slot_last, self.slot_pos]))
        lp = lp.to(self.device)
        h, _, _ = transformer.forward(
            self.params, lp[0][:, None], self.cfg,
            cache={"index": lp[1], "segments": self.cache["segments"]})
        return transformer.logits_fn(self.params, h, self.cfg)[:, 0]

    # ------------------------------------------------------------ main loop
    def step(self) -> bool:
        """One engine iteration: retire → admit → batched decode."""
        self._retire()
        self._admit()
        busy = sum(r is not None for r in self.slot_req)
        if not busy:
            return False
        tele = self._telemetry_on()
        if tele:
            self._g_slots.set(busy)
            self._g_queue.set(len(self.queue))
            t0 = time.perf_counter()
        logits = (obs_kprof.PROFILER.time_program("decode", self._decode)
                  if tele else self._decode())
        greedy = logits.argmax(dim=-1).tolist()
        self._c_decode.inc()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = greedy[i] if req.temperature <= 0 else \
                self._sample(logits[i], req)
            req.output.append(tok)
            self.slot_pos[i] += 1
            self.slot_last[i] = tok
            self._c_tokens.inc()
        if tele:
            self._h_step.record(time.perf_counter() - t0)
        return True

    def run(self, max_iters: int = 100_000):
        it = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and it < max_iters:
            self.step()
            it += 1
        self._retire()
        done, self.finished = self.finished, []
        return done
