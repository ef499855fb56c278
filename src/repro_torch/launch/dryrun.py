"""Multi-pod dry run: trace every (architecture × input shape) on the
production meshes and count FLOPs, bytes, memory and collectives for
§Roofline.

Counterpart of `repro.launch.dryrun`, with its names, its CLI, its
skip-if-exists files ``<arch>__<shape>__{single,multi}.json`` and its
record schema, which `analysis/roofline.py` and `analysis/report.py` read:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape decode_32k [--multi-pod]

The port has no compiler, so it counts what it runs.  Importing this
module sets no environment variable and starts no process group:
`run_cell` opens a ``fake`` group of 256 ranks (512 with ``--multi-pod``)
for the cell (`fake_group`), builds `make_production_mesh` on it and
closes the group afterwards.  `_compile` (the trace, where JAX compiles)
builds the step with `launch.steps.build_step`, places its ``meta``
arguments by the step's shardings (`sharding.place`) and runs it once under
a `Count`, a `TorchDispatchMode` that sees the ops DTensor runs on this
rank's shards and the collectives it issues.  Nothing is allocated, and
the fake group's collectives move nothing.

  flops            matmuls and convolutions by the formulas of
                   `torch.utils.flop_counter` (FlopCounterMode's), one per
                   output element of every other floating-point pointwise
                   op and one per input element of a reduction, as XLA's
                   HloCostAnalysis counts them;
  transcendentals  the output elements of exp, log, tanh, rsqrt, sigmoid
                   and the like (not in ``flops``, as in XLA);
  bytes            for each op, the bytes of its distinct local inputs and
                   outputs (a view moves none): what the eager program
                   moves, op by op.  XLA's count after fusion is lower;
  the four ops of `kernels/ops.py` (B1–B4 on the card, their plain versions
  on a CPU or ``meta`` tensor) count as one op each, by the kernel's
  arithmetic, and hold only their outputs (`ops.set_counter`), so a step
  counts the same on ``meta`` shards as on the card.  An op whose inputs
  require grad runs its plain version on the card too (the wrappers refuse
  grad), and counts op by op;
  memory           per device, from the local shards: ``argument_bytes``,
                   ``output_bytes``, ``alias_bytes`` (outputs that are the
                   arguments updated in place, the train state and the
                   decode cache, in the role of JAX's donation) and
                   ``temp_bytes`` (the peak of the other live bytes,
                   tracked by weak references on the storages the ops
                   make);
  collectives      each ``c10d_functional`` op under JAX's name, its wire
                   bytes by `wire_bytes` (JAX's accounting).  Where
                   DTensor's CPU fallback replaces an all-to-all by an
                   all-gather and a chunk, the all-to-all that NCCL issues
                   is counted instead.

There is no unroll-diff: XLA counts a loop body once, so JAX compiles
twice; the port's `forward` loops over the layers in Python, so one trace
counts every layer.  ``cost_true`` is that trace's count, and
``cost_acct_u1``/``cost_acct_u2`` hold the same numbers, kept for the
schema.  JAX's accounting config (``attn_block_k=S``) would change nothing:
attention counts by its arithmetic, whatever its block.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import resource
import time
import traceback
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..analysis.roofline import model_flops_for
from ..configs.base import SHAPES, cell_is_runnable
from ..configs.registry import ARCH_NAMES, get_config
from ..core.logquant import QuantizedTensor
from ..kernels import ops
from ..models import sharding
from .mesh import make_production_mesh
from .steps import build_step

# ---------------------------------------------------------------------------
# what counts as what
# ---------------------------------------------------------------------------

# collective ops (``c10d_functional``, ``_c10d_functional``, DTensor's
# ``_dtensor``) → JAX's names; ``wait_tensor`` and the autograd wrapper are
# no transfer
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all"}
_COMM_NAMESPACES = ("c10d_functional", "_c10d_functional", "_dtensor")

TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
                  "tanh", "sigmoid", "rsqrt", "sqrt", "sin", "cos", "tan",
                  "erf", "erfinv", "silu", "gelu", "softplus", "logaddexp",
                  "log_sigmoid_forward", "_softmax", "_log_softmax",
                  "logsumexp"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "var", "std",
              "prod", "cumsum", "cumprod", "argmax", "argmin", "logsumexp",
              "_softmax", "_log_softmax", "norm", "linalg_vector_norm",
              "var_mean", "topk"}
# copies and fills: data movement, no arithmetic
_NO_FLOPS = {"clone", "copy", "copy_", "_to_copy", "fill", "fill_", "zero_",
             "lift_fresh_copy", "contiguous"}
# ops that return a view of an input or allocate without reading one
_NO_TRAFFIC = {"_unsafe_view", "alias", "detach", "lift_fresh",
               "_reshape_alias", "empty", "empty_strided", "empty_like",
               "new_empty", "new_empty_strided", "set_", "resize_"}


def wire_bytes(op: str, result_bytes: int, group: int) -> int:
    """Per-device wire bytes of one collective, JAX's accounting
    (`repro.analysis.roofline.collective_bytes`): all-gather, all-to-all (Σ
    of its results) and collective-permute move their result's bytes, an
    all-reduce twice them (a ring's reduce-scatter and all-gather), a
    reduce-scatter its result times the group (the operand)."""
    if op == "all-reduce":
        return 2 * result_bytes
    if op == "reduce-scatter":
        return result_bytes * group
    return result_bytes


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and `QuantizedTensor`s
    (a DTensor as its local shard)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, QuantizedTensor):
        yield from _tensors((tree.packed, tree.scale))
    elif isinstance(tree, DTensor):
        yield tree.to_local()
    elif torch.is_tensor(tree):
        yield tree


def _key(t) -> int:
    return t.untyped_storage()._cdata


def _group_size(func, args, kwargs) -> int:
    names = [a.name for a in func._schema.arguments]
    if "group_size" in names:
        i = names.index("group_size")
        return int(kwargs.get("group_size", args[i] if i < len(args) else 1))
    if "group_name" in names:
        i = names.index("group_name")
        name = kwargs.get("group_name", args[i] if i < len(args) else None)
        try:
            return dist.distributed_c10d._resolve_process_group(name).size()
        except Exception:  # an unnamed group: the all-reduce needs none
            return 1
    return 1


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------


class Count(TorchDispatchMode):
    """Counts what a step runs on this rank: FLOPs, transcendentals,
    bytes, collectives, kernel ops, and the live bytes the ops make.

    Ops on DTensors are let through (``NotImplemented``), so DTensor runs
    and the mode sees the local ops and collectives it issues.  Inside an
    op of `kernels/ops.py` (`kernel`) and inside DTensor's CPU all-to-all
    fallback the local ops count no work, only their memory."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.coll_bytes = defaultdict(int)
        self.coll_counts = defaultdict(int)
        self.kernels = defaultdict(int)
        self._quiet = 0
        self._blind = 0
        self._args: set = set()
        self._live: dict = {}     # storage key → (allocation id, bytes)
        self._refs: dict = {}
        self._events: list = []   # (allocation id, ±bytes), in order
        self._next = 0
        self.memory: dict = {}

    # ---- the dispatch --------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._blind or any(isinstance(t, FakeTensor)
                              for t in _tensors(out)):
            # inside a kernel op, or DTensor's sharding propagation (fake
            # tensors at global shapes)
            return out
        self._track(out)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func._schema.name.split("::")[-1]
        if func.namespace in _COMM_NAMESPACES:
            if name in COLLECTIVES:
                op = COLLECTIVES[name]
                res = sum(_nbytes(t) for t in _tensors(out))
                self.collective(op, res, _group_size(func, args, kwargs))
            return
        packet = func._overloadpacket
        outs = list(_tensors(out))
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        elif outs and outs[0].is_floating_point():
            ins = [a for a in _tensors((args, kwargs))]
            if name in REDUCTIONS:
                self.flops += max((a.numel() for a in ins), default=0)
                if name in TRANSCENDENTAL:
                    self.transcendentals += outs[0].numel()
            elif torch.Tag.pointwise in func.tags and name not in _NO_FLOPS:
                n = sum(t.numel() for t in outs)
                if name in TRANSCENDENTAL:
                    self.transcendentals += n
                else:
                    self.flops += n
        if func.is_view or name in _NO_TRAFFIC:
            return
        seen, total = set(), 0
        for t in [*_tensors((args, kwargs)), *outs]:
            if id(t) not in seen:
                seen.add(id(t))
                total += _nbytes(t)
        self.bytes += total

    def collective(self, op: str, result_bytes: int, group: int):
        self.coll_bytes[op] += wire_bytes(op, result_bytes, group)
        self.coll_counts[op] += 1

    def kernel(self, op: str, call, inputs, work):
        """One op of `kernels/ops.py` as its kernel runs it: ``call`` runs
        unseen (the plain version's ops on a ``meta`` tensor, the wrapper's
        on the card), ``work(out)`` gives its (flops, transcendentals), its
        bytes are its distinct inputs' and outputs', its memory its
        outputs'."""
        self._blind += 1
        try:
            out = call()
        finally:
            self._blind -= 1
        self._track(out)
        if not self._quiet:
            flops, trans = work(out)
            self.flops += int(flops)
            self.transcendentals += int(trans)
            seen, total = set(), 0
            for t in [*_tensors(inputs), *_tensors(out)]:
                if id(t) not in seen:
                    seen.add(id(t))
                    total += _nbytes(t)
            self.bytes += total
            self.kernels[op] += 1
        return out

    # ---- memory ----------------------------------------------------------

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._args:
                continue
            n = st.nbytes()
            aid = self._next
            self._next += 1
            self._live[key] = (aid, n)
            self._events.append((aid, n))
            self._refs[key] = weakref.ref(st, self._freed(key))

    def _freed(self, key):
        def cb(_):
            aid, n = self._live.pop(key)
            self._refs.pop(key, None)
            self._events.append((aid, -n))
        return cb

    @contextlib.contextmanager
    def trace(self, args):
        """Count what runs inside: the arguments' storages are registered
        first, the ops' counter is installed, DTensor's CPU all-to-all
        fallback is counted as an all-to-all."""
        for t in _tensors(args):
            self._args.add(_key(t))
        self.memory = {"argument_bytes": sum(_nbytes(t)
                                             for t in _tensors(args))}
        old = ops.set_counter(self)
        try:
            with self._alltoall(), self:
                yield self
        finally:
            ops.set_counter(old)

    def finish(self, out):
        """The memory figures, once the step has returned ``out``."""
        outs = list(_tensors(out))
        made = {self._live[_key(t)][0] for t in outs
                if _key(t) in self._live}
        live = peak = 0
        for aid, n in self._events:
            if aid not in made:
                live += n
                peak = max(peak, live)
        self.memory.update(
            output_bytes=sum(_nbytes(t) for t in outs),
            temp_bytes=peak,
            alias_bytes=sum(_nbytes(t) for t in outs
                            if _key(t) in self._args))
        return self.memory

    @contextlib.contextmanager
    def _alltoall(self):
        """DTensor's CPU path gathers and chunks where NCCL runs one
        all-to-all (`shard_dim_alltoall`); count that all-to-all: its
        result's bytes, over the mesh dim's group."""
        from torch.distributed.tensor import _collective_utils, \
            placement_types
        mods = [m for m in (_collective_utils, placement_types)
                if hasattr(m, "shard_dim_alltoall")]
        orig = _collective_utils.shard_dim_alltoall

        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            if mesh.device_type != "cpu":
                return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            self._quiet += 1
            try:
                out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._quiet -= 1
            if not self._quiet:
                self.collective("all-to-all", _nbytes(out),
                                mesh.size(mesh_dim))
            return out
        saved = [(m, m.shard_dim_alltoall) for m in mods]
        for m in mods:
            m.shard_dim_alltoall = shard_dim_alltoall
        try:
            yield
        finally:
            for m, f in saved:
                m.shard_dim_alltoall = f

    def collectives(self) -> dict:
        """JAX's ``{"total", "by_type", "counts"}``."""
        return {"total": int(sum(self.coll_bytes.values())),
                "by_type": dict(self.coll_bytes),
                "counts": dict(self.coll_counts)}


# ---------------------------------------------------------------------------
# JAX's names
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` process group of ``world`` ranks (this process is rank
    0; collectives move nothing), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()


def _plain_cost(count: Count) -> dict:
    return {"flops": float(count.flops), "bytes": float(count.bytes),
            "transcendentals": float(count.transcendentals)}


def _memory(count: Count) -> dict:
    return {k: int(count.memory[k]) for k in
            ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes")}


def _compile(cfg, shape_name, mesh):
    """The trace, where JAX compiles: `build_step`, its ``meta`` arguments
    placed by its shardings, one run under a `Count`.  Returns (step kind,
    the count)."""
    kind, (fn, abs_args, shard_args) = build_step(cfg, shape_name, mesh)
    return kind, _compile_args(fn, abs_args, shard_args)


def _compile_args(fn, abs_args, shard_args) -> Count:
    """The count of ``fn`` run once on ``abs_args`` placed by
    ``shard_args`` (a step builder's three results)."""
    args = tuple(sharding.place(a, s) for a, s in zip(abs_args, shard_args))
    count = Count()
    with count.trace(args):
        out = fn(*args)
    count.finish(out)
    return count


def _main_seg_reps(cfg) -> int:
    reps = [r for _, r in cfg.segments if r > 1]
    assert len(reps) <= 1, f"{cfg.name}: >1 multi-rep segment {cfg.segments}"
    return reps[0] if reps else 1


def _opt_cfg(cfg, shape_name):
    """The §Perf winning combination per step kind ('--variant opt'), as
    JAX picks it."""
    step = SHAPES[shape_name]["step"]
    if step in ("train", "prefill"):
        if (cfg.name, step) in {("llama3-405b", "train"),
                                ("llama3-405b", "prefill"),
                                ("musicgen-large", "prefill")}:
            return cfg
        return dataclasses.replace(
            cfg, attn_shard="seq", residual_shard="seq",
            attn_acc_dtype=torch.bfloat16, gqa_broadcast=True)
    return dataclasses.replace(cfg, gqa_broadcast=True)


def _peak_rss() -> int:
    """This process's peak resident set so far, bytes: Linux's ``VmHWM``
    (``ru_maxrss`` keeps the high-water mark of the process that started
    this one across ``exec``), else ``ru_maxrss`` (KiB on Linux)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def cost_record(count: Count) -> dict:
    """The record's cost fields from one trace."""
    cost, coll = _plain_cost(count), count.collectives()
    return {"collectives_prod_once": coll,
            "cost_prod_once": cost,
            "cost_true": {"flops": cost["flops"], "bytes": cost["bytes"],
                          "collective_bytes": coll["total"]},
            "cost_acct_u1": {**cost, "collective_bytes": coll["total"],
                             "coll_by_type": coll["by_type"]},
            "cost_acct_u2": {**cost, "collective_bytes": coll["total"]}}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str, verbose: bool = True,
             variant: str = "baseline") -> dict:
    mesh_name = "multi" if multi_pod else "single"
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    if variant == "opt":
        cfg = _opt_cfg(cfg, shape_name)
    sh = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips,
           "model_flops": model_flops_for(cfg, sh),
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}

    if not cell_is_runnable(arch, shape_name):
        rec["skipped"] = "full-attention arch at 500k context"
        _save(path, rec)
        return rec

    t0 = time.time()
    try:
        with fake_group(chips):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            kind, count = _compile(cfg, shape_name, mesh)
        rec["step_kind"] = kind
        rec["memory"] = _memory(count)
        rec.update(cost_record(count))
        rec["n_rep_main_segment"] = _main_seg_reps(cfg)
        t = time.time() - t0
        rec["timings"] = {"prod_compile_s": t, "total_s": t}
        del count
    except Exception as e:  # record the failure — it is a bug to fix
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"  FAILED {arch}/{shape_name}/{mesh_name}: {rec['error']}")
    rec["peak_rss_bytes"] = _peak_rss()
    _save(path, rec)
    if verbose and "error" not in rec:
        print(f"  ok {arch}/{shape_name}/{mesh_name}"
              f" mem={rec['memory']['temp_bytes']/2**30:.1f}GiB"
              f" flops/dev={rec['cost_true']['flops']:.3e}"
              f" coll/dev={rec['cost_true']['collective_bytes']:.3e}"
              f" ({time.time()-t0:.0f}s)")
    return rec


def _save(path, rec):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f, indent=1)
    os.replace(path + ".tmp", path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_NAMES))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) × {single, multi}")
    ap.add_argument("--single-only", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt"])
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCH_NAMES:
            for shape in SHAPES:
                cells.append((arch, shape, False))
                if not args.single_only:
                    cells.append((arch, shape, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells.append((args.arch, args.shape, args.multi_pod))

    print(f"dry-run: {len(cells)} cells, fake ranks 256/512, "
          f"variant={args.variant}")
    for arch, shape, mp in cells:
        run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                 variant=args.variant)
    bad = []
    for arch, shape, mp in cells:
        p = os.path.join(args.out,
                         f"{arch}__{shape}__{'multi' if mp else 'single'}.json")
        with open(p) as f:
            if "error" in json.load(f):
                bad.append(p)
    print(f"done: {len(cells) - len(bad)}/{len(cells)} ok")
    for p in bad:
        print("  FAILED:", p)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
