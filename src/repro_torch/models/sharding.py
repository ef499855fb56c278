"""Logical-axis sharding rules (MaxText-style) for every model family, on
`DeviceMesh` and DTensor.

Counterpart of `repro.models.sharding`, with its names and rules.  Logical
axes:
  batch   activation batch            → (pod, data)
  fsdp    param non-contracting dim   → (pod, data)   (ZeRO-3)
  tensor  heads / mlp / experts / vocab → model
  seq     long-context sequence dim   → data

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a tuple
of names or ``None``, as JAX's ``PartitionSpec`` entries.  `placements`
turns (mesh, spec) into DTensor placements: a dim mapped to ``("pod",
"data")`` is ``Shard(d)`` on both mesh dims, pod-major, as in JAX.
`NamedSharding` pairs a mesh with a spec, as JAX's does; `place` puts a
tree of tensors onto the mesh by a tree of them (each rank keeps its own
slice, no communication).

`set_mesh(mesh)` installs a process-global mesh and rule map; model code
calls ``constrain(x, ("batch", None, None))``, which redistributes a
DTensor to the sanitized spec and returns a plain tensor unchanged, so the
same model code runs with and without a mesh.  The spec functions take a
`DeviceMesh` or any mesh with axis names and sizes (`AbstractMesh`), so
production layouts can be computed without their devices.

The model runs on DTensor parameters under `implicit_replication`
(`sharded_region`, entered by `transformer.forward` and the step
builders): the plain tensors built inside the model (positions, RoPE
tables, masks, zero states, an engine's plain cache) act as replicated
DTensors, where building each of them as a DTensor would touch every
module.  A plain cache or state written from a DTensor takes its full
value, and a DTensor cache is written shard by shard (`write_rows`,
`assign`): DTensor's own in-place writes through a slice of a sharded dim
land on a copy.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication, \
    local_map

from repro_torch.core.logquant import QuantizedTensor

_STATE = {"mesh": None, "rules": None, "depth": 0}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh without its devices (JAX's
    ``AbstractMesh``), for the spec functions."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def mesh_dim_names(self) -> tuple:
        return self.axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, an `AbstractMesh` or any
    object whose ``shape`` is such a dict."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def default_rules(mesh) -> dict:
    axes = tuple(mesh_shape(mesh))
    dp = tuple(a for a in axes if a in ("pod", "data"))
    return {"batch": dp if dp else None,
            "fsdp": dp if dp else None,
            "tensor": "model" if "model" in axes else None,
            "seq": "data" if "data" in axes else None,
            # sequence parallelism over the *model* axis (§Perf seq_tp):
            "tp_seq": "model" if "model" in axes else None,
            None: None}


def set_mesh(mesh, rules: dict | None = None):
    _STATE["mesh"] = mesh
    _STATE["rules"] = (rules or (default_rules(mesh) if mesh else None))


def get_mesh():
    return _STATE["mesh"]


def _canon(entry):
    """A one-name tuple entry is the name, as ``PartitionSpec`` keeps it."""
    if isinstance(entry, (tuple, list)) and len(entry) == 1:
        return entry[0]
    return entry


def logical_to_spec(axes: tuple | None) -> tuple:
    if axes is None:
        return ()
    rules = _STATE["rules"]
    return tuple(_canon(rules.get(a)) for a in axes)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(entry, (tuple, list)):
        n = 1
        for e in entry:
            n *= shape[e]
        return n
    return shape[entry]


def sanitize_spec(mesh, spec: tuple, shape) -> tuple:
    """Drop spec entries whose mesh-axis product does not divide the dim
    (granite's vocab 49155, a decode batch of 1): replication is always
    legal.  A spec shorter than the rank is padded with ``None``."""
    ents = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(e if d % _axis_size(mesh, e) == 0 else None
                 for e, d in zip(ents, shape))


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements, one per mesh dim, of a spec: ``Shard(d)`` on
    every mesh axis that the spec maps tensor dim ``d`` to, ``Replicate()``
    on the others.  A tuple entry is sharded major-to-minor in mesh order
    (pod-major), as JAX shards it; another order raises."""
    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        if e is None:
            continue
        group = tuple(e) if isinstance(e, (tuple, list)) else (e,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e!r} is not in mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{spec!r}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (JAX's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


# ---------------------------------------------------------------------------
# in-model helpers
# ---------------------------------------------------------------------------


def is_sharded(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


@contextlib.contextmanager
def sharded_region():
    """`implicit_replication` while a mesh is installed (plain tensors meet
    DTensors as replicated ones), else a no-op.  Reentrant: an inner region
    leaves the outer one's replication on (`implicit_replication` itself
    turns it off on exit)."""
    if _STATE["mesh"] is None or _STATE["depth"]:
        yield
        return
    _STATE["depth"] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _STATE["depth"] -= 1


def channelwise(fn, x):
    """``fn(x)`` for a map whose statistics run over every dim but the last
    (per-channel log quantization).  On a DTensor it runs on each rank's
    shard with every other dim gathered (a 0-d or 1-D tensor, whose scale
    is global, gathered whole): DTensor's own dispatch of the quantizer's
    integer ops gets the sign bit wrong."""
    if not isinstance(x, DTensor):
        return fn(x)
    keep = Shard(x.ndim - 1) if x.ndim >= 2 else None
    pl = [p if p == keep else Replicate() for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     redistribute_inputs=True)(x)


def constrain(x, axes: tuple | None):
    """Redistribute a DTensor to the sanitized spec of ``axes``; a plain
    tensor, or any tensor while no mesh is installed, is returned as is."""
    mesh = _STATE["mesh"]
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = sanitize_spec(mesh, logical_to_spec(axes), x.shape)
    want = placements(x.device_mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def split_heads(x, n: int, d: int):
    """``x`` [..., n·d] viewed as [..., n, d].  On a DTensor whose last dim
    is sharded over mesh dims whose product does not divide ``n`` (8 heads
    on a 16-way ``model`` axis), that dim is first gathered, the rule of
    `sanitize_spec`: DTensor cannot split ``n`` unevenly, where XLA's
    partitioner shards it unevenly (ROADMAP.md C).  The view runs on each
    rank's shard (`local_map`), a split of the last dim then a split of
    the heads, so that the backward pass, too, meets no uneven view."""
    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-1], n, d)
    last = x.ndim - 1
    dims = [i for i, p in enumerate(x.placements) if p == Shard(last)]
    ways = 1
    for i in dims:
        ways *= x.device_mesh.size(i)
    pl = [Replicate() if (i in dims and n % ways) else p
          for i, p in enumerate(x.placements)]
    return local_map(lambda t: t.reshape(*t.shape[:-1], -1, d),
                     out_placements=pl, in_placements=(pl,),
                     redistribute_inputs=True)(x)


def merge_heads(x):
    """``x`` [..., n, d] viewed as [..., n·d], the inverse of
    `split_heads`: on a DTensor, on each rank's shard, the heads' split (if
    any) becoming the last dim's and a split of ``d`` gathered first."""
    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-2], -1)
    pl = [Replicate() if p == Shard(x.ndim - 1) else p for p in x.placements]
    return local_map(lambda t: t.reshape(*t.shape[:-2], -1),
                     out_placements=pl, in_placements=(pl,),
                     redistribute_inputs=True)(x)


def replicated(t, mesh):
    """A plain tensor as a replicated DTensor on ``mesh`` (no copy); a
    DTensor as is."""
    if isinstance(t, DTensor) or not torch.is_tensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def full(t):
    """The whole value of a DTensor (gathered), a plain tensor as is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def assign(dst, src):
    """``dst.copy_(src)`` in place.  A DTensor ``dst`` keeps its placements
    and each rank writes its own shard; a plain ``dst`` takes the full
    value of a DTensor ``src``."""
    if not isinstance(dst, DTensor):
        return dst.copy_(full(src))
    src = replicated(src, dst.device_mesh).redistribute(dst.device_mesh,
                                                        dst.placements)
    dst.to_local().copy_(src.to_local())
    return dst


def write_rows(dst, rows, cols, src):
    """``dst[rows, cols] = src`` in place (rows, cols: int tensors of one
    shape indexing dims 0 and 1; src: that shape + dst.shape[2:]).  A
    DTensor ``dst`` is written shard by shard: each rank writes the
    elements that fall in its slice."""
    if not isinstance(dst, DTensor):
        dst[rows, cols] = full(src).to(dst.dtype)
        return dst
    local = dst.to_local()
    shape, off = compute_local_shape_and_global_offset(
        dst.shape, dst.device_mesh, dst.placements)
    tail = tuple(slice(o, o + n) for o, n in zip(off[2:], shape[2:]))
    src = full(src).to(dst.dtype)[(Ellipsis,) + tail]
    if tuple(shape[:2]) == tuple(dst.shape[:2]):
        local[rows, cols] = src  # dims 0 and 1 whole on every rank
        return dst
    # the elements of this rank's slice, by index arithmetic alone (no
    # mask index, which syncs the host and has no meta kernel): an element
    # outside the slice writes the value of the first element inside it to
    # that element's place, the same value twice in any order, or, with
    # none inside, the value already at [0, 0] back to [0, 0]
    lr, lc = rows - off[0], cols - off[1]
    keep = (lr >= 0) & (lr < shape[0]) & (lc >= 0) & (lc < shape[1])
    first = keep.reshape(-1).to(torch.int32).argmax().reshape(1)
    inside = keep.any()
    flat = src.reshape(keep.numel(), *src.shape[keep.ndim:])
    r0 = torch.where(inside, lr.reshape(-1)[first], 0)
    c0 = torch.where(inside, lc.reshape(-1)[first], 0)
    v0 = torch.where(inside, flat[first], local[0, 0])
    vals = torch.where(keep.reshape(keep.shape + (1,) * (src.ndim - keep.ndim)),
                       src, v0)
    local[torch.where(keep, lr, r0), torch.where(keep, lc, c0)] = vals
    return dst


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts (a spec, a tuple, is a
    leaf); a `QuantizedTensor` is a node whose codes and scale are leaves
    (as it is a pytree node in the JAX package)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(path, tree.packed), fn(path, tree.scale),
                               tree.cfg, tree.shape, tree.layout,
                               tree.layout_meta)
    return fn(path, tree)


def tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.packed, other.packed),
                               fn(tree.scale, other.scale), tree.cfg,
                               tree.shape, tree.layout, tree.layout_meta)
    return fn(tree, other)


def _leaf_name(path):
    return path[-1] if path else None


# ---------------------------------------------------------------------------
# parameter rules — keyed by leaf name (canonical [in, out] layouts)
# ---------------------------------------------------------------------------

F, T = "fsdp", "tensor"

PARAM_AXES = {
    # attention
    "wq": (F, T), "wk": (F, T), "wv": (F, T), "wo": (T, F),
    "bq": (T,), "bk": (T,), "bv": (T,),
    # dense FFN
    "w1": (F, T), "w3": (F, T), "w2": (T, F),
    # MoE (experts on tensor: expert parallelism)
    "router": (F, None),
    "moe_w1": (T, F, None), "moe_w3": (T, F, None), "moe_w2": (T, None, F),
    # embeddings
    "table": (T, F), "lm_head": (F, T),
    # rwkv
    "wg": (F, T), "wr": (F, T),
    "ck": (F, T), "cv": (T, F), "cr": (F, T),
    "wA": (F, None), "wB": (None, F), "u": (T, None),
    # griffin
    "w_gate": (F, T), "w_x": (F, T), "conv_w": (None, T), "conv_b": (T,),
    "w_r": (T, None), "w_i": (T, None), "lam": (T,), "w_out": (T, F),
}


def _leaf_axes(path, leaf) -> tuple | None:
    """The logical axes of a leaf, from its name.  A packed leaf's codes
    and scale both take their weight's axes (the scale's size-1 reduction
    dim then replicates in `sanitize_spec`), so B2 runs on each rank's
    shard; JAX's path walk names a packed child by its index and so
    replicates it."""
    axes = PARAM_AXES.get(_leaf_name(path))
    if axes is None:
        return None  # replicate (norm scales, mus, w0, ln_x, …)
    extra = leaf.ndim - len(axes)
    if extra > 0:  # stacked layer groups prepend layer dims
        axes = (None,) * extra + tuple(axes)
    elif extra < 0:
        return None
    return axes


def param_specs(params):
    """Tree of specs matching ``params`` (meta tensors work)."""
    return tree_map_with_path(
        lambda p, x: logical_to_spec(_leaf_axes(p, x)), params)


def param_shardings(mesh, params):
    return tree_map_with_path(
        lambda p, x: NamedSharding(
            mesh, sanitize_spec(mesh, logical_to_spec(_leaf_axes(p, x)),
                                x.shape)),
        params)


# ---------------------------------------------------------------------------
# cache / activation rules
# ---------------------------------------------------------------------------


def cache_axes(path, leaf, batch: int, dp_size: int) -> tuple | None:
    """KV caches: shard batch when divisible, else shard long seq dims."""
    name = _leaf_name(path)
    if name == "index" or getattr(leaf, "ndim", 0) <= 1:
        return None
    shard_batch = batch % max(dp_size, 1) == 0 and batch >= dp_size
    if name in ("k", "v"):           # [n_rep, B, S, Hkv, hd]
        if shard_batch:
            return (None, "batch", None, None, None)
        return (None, None, "seq", None, None)
    if name == "wkv":                # [n_rep, B, H, K, V]
        return (None, "batch", "tensor", None, None) if shard_batch \
            else (None, None, "tensor", None, None)
    if name == "h":                  # [n_rep, B, W]
        return (None, "batch", "tensor") if shard_batch \
            else (None, None, "tensor")
    if name == "conv":               # [n_rep, B, K-1, W]
        return (None, "batch", None, "tensor") if shard_batch \
            else (None, None, None, "tensor")
    if name in ("x_prev_t", "x_prev_c"):  # [n_rep, B, D]
        return (None, "batch", None) if shard_batch else None
    return None


def cache_specs(cache, batch: int, dp_size: int):
    return tree_map_with_path(
        lambda p, x: logical_to_spec(cache_axes(p, x, batch, dp_size)),
        cache)


# ---------------------------------------------------------------------------
# placing real tensors
# ---------------------------------------------------------------------------


def place(tree, shardings):
    """Each tensor of ``tree`` as a DTensor laid out by its
    `NamedSharding` in ``shardings`` (a tree of the same structure): every
    rank keeps its own slice of the full tensor it holds, with no
    communication.  Leaves that are not tensors (a cache's int index) stay
    as they are."""
    def leaf(x, sh):
        if not torch.is_tensor(x) or isinstance(x, DTensor):
            return x
        return distribute_tensor(x, sh.mesh, list(sh.placements),
                                 src_data_rank=None)
    return tree_map2(leaf, tree, shardings)


def zeros(tree, shardings, device):
    """A DTensor of zeros for each tensor of ``tree`` (abstract leaves: only
    their shapes and dtypes are read), laid out by its `NamedSharding` in
    ``shardings``: each rank allocates its own shard on ``device`` and no
    more, where `place` would slice a global tensor that every rank holds.
    Leaves that are not tensors stay as they are."""
    def leaf(x, sh):
        if not torch.is_tensor(x):
            return x
        shape, _ = compute_local_shape_and_global_offset(
            tuple(x.shape), sh.mesh, list(sh.placements))
        local = torch.zeros(shape, dtype=x.dtype, device=device)
        stride = [1] * len(x.shape)
        for d in range(len(stride) - 2, -1, -1):
            stride[d] = stride[d + 1] * x.shape[d + 1]
        return DTensor.from_local(local, sh.mesh, list(sh.placements),
                                  run_check=False, shape=x.shape,
                                  stride=tuple(stride))
    return tree_map2(leaf, tree, shardings)


def local_slice(global_shape, sharding: NamedSharding) -> tuple:
    """The index (a tuple of slices) of this rank's shard of a tensor of
    ``global_shape`` laid out by ``sharding``."""
    shape, off = compute_local_shape_and_global_offset(
        tuple(global_shape), sharding.mesh, list(sharding.placements))
    return tuple(slice(o, o + n) for o, n in zip(off, shape))
