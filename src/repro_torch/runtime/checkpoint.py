"""Async, atomic checkpoints of train states, in the JAX package's format.

Counterpart of `repro.runtime.checkpoint`, with its on-disk format, so a
checkpoint written by either package restores in the other:

    step_000123/
      manifest.json      {"step", "leaves": {path: {shape, dtype, shards}}}
      <path>.shard_i_of_n.npy     one file per (leaf, shard)

A leaf's path joins its dict keys with ``/`` (``__`` in file names); a leaf
of more than 64 MiB is split into up to 16 shards of its flattened values
(`_shard_count`); a bfloat16 leaf is stored bit-cast as ``u2`` with
``"bfloat16"`` in the manifest.  Writes are atomic (a ``.tmp`` directory,
then a rename), `CheckpointManager.save` is async (the host snapshot is
taken on the caller's thread, the files are written on another), and
``keep`` rotation bounds the disk.  Restore builds tensors of the
template's dtypes on the template's device (or ``device=``).

Restore *reshards*: the manifest stores the logical array, not the mesh,
so ``shardings=`` (a tree of `models.sharding.NamedSharding`, the new
layout) restores a checkpoint written under any mesh, or by the JAX
package, onto the current one.  Each rank reads only its own slice of each
leaf (memory-mapped; from the flattened shard files only the elements it
holds) and wraps it with ``DTensor.from_local``: no rank reads a whole
leaf, and no data crosses ranks.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models import sharding as _sharding


# ------------------------------------------------------------------ pytree io
def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} over nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten_into(template, flat: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return flat[prefix]


def _host(leaf) -> torch.Tensor:
    """A CPU copy of a leaf (a tensor, numpy array or number) that later
    in-place updates of the leaf cannot reach; a DTensor's whole value
    (gathered: every rank must call it)."""
    if torch.is_tensor(leaf):
        return _sharding.full(leaf.detach()).to("cpu", copy=True)
    return torch.as_tensor(np.array(leaf))


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """→ (array to store, manifest dtype): bf16 bit-cast to u2."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
            "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _read_slice(path: str, fname: str, meta: dict, idx: tuple) -> np.ndarray:
    """The elements ``idx`` (a tuple of slices) of a stored leaf, reading
    only those: a single file is memory-mapped and sliced; a leaf split
    into flattened shard files is gathered from each shard's mapping by
    flat index."""
    n, shape = meta["shards"], tuple(meta["shape"])
    if n == 1:
        arr = np.load(os.path.join(path, f"{fname}.shard_0_of_1.npy"),
                      mmap_mode="r")
        return np.array(arr[idx])
    flat = np.ravel_multi_index(
        np.ix_(*(np.arange(s.start, s.stop) for s in idx)), shape)
    out, lo = None, 0
    for i in range(n):
        piece = np.load(os.path.join(path, f"{fname}.shard_{i}_of_{n}.npy"),
                        mmap_mode="r")
        if out is None:
            out = np.empty(flat.shape, piece.dtype)
        hit = (flat >= lo) & (flat < lo + piece.shape[0])
        out[hit] = piece[flat[hit] - lo]
        lo += piece.shape[0]
    return out


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(
            arr.astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype))


# ------------------------------------------------------------------ save
def _shard_count(nbytes: int) -> int:
    """Split big leaves across several files (parallel IO, resumable)."""
    return max(1, min(16, nbytes // (64 << 20)))


def save_checkpoint(directory: str, step: int, state, *, sync: bool = True):
    """Write `state` (a tree of tensors, numpy arrays or numbers) at
    `step`.  Returns the final path."""
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for key, leaf in _flatten(state).items():
        arr, dtype = _to_numpy(_sharding.full(leaf.detach()).cpu()
                               if torch.is_tensor(leaf) else _host(leaf))
        n = _shard_count(arr.size * arr.dtype.itemsize)
        manifest["leaves"][key] = {
            "shape": list(arr.shape), "dtype": dtype, "shards": n}
        fname = key.replace("/", "__")
        if n == 1:
            np.save(os.path.join(tmp, f"{fname}.shard_0_of_1.npy"), arr)
        else:
            for i, piece in enumerate(np.array_split(arr.reshape(-1), n)):
                np.save(os.path.join(tmp, f"{fname}.shard_{i}_of_{n}.npy"),
                        piece)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


# ------------------------------------------------------------------ load
def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint(directory: str, template, *, step: int | None = None,
                    shardings=None, device=None):
    """Restore into the structure of `template` (a tree of tensors, ``meta``
    ones included).  Each leaf takes its template's dtype (cast where the
    checkpoint's differs) and lands on ``device``, by default the
    template leaf's (a ``meta`` template needs ``device``).  A template may
    hold a subset of the checkpoint's leaves.  ``shardings``: an optional
    tree of `models.sharding.NamedSharding`; a leaf that has one becomes a
    DTensor laid out by it, built from this rank's slice only, on
    ``device`` (default: the mesh's device type).  Returns (state, step)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    flat_tpl = _flatten(template)
    flat_shard = _flatten(shardings) if shardings is not None else {}
    flat = {}
    for key, meta in manifest["leaves"].items():
        if key not in flat_tpl:
            continue  # allow template subsets (e.g. params-only restore)
        n = meta["shards"]
        fname = key.replace("/", "__")
        tpl, sh = flat_tpl[key], flat_shard.get(key)
        if tuple(meta["shape"]) != tuple(tpl.shape):
            raise ValueError(f"{key}: ckpt shape {tuple(meta['shape'])} != "
                             f"template {tuple(tpl.shape)}")
        if sh is not None:
            local = _from_numpy(_read_slice(
                path, fname, meta,
                _sharding.local_slice(tpl.shape, sh)), meta["dtype"])
            dev = device if device is not None else sh.mesh.device_type
            flat[key] = DTensor.from_local(
                local.to(device=dev, dtype=tpl.dtype), sh.mesh,
                list(sh.placements), run_check=False,
                shape=tuple(tpl.shape),
                stride=torch.empty(tuple(tpl.shape), device="meta").stride())
            continue
        if n == 1:
            arr = np.load(os.path.join(path, f"{fname}.shard_0_of_1.npy"))
        else:
            parts = [np.load(os.path.join(
                path, f"{fname}.shard_{i}_of_{n}.npy")) for i in range(n)]
            arr = np.concatenate(parts).reshape(meta["shape"])
        t = _from_numpy(arr, meta["dtype"])
        flat[key] = t.to(device=device if device is not None
                         else tpl.device, dtype=tpl.dtype)
    for key in flat_tpl:
        if key not in flat:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
    return _unflatten_into(template, flat), manifest["step"]


# ------------------------------------------------------------------ manager
class CheckpointManager:
    """Async save + rotation.  `save()` returns once the host snapshot is
    taken; the previous async save is joined first (never two writers).
    In a process group every rank takes the snapshot (a DTensor leaf is
    gathered) and rank 0 writes it."""

    def __init__(self, directory: str, *, keep: int = 3, every: int = 0):
        self.directory = directory
        self.keep = keep
        self.every = every
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _rotate(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, state, *, sync: bool = False):
        self.wait()
        # copy to the host on the caller thread (consistent snapshot: the
        # train step updates the state's tensors in place), IO async
        host_state = _unflatten_into(
            state, {k: _host(v) for k, v in _flatten(state).items()})
        if dist.is_initialized() and dist.get_rank() != 0:
            return  # every rank gathered; rank 0 writes

        def work():
            save_checkpoint(self.directory, step, host_state)
            self._rotate()

        if sync:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def hook(self, every: int | None = None):
        """A train-loop hook: saves whenever step % every == 0."""
        every = every or self.every or 100

        def _hook(step, state, metrics):
            if step and step % every == 0:
                self.save(step, state)
        return _hook

    def restore(self, template, *, shardings=None, step=None, device=None):
        self.wait()
        return load_checkpoint(self.directory, template, step=step,
                               shardings=shardings, device=device)

    def latest_step(self):
        return latest_step(self.directory)
