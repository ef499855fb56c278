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
template's dtypes on the template's device (or ``device=``).  Resharding
onto a new mesh (``shardings=``) belongs to the multi-device part of the
port (ROADMAP.md queue A, item 17).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _no_shardings(shardings) -> None:
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto a sharded layout (shardings=) is the multi-device "
            "part of the port, ROADMAP.md queue A, item 17")


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
    in-place updates of the leaf cannot reach."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return torch.as_tensor(np.array(leaf))


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """→ (array to store, manifest dtype): bf16 bit-cast to u2."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
            "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


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
        arr, dtype = _to_numpy(leaf.detach().cpu() if torch.is_tensor(leaf)
                               else _host(leaf))
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
    hold a subset of the checkpoint's leaves.  Returns (state, step)."""
    _no_shardings(shardings)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    flat_tpl = _flatten(template)
    flat = {}
    for key, meta in manifest["leaves"].items():
        if key not in flat_tpl:
            continue  # allow template subsets (e.g. params-only restore)
        n = meta["shards"]
        fname = key.replace("/", "__")
        if n == 1:
            arr = np.load(os.path.join(path, f"{fname}.shard_0_of_1.npy"))
        else:
            parts = [np.load(os.path.join(
                path, f"{fname}.shard_{i}_of_{n}.npy")) for i in range(n)]
            arr = np.concatenate(parts).reshape(meta["shape"])
        t = _from_numpy(arr, meta["dtype"])
        tpl = flat_tpl[key]
        if tuple(t.shape) != tuple(tpl.shape):
            raise ValueError(f"{key}: ckpt shape {tuple(t.shape)} != "
                             f"template {tuple(tpl.shape)}")
        flat[key] = t.to(device=device if device is not None
                         else tpl.device, dtype=tpl.dtype)
    for key in flat_tpl:
        if key not in flat:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
    return _unflatten_into(template, flat), manifest["step"]


# ------------------------------------------------------------------ manager
class CheckpointManager:
    """Async save + rotation.  `save()` returns once the host snapshot is
    taken; the previous async save is joined first (never two writers)."""

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
