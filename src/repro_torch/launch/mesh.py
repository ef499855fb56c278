"""Mesh construction (counterpart of `repro.launch.mesh`).

Defined as FUNCTIONS (never module-level constants), so importing this
module touches no process group.  Each builds a `DeviceMesh` over the
initialised default group (`init_process_group`), on the device type of
the caller's explicit device: NCCL ranks on the card, gloo ranks on the
CPU.  `init_process_group` starts that group from the device: torchrun's
environment when present, else a one-rank group on a file store.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device) -> str:
    if device is None:
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    return torch.device(device).type


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16×16 ``("data", "model")``, or 2×16×16 ``("pod", "data",
    "model")`` with ``multi_pod``.  Raises on a world of another size,
    naming the size it needs; it never falls back to the host mesh."""
    shape, axes = PRODUCTION[multi_pod]
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a world "
            f"of {need} ranks; this one has {world}")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: tuple, axes: tuple, *, device=None):
    """Arbitrary mesh (elastic restarts onto shrunken worlds)."""
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(*, device=None):
    """(1, world) ``("data", "model")`` over the ranks that exist: 1×1 on a
    one-card machine."""
    return make_mesh((1, dist.get_world_size()), ("data", "model"),
                     device=device)


@contextlib.contextmanager
def process_group(device):
    """The default process group for ``device`` (a `torch.device`): NCCL
    for ``cuda``, gloo for ``cpu``; from torchrun's environment
    (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``) when present, else one rank
    on a file store in a temporary directory.  A group that is already up
    is used as is; one started here is destroyed on exit.  On the card
    each rank takes its GPU (torchrun's ``LOCAL_RANK``, else the device's
    own) before NCCL starts."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    tmp = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
