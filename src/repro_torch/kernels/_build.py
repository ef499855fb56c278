"""Build the CUDA sources under `csrc/` and load them with ctypes.

Each source is compiled at first use by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The library goes into `build/` beside this file (listed in `.gitignore`),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  `build()` starts one ``nvcc`` per
source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("log_conv2d", "log_matmul", "flash_attention",
                        "wkv6", "log_requant")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad.

    Every kernel wrapper calls this first, on every device: a kernel writes
    a ``torch.empty`` output through ctypes, which carries no ``grad_fn``,
    so a loss through it would train nothing upstream and raise nothing.
    Training reaches the plain versions by choosing them (``impl=``)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            f"inputs that do not require grad, or pick a plain version "
            f"(impl='blockwise') to differentiate")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then /usr/local/cuda, then
    ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built at first use and need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile every named source whose library is missing, all in parallel.

    Returns ``{name: {"seconds": wall time, "log": compiler stderr}}`` for
    the sources it compiled (``-Xptxas -v`` puts each kernel's registers and
    shared memory there).  Raises if any compile fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (tmp, time.perf_counter(),
                    subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))
    out, failed = {}, []
    for n, (tmp, t0, p) in procs.items():
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            failed.append(f"{SOURCES[n].name}:\n{stdout}{stderr}")
            continue
        os.replace(tmp, library_path(n))
        out[n] = {"seconds": time.perf_counter() - t0, "log": stderr}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, built first if missing."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return _LIBS[name]
