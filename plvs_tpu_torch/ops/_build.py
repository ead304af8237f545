"""Build the CUDA sources under ``plvs_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is a file with a plain C interface (no PyTorch
headers; it may include the shared ``csrc/*.cuh`` device helpers),
compiled by ``nvcc`` for sm_90a into its own shared library under
``plvs_tpu_torch/_build/`` and loaded with ctypes. The library's file name
carries a hash of the source and the headers, so an edited source is
rebuilt and a stale library is never loaded. ``build_all`` starts one nvcc
per source at once and waits for all of them.

Nothing is built at import time: the first ``load(name)`` (or an explicit
``build_all()``) compiles, on the machine with the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of plvs_tpu_torch cannot be built")


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header it may include
    for f in [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                     if f.endswith(".cuh")):
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (proc, tmp, out) or None when the
    library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names: list[str] | None = None) -> None:
    """Compile every source (one nvcc each, all started together)."""
    names = sources() if names is None else names
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
