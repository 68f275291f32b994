"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use (or ahead of time with :func:`build_all`, which
runs one ``nvcc`` per source in parallel) into ``_kernels/`` inside the
package directory (listed in ``.gitignore``). Libraries are keyed by a hash
of their source and of the headers in ``csrc/`` (``*.cuh``, shared device
code), so an edited kernel is rebuilt and a stale one never loaded. A
build writes a temporary file named after its process and renames it into
place, and builds in one process take turns, so two builds of one library
never write one file, and a partial file left by a killed build is never
loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
KERNELS = ("sweep_fwd", "render_frame", "sweep_bwd", "train_fused_fwd",
           "train_fused_bwd", "tv_add_grad", "probe_ops")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS = {}


def build_dir():
    d = os.path.join(_PKG, "_kernels")
    os.makedirs(d, exist_ok=True)
    return d


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "on a machine with the CUDA toolkit")


def _lib_path(name):
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name):
    """Start nvcc for ``name`` unless its library exists; returns
    (path, process or None, tmp path)."""
    path = _lib_path(name)
    if os.path.isfile(path):
        return path, None, None
    tmp = f"{path[:-3]}.{os.getpid()}.tmp.so"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return path, proc, tmp


def _finish(name, path, proc, tmp):
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        with contextlib.suppress(FileNotFoundError):  # a failed link unlinks
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, path)
    return out


def build_all(names=KERNELS):
    """Compile every kernel source in parallel; returns {name: nvcc log}.
    Every build started is waited for before a failure is raised."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        logs, failed = {}, []
        for n in names:
            try:
                logs[n] = _finish(n, *started[n])
            except RuntimeError as e:
                failed.append(str(e))
        if failed:
            raise RuntimeError("\n".join(failed))
        return logs


def load(name):
    """ctypes handle of kernel library ``name`` (built on first use)."""
    with _LOCK:
        if name not in _LIBS:
            path, proc, tmp = _start(name)
            _finish(name, path, proc, tmp)
            _LIBS[name] = ctypes.CDLL(path)
        return _LIBS[name]
