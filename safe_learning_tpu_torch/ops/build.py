"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled with ``nvcc`` from the sources under ``csrc/``
into ``safe_learning_tpu_torch/_build/`` and loaded with ``ctypes``. The
file name carries a hash of the sources and the flags, so a changed
source or flag builds a new library and a stale one is never loaded.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "CSRC_DIR", "load_library"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: No fast-math: the kernels call the library expf/exp.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Per library name: seconds the build took in this process (0.0 when a
#: cached library was loaded) and the compiler's report.
build_reports = {}


def _nvcc():
    """Path of ``nvcc``: on ``PATH``, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found (PATH and CUDA_HOME); the CUDA "
                       "kernels are built on a machine with the CUDA "
                       "toolkit")


def _digest(sources):
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def load_library(name, sources):
    """Build (if needed) and load ``lib<name>-<hash>.so`` from ``sources``.

    ``sources`` are file names under ``csrc/``. Returns the
    ``ctypes.CDLL``. The build writes to a temporary file and renames it
    into place, so concurrent builds never load a partial library.
    """
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    target = os.path.join(BUILD_DIR, "lib{}-{}.so".format(name,
                                                          _digest(paths)))
    if os.path.exists(target):
        build_reports[name] = (0.0, "cached " + target)
        return ctypes.CDLL(target)
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}\n{}".format(
                " ".join(cmd), proc.stdout, proc.stderr))
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_reports[name] = (time.perf_counter() - start,
                           " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    return ctypes.CDLL(target)
