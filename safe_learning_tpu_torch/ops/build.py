"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled with ``nvcc`` into
``safe_learning_tpu_torch/_build/`` and loaded with ``ctypes``. A library
is either a list of files under ``csrc/`` or a source text rendered at run
time (a covariance program, ``ops/gp_kernel.py``) that includes headers
from ``csrc/``. The file name carries a hash of every source, header and
flag, so a change builds a new library and a stale one is never loaded.
Several libraries build at once, one ``nvcc`` process each. Nothing is
built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "CSRC_DIR", "load_libraries",
           "build_reports"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: No fast-math: the kernels call the library expf/exp.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Per library name: seconds from the start of its build (all builds of
#: one call start together) to its end in this process (0.0 when a built
#: library was loaded), and the compiler's report.
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


def _prepare(name, sources, text, csrc):
    """``(target library, files to compile, include directory)`` of one
    job.

    ``sources`` are file names under ``csrc`` (``None``: ``csrc/``), which
    is also the include path; the ``.cu`` files among them are compiled,
    and all of them are hashed. A ``text`` is written to ``_build/`` and
    compiled with the sources as its headers.
    """
    csrc = csrc or CSRC_DIR
    paths = [os.path.join(csrc, s) for s in sources]
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    if text is not None:
        h.update(text.encode())
    digest = h.hexdigest()[:16]
    target = os.path.join(BUILD_DIR, "lib{}-{}.so".format(name, digest))
    if text is None:
        return target, [p for p in paths if p.endswith(".cu")], csrc
    src = os.path.join(BUILD_DIR, "{}-{}.cu".format(name, digest))
    if not os.path.exists(src):
        fd, tmp = tempfile.mkstemp(suffix=".cu", dir=BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, src)
    return target, [src], csrc


def load_libraries(jobs):
    """Build (where needed) and load one library per job.

    ``jobs`` are ``(name, sources, text, csrc)``: see :func:`_prepare`.
    Every missing library starts building at once, one ``nvcc`` each; each
    writes to a temporary file renamed into place, so concurrent builds
    never load a partial library. Returns the ``ctypes.CDLL`` of each job,
    in order. Raises if any build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    prepared = [_prepare(*job) for job in jobs]
    running = []
    try:
        for (name, _, _, _), (target, srcs, include) in zip(jobs, prepared):
            if os.path.exists(target):
                # A library built earlier in this process keeps its report.
                build_reports.setdefault(name, (0.0, "cached " + target))
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", include, "-o", tmp, *srcs]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            running.append((name, target, tmp, cmd, proc,
                            time.perf_counter()))
        failures = []
        for name, target, tmp, cmd, proc, start in running:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failures.append("nvcc failed ({}):\n{}\n{}".format(
                    " ".join(cmd), out, err))
                continue
            os.replace(tmp, target)
            build_reports[name] = (time.perf_counter() - start,
                                   " ".join(cmd) + "\n" + out + err)
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _, _, tmp, _, proc, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return [ctypes.CDLL(target) for target, _, _ in prepared]

