"""Host C++ components of the port, built at first use and loaded with ctypes.

Counterpart of ``safe_learning_tpu/native/__init__.py``, with a copy of its
source (``flood_fill.cpp``): the flood fill of
:func:`~safe_learning_tpu_torch.lyapunov.get_lyapunov_region` is a heap
walk, sequential by nature, so it runs on the host. The library is
compiled with ``g++ -O3`` into ``safe_learning_tpu_torch/_build/`` under a
name that carries a hash of the source, so a changed source never loads a
stale library. Nothing is built when the module is imported; when no
compiler is found, :func:`flood_fill` returns ``None`` and the caller
takes its Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from ..ops.build import BUILD_DIR

__all__ = ["load_flood_fill", "flood_fill"]

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "flood_fill.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB = None
_BUILD_FAILED = False


def _library_path():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        "libfloodfill-{}.so".format(h.hexdigest()[:16]))


def _build(target):
    """Compile the source into ``target`` through a temporary file renamed
    into place, so a concurrent build never loads a partial library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, _SOURCE, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_flood_fill():
    """The native flood fill's entry point, or ``None`` when it cannot be
    built."""
    global _LIB, _BUILD_FAILED
    if _LIB is not None:
        return _LIB.lyapunov_flood_fill
    if _BUILD_FAILED:
        return None
    target = _library_path()
    try:
        if not os.path.exists(target):
            _build(target)
        lib = ctypes.CDLL(target)
    except (OSError, subprocess.CalledProcessError):
        _BUILD_FAILED = True
        return None
    lib.lyapunov_flood_fill.restype = ctypes.c_int
    lib.lyapunov_flood_fill.argtypes = [
        ctypes.POINTER(ctypes.c_double),   # values
        ctypes.POINTER(ctypes.c_int64),    # shape
        ctypes.c_int,                      # ndim
        ctypes.c_int64,                    # init flat index
        ctypes.POINTER(ctypes.c_uint8),    # visited out
    ]
    _LIB = lib
    return lib.lyapunov_flood_fill


def flood_fill(values, shape, init_index):
    """Run the native flood fill; returns the visited mask of ``shape``,
    or ``None`` when the library cannot be built or refuses the input.

    Parameters
    ----------
    values : array of the grid's values, C order (any shape of
        ``nindex`` elements; taken in float64)
    shape : tuple of ints
    init_index : int, flat index of the seed node
    """
    fn = load_flood_fill()
    if fn is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.float64).ravel()
    shape_arr = np.asarray(shape, dtype=np.int64)
    visited = np.zeros(values.size, dtype=np.uint8)
    status = fn(values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                shape_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                int(len(shape_arr)), int(init_index),
                visited.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if status != 0:
        return None
    return visited.astype(bool).reshape(tuple(shape))
