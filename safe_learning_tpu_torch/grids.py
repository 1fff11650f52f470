"""Regular-grid state-space discretizations.

Counterpart of ``safe_learning_tpu/grids.py``. The grid's metadata is
static (tuples of limits and point counts); ``all_points`` is built on the
host with the same numpy code as the JAX package, so the two packages'
grids are bitwise equal. The index maps run in torch on the device of
their input.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import config
from .functions.base import as_tensor

__all__ = ["GridWorld", "DimensionError"]


def row_major_strides(shape):
    """Row-major flat-index strides for ``shape``."""
    return np.concatenate(
        [np.cumprod(np.asarray(shape[1:], dtype=np.int64)[::-1])[::-1],
         [1]])


class DimensionError(Exception):
    """Raised when an input has the wrong dimensionality."""


class GridWorld:
    """A regular rectangular grid over a box domain.

    Parameters
    ----------
    limits : 2d array-like
        A list of limits, e.g. ``[(x_min, x_max), (y_min, y_max)]``.
    num_points : int or 1d array-like
        The number of points per dimension.
    """

    def __init__(self, limits, num_points):
        limits = np.atleast_2d(np.asarray(limits, dtype=np.float64))
        num_points = np.broadcast_to(num_points, len(limits)).astype(int)
        if np.any(num_points < 2):
            raise DimensionError("There must be at least 2 points in each "
                                 "dimension.")
        self._limits = tuple(map(tuple, limits.tolist()))
        self._num_points = tuple(int(n) for n in num_points)
        self._all_points_cache = None

    # -- static metadata ------------------------------------------------
    @property
    def limits(self):
        """Domain limits as an (ndim, 2) numpy array."""
        return np.asarray(self._limits, dtype=config.np_dtype)

    @property
    def num_points(self):
        """Number of grid points per dimension (numpy int array)."""
        return np.asarray(self._num_points, dtype=np.int64)

    @property
    def shape(self):
        """Grid shape as a tuple of ints."""
        return self._num_points

    @property
    def ndim(self):
        """Number of grid dimensions."""
        return len(self._num_points)

    @property
    def nindex(self):
        """Total number of grid vertices."""
        return int(np.prod(self.num_points))

    @property
    def nrectangles(self):
        """Total number of grid cells."""
        return int(np.prod(self.num_points - 1))

    @property
    def offset(self):
        """Lower corner of the domain."""
        return self.limits[:, 0]

    @property
    def unit_maxes(self):
        """Edge lengths of one grid cell per dimension."""
        lim = self.limits
        return ((lim[:, 1] - lim[:, 0])
                / (self.num_points - 1)).astype(config.np_dtype)

    @property
    def discrete_points(self):
        """Per-dimension coordinate vectors."""
        return [np.linspace(low, up, n, dtype=config.np_dtype)
                for (low, up), n in zip(self._limits, self._num_points)]

    def __len__(self):
        """Number of grid vertices."""
        return self.nindex

    def __eq__(self, other):
        """Value equality (same limits and point counts)."""
        return (isinstance(other, GridWorld)
                and self._limits == other._limits
                and self._num_points == other._num_points)

    def __hash__(self):
        """Hash of the static grid metadata."""
        return hash((self._limits, self._num_points))

    def __repr__(self):
        """Debug representation."""
        return "GridWorld(limits={}, num_points={})".format(
            self._limits, self._num_points)

    # -- points ----------------------------------------------------------
    @property
    def all_points(self):
        """All grid vertices, shape ``(nindex, ndim)`` (host numpy array).

        Built lazily with the working dtype of the first access, then
        cached.
        """
        if self._all_points_cache is None:
            mesh = np.meshgrid(*self.discrete_points, indexing="ij")
            self._all_points_cache = np.column_stack(
                [col.ravel() for col in mesh]).astype(config.np_dtype)
        return self._all_points_cache

    @functools.cached_property
    def all_points_f64(self):
        """All grid vertices in float64, independent of ``config.dtype``."""
        axes = [np.linspace(low, up, n, dtype=np.float64)
                for (low, up), n in zip(self._limits, self._num_points)]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.column_stack([col.ravel() for col in mesh])

    def _check_dimensions(self, states):
        if states.shape[-1] != self.ndim:
            raise DimensionError("the input argument has the wrong "
                                 "dimensions.")

    # -- index maps --------------------------------------------------------
    def index_to_state(self, indices):
        """Convert flat vertex indices to states, shape ``(N, ndim)``."""
        indices = torch.atleast_1d(as_tensor(indices, dtype=torch.int64))
        strides = torch.as_tensor(row_major_strides(self.shape),
                                  device=indices.device)
        sizes = torch.as_tensor(self._num_points, device=indices.device)
        ijk = (indices[:, None] // strides) % sizes
        dtype = config.dtype
        unit = torch.as_tensor(self.unit_maxes, dtype=dtype,
                               device=indices.device)
        offset = torch.as_tensor(self.offset, dtype=dtype,
                                 device=indices.device)
        return ijk.to(dtype) * unit + offset

    def _index_constants(self, like):
        """``(limits, unit_maxes, strides)`` as tensors in ``like``'s dtype
        and on its device, copied there once: a copy from the host at
        every call would make the host wait for the device."""
        key = (like.dtype, like.device, config.np_dtype)
        cache = self.__dict__.setdefault("_index_constants_cache", {})
        if key not in cache:
            cache[key] = (
                torch.as_tensor(self.limits, dtype=like.dtype,
                                device=like.device),
                torch.as_tensor(self.unit_maxes, dtype=like.dtype,
                                device=like.device),
                torch.as_tensor(row_major_strides(self.shape),
                                device=like.device))
        return cache[key]

    def state_to_index(self, states):
        """Convert states to nearest-vertex flat indices, shape ``(N,)``."""
        states = torch.atleast_2d(as_tensor(states))
        self._check_dimensions(states)
        lim, unit, strides = self._index_constants(states)
        states = torch.clamp(states, lim[:, 0], lim[:, 1])
        ijk = torch.round((states - lim[:, 0]) / unit).to(torch.int64)
        return torch.sum(ijk * strides, dim=-1)

    def _cell_shape(self):
        return tuple(n - 1 for n in self._num_points)

    def state_to_rectangle(self, states):
        """Convert states to the flat indices of their containing cells,
        clipped to the grid, shape ``(N,)``."""
        states = torch.atleast_2d(as_tensor(states))
        offset = torch.as_tensor(self.offset, dtype=states.dtype,
                                 device=states.device)
        unit = torch.as_tensor(self.unit_maxes, dtype=states.dtype,
                               device=states.device)
        top = torch.as_tensor(self.num_points - 2, device=states.device)
        ijk = torch.minimum(torch.floor((states - offset) / unit).to(
            torch.int64).clamp(min=0), top)
        strides = torch.as_tensor(row_major_strides(self._cell_shape()),
                                  device=states.device)
        return torch.sum(ijk * strides, dim=-1)

    def rectangle_corner_index(self, rectangles):
        """Flat vertex index of each cell's lower corner, shape ``(N,)``."""
        rectangles = torch.atleast_1d(as_tensor(rectangles,
                                                dtype=torch.int64))
        cell_strides = torch.as_tensor(row_major_strides(self._cell_shape()),
                                       device=rectangles.device)
        sizes = torch.as_tensor(self._cell_shape(), device=rectangles.device)
        ijk = (rectangles[:, None] // cell_strides) % sizes
        strides = torch.as_tensor(row_major_strides(self.shape),
                                  device=rectangles.device)
        return torch.sum(ijk * strides, dim=-1)
