"""Piecewise-linear simplex interpolation on regular grids.

Counterpart of ``safe_learning_tpu/functions/simplex.py``. Each grid cell
is cut into ``d!`` simplices by the Kuhn (Freudenthal) triangulation: the
simplex that holds a point is the descending order of its fractional
coordinates in the cell, with equal coordinates ordered by index. So the
locate, the barycentric weights and the vertex indices are branch-free
tensor operations on the points' device, differentiable in the points and
in the vertex values.

The evaluation gathers the values at the ``d + 1`` simplex vertices of
each point (the chain). The JAX package can also gather one row of cell
corners from a table (``simplex.py:242-323``), and through one-hot
matmuls on the TPU, which has no gather (``simplex.py:36-80``). Here
tensor indexing is the gather, and only the chain is kept: on the H100
the corner table made the 3,003,501-point safe-learning sweep 1.4x
slower.

``project=False`` extrapolates linearly outside the domain with the
boundary cell's hyperplane; ``project=True`` clips the points onto it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import config
# ``grids`` imports this package's ``base``: read its names at call time.
from .. import grids
from .base import DeterministicFunction, as_tensor

__all__ = ["Triangulation", "PiecewiseConstant"]


@functools.lru_cache(maxsize=64)
def _grid_constants(grid, np_dtype, dtype, device):
    """``(offset, unit_maxes, num_points - 2, strides)`` of a grid as
    tensors on ``device``, the first three in ``dtype`` from their values
    in ``np_dtype`` (the working dtype's, as ``GridWorld`` computes them).

    Cached: a tensor made from host data is a copy from pageable memory,
    which makes the host wait for the device at every call. ``np_dtype``
    is ``config.np_dtype``: a key only, since the grid reads it itself.
    """
    return (torch.as_tensor(grid.offset, dtype=dtype, device=device),
            torch.as_tensor(grid.unit_maxes, dtype=dtype, device=device),
            torch.as_tensor(grid.num_points - 2, dtype=dtype, device=device),
            torch.as_tensor(grids.row_major_strides(grid.shape),
                            device=device))


def _constants(grid, like):
    # The working dtype is part of the key: the grid's offset and cell
    # edges are computed in it.
    return _grid_constants(grid, config.np_dtype, like.dtype, like.device)


class Triangulation(DeterministicFunction):
    """Piecewise-linear interpolation on a regular grid.

    Parameters
    ----------
    discretization : GridWorld
    vertex_values : array-like, optional
        ``(nindex, output_dim)`` values at the grid vertices (the trainable
        parameters). Defaults to zeros with one output.
    project : bool, optional
        Clip query points onto the domain instead of extrapolating.
    """

    _param_fields = ("parameters",)

    def __init__(self, discretization, vertex_values=None, project=False):
        if not isinstance(discretization, grids.GridWorld):
            raise TypeError("discretization must be a GridWorld")
        self.discretization = discretization
        self.project = bool(project)
        if vertex_values is None:
            vertex_values = torch.zeros((discretization.nindex, 1),
                                        dtype=config.dtype,
                                        device=config.device)
        self.parameters = as_tensor(vertex_values).reshape(
            discretization.nindex, -1)

    # -- shape info -------------------------------------------------------
    @property
    def input_dim(self):
        """Dimensionality of the input points."""
        return self.discretization.ndim

    @property
    def output_dim(self):
        """Dimensionality of the output values."""
        return int(self.parameters.shape[1])

    @property
    def nindex(self):
        """Total number of grid vertices."""
        return self.discretization.nindex

    @property
    def nsimplex(self):
        """Total number of simplices: ``d!`` per cell."""
        return (math.factorial(self.discretization.ndim)
                * self.discretization.nrectangles)

    @property
    def limits(self):
        """Domain limits of the underlying grid."""
        return self.discretization.limits

    # -- core geometry ------------------------------------------------------
    def _locate(self, points):
        """``(vertices, weights, rank, cell)`` of a batch of points.

        ``vertices`` ``(N, d+1)`` are the flat indices of the simplex
        chain ``v_0 = corner``, ``v_k = v_{k-1} + e_{order[k-1]}``;
        ``weights`` ``(N, d+1)`` their barycentric weights; ``rank[i]`` the
        position of coordinate ``i`` in the descending order of the
        fractional coordinates (equal ones by index); ``cell`` ``(N, d)``
        the containing cell, clipped to the grid
        (``safe_learning_tpu/functions/simplex.py:172-227``).
        """
        grid = self.discretization
        d = grid.ndim
        points = torch.atleast_2d(as_tensor(points))
        grid._check_dimensions(points)

        offset, unit, top, strides = _constants(grid, points)
        frac = (points - offset) / unit
        cell = torch.minimum(torch.floor(frac).clamp(min=0), top)
        z_raw = frac - cell
        z_clip = z_raw.clamp(0.0, 1.0)
        cell = cell.to(torch.int64)

        # rank[i]: how many coordinates come before coordinate i in the
        # descending order (greater ones, and equal ones of lower index).
        # The O(d^2) comparison network is the JAX package's tie rule.
        dims = torch.arange(d, device=points.device)
        zj, zi = z_clip[:, None, :], z_clip[:, :, None]
        before = (zj > zi) | ((zj == zi) & (dims[None, None, :]
                                            < dims[None, :, None]))
        rank = before.sum(dim=2)
        order = torch.empty_like(rank).scatter_(
            1, rank, dims.expand(rank.shape[0], d).contiguous())

        z = z_clip if self.project else z_raw
        z_sorted = torch.gather(z, 1, order)
        # w_0 = 1 - z_(1), w_k = z_(k) - z_(k+1), w_d = z_(d).
        weights = torch.cat([1.0 - z_sorted[:, :1],
                             z_sorted[:, :-1] - z_sorted[:, 1:],
                             z_sorted[:, -1:]], dim=1)

        # v_k = corner + the strides of the dimensions stepped by then
        # (a cumulative sum over d = 2 columns is slow on the GPU).
        corner = (cell * strides).sum(dim=-1, keepdim=True)
        stepped = rank[:, :, None] < torch.arange(d + 1, device=rank.device)
        vertices = corner + (stepped.to(torch.int64)
                             * strides[None, :, None]).sum(dim=1)
        return vertices, weights, rank, cell

    def interpolation_weights(self, points):
        """The interpolation support ``(vertices, weights)``, each
        ``(N, d+1)``: ``evaluate(points) == sum(weights *
        parameters[vertices])``."""
        vertices, weights, _, _ = self._locate(points)
        return vertices, weights

    def evaluate(self, points):
        """Barycentric interpolation: the weighted sum of the values at the
        ``d + 1`` simplex vertices of each point."""
        vertices, weights, _, _ = self._locate(points)
        return (weights[:, :, None] * self.parameters[vertices]).sum(dim=1)

    def gradient(self, points):
        """Piecewise-constant spatial gradient, ``(N, output_dim, d)``,
        squeezed to ``(N, d)`` for one output
        (``safe_learning_tpu/functions/simplex.py:365-386``)."""
        grid = self.discretization
        vertices, _, rank, _ = self._locate(points)
        vals = self.parameters[vertices]                 # (N, d+1, p)
        # Along the chain, v_{k-1} -> v_k steps in dimension order[k-1]:
        # dimension i's difference is at chain position rank[i].
        diffs = vals[:, 1:, :] - vals[:, :-1, :]
        per_dim = torch.gather(diffs, 1, rank[:, :, None].expand(
            -1, -1, diffs.shape[2]))
        unit = _constants(grid, per_dim)[1]
        grad = (per_dim / unit[None, :, None]).transpose(1, 2)
        return grad[:, 0, :] if grad.shape[1] == 1 else grad

    # -- simplex bookkeeping ----------------------------------------------
    def find_simplex(self, points):
        """Global simplex index ``cell_index * d! + permutation_rank``."""
        d = self.discretization.ndim
        points = torch.atleast_2d(as_tensor(points))
        rect = self.discretization.state_to_rectangle(points)
        _, _, rank, _ = self._locate(points)
        order = torch.argsort(rank, dim=1)
        return rect * math.factorial(d) + _permutation_rank(order, d)

    def simplices(self, indices):
        """Vertex indices ``(N, d+1)`` of the given global simplices."""
        grid = self.discretization
        d = grid.ndim
        indices = torch.atleast_1d(as_tensor(indices, dtype=torch.int64))
        nlocal = math.factorial(d)
        order = _permutation_unrank(indices % nlocal, d)
        corner = grid.rectangle_corner_index(indices // nlocal)[:, None]
        strides = torch.as_tensor(grids.row_major_strides(grid.shape),
                                  device=indices.device)
        return torch.cat([corner, corner + torch.cumsum(strides[order],
                                                        dim=-1)], dim=1)

    # -- host-side sparse matrices ----------------------------------------
    def parameter_derivative(self, points):
        """Sparse ``B`` with ``evaluate(points) == B @ parameters``
        (scipy COO, on the host)."""
        from scipy import sparse

        vertices, weights = (t.detach().cpu().numpy()
                             for t in self.interpolation_weights(points))
        npoints, nsimp = vertices.shape
        rows = np.repeat(np.arange(npoints), nsimp)
        return sparse.coo_matrix(
            (weights.ravel(), (rows, vertices.ravel())),
            shape=(npoints, self.nindex))

    def gradient_parameter_derivative(self, points):
        """Sparse ``B`` with ``gradient(points).reshape(-1) == B @
        parameters``, point-major and dimension-minor (scipy COO, on the
        host)."""
        from scipy import sparse

        grid = self.discretization
        d = grid.ndim
        vertices, _, rank, _ = self._locate(points)
        vertices = vertices.cpu().numpy()
        rank = rank.cpu().numpy()
        npoints = len(vertices)
        h = np.asarray(grid.unit_maxes)
        every = np.arange(npoints)
        rows, cols, data = [], [], []
        for i in range(d):
            # +1/h_i on the chain vertex after dimension i's step, -1/h_i
            # on the one before it.
            row = every * d + i
            rows += [row, row]
            cols += [vertices[every, rank[:, i] + 1],
                     vertices[every, rank[:, i]]]
            data += [np.full(npoints, 1.0 / h[i]),
                     np.full(npoints, -1.0 / h[i])]
        return sparse.coo_matrix(
            (np.concatenate(data), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=(npoints * d, self.nindex))


def _permutation_rank(order, d):
    """Lexicographic rank of each permutation row (Lehmer code)."""
    rank = torch.zeros(order.shape[:-1], dtype=torch.int64,
                       device=order.device)
    for k in range(d - 1):
        smaller_after = (order[..., k + 1:] < order[..., k:k + 1]).sum(-1)
        rank = rank + smaller_after * math.factorial(d - 1 - k)
    return rank


def _permutation_unrank(rank, d):
    """Inverse of :func:`_permutation_rank`."""
    remaining = torch.arange(d, device=rank.device).expand(
        rank.shape[0], d).clone()
    positions = torch.arange(d, device=rank.device)[None, :]
    r = rank.to(torch.int64)
    out = []
    for k in range(d):
        f = math.factorial(d - 1 - k)
        idx = r // f
        r = r % f
        out.append(torch.gather(remaining, 1, idx[:, None])[:, 0])
        # Drop the chosen entry by shifting the tail left.
        shifted = torch.roll(remaining, -1, dims=1)
        remaining = torch.where(positions >= idx[:, None], shifted,
                                remaining)
    return torch.stack(out, dim=-1)


class PiecewiseConstant(DeterministicFunction):
    """Nearest-vertex piecewise-constant approximator
    (``safe_learning_tpu/functions/simplex.py:502-556``)."""

    _param_fields = ("parameters",)

    def __init__(self, discretization, vertex_values=None):
        self.discretization = discretization
        if vertex_values is None:
            vertex_values = torch.zeros((discretization.nindex, 1),
                                        dtype=config.dtype,
                                        device=config.device)
        self.parameters = as_tensor(vertex_values).reshape(
            discretization.nindex, -1)

    @property
    def input_dim(self):
        """Dimensionality of the input points."""
        return self.discretization.ndim

    @property
    def output_dim(self):
        """Dimensionality of the output values."""
        return int(self.parameters.shape[1])

    @property
    def nindex(self):
        """Total number of grid vertices."""
        return self.discretization.nindex

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        return self.parameters[self.discretization.state_to_index(points)]

    def parameter_derivative(self, points):
        """Sparse selection matrix (scipy COO, on the host)."""
        from scipy import sparse

        points = np.atleast_2d(points)
        npoints = len(points)
        cols = self.discretization.state_to_index(points).cpu().numpy()
        return sparse.coo_matrix(
            (np.ones(npoints), (np.arange(npoints), cols)),
            shape=(npoints, self.nindex))

    def gradient(self, points):
        """Zero gradient."""
        points = torch.atleast_2d(as_tensor(points))
        return torch.zeros((points.shape[0], self.input_dim),
                           dtype=points.dtype, device=points.device)
