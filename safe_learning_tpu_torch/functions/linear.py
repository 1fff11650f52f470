"""Linear and quadratic function objects.

Counterpart of ``safe_learning_tpu/functions/linear.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from .base import DeterministicFunction, as_tensor, dot

__all__ = ["LinearSystem", "QuadraticFunction"]


class LinearSystem(DeterministicFunction):
    """A linear map ``y = [A_1 A_2 ...] [x_1; x_2; ...]``.

    Accepts one matrix or a sequence of matrices that are horizontally
    stacked; calling with ``(states, actions)`` then computes
    ``A @ x + B @ u``.
    """

    _param_fields = ("matrix",)

    def __init__(self, matrices):
        if isinstance(matrices, (list, tuple)):
            matrix = np.hstack([
                np.atleast_2d(np.asarray(m, dtype=config.np_dtype))
                for m in matrices])
        else:
            matrix = np.atleast_2d(np.asarray(matrices,
                                              dtype=config.np_dtype))
        self.matrix = as_tensor(matrix)

    @property
    def input_dim(self):
        """Dimensionality of the input points."""
        return int(self.matrix.shape[1])

    @property
    def output_dim(self):
        """Dimensionality of the output values."""
        return int(self.matrix.shape[0])

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        return dot(points, self.matrix.T)


class QuadraticFunction(DeterministicFunction):
    """The quadratic form ``v(x) = x^T P x``."""

    output_dim = 1

    def __init__(self, matrix):
        self.matrix = as_tensor(np.atleast_2d(np.asarray(
            matrix, dtype=config.np_dtype)))

    @property
    def input_dim(self):
        """Dimensionality of the input points."""
        return int(self.matrix.shape[0])

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        linear_form = dot(points, self.matrix)
        return (linear_form * points).sum(dim=1, keepdim=True)

    def gradient(self, points):
        """Closed-form gradient ``x (P + P^T)``."""
        points = torch.atleast_2d(as_tensor(points))
        return dot(points, self.matrix + self.matrix.T)
