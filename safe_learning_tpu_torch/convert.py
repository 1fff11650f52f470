"""Build the port's objects from the JAX package's parameters.

Every function here takes plain numpy arrays (``np.asarray`` of the JAX
package's arrays), so this module imports no JAX. The objects are built in
the port's working dtype on ``config.device``.

A converted GP refactorizes its data in the port's float64 host island by
default. With ``adopt`` it instead takes the given ``chol_inv``, ``alpha``,
``X_buf`` and ``count`` as they are, so that both packages predict from
the exact same cache.
"""

from __future__ import annotations

import numpy as np

from .functions import gp as gp_mod
from .functions.base import as_tensor
from .functions.linear import LinearSystem, QuadraticFunction

__all__ = ["linear_system", "quadratic_function", "stationary_kernel",
           "gaussian_process"]

_KERNELS = {"rbf": gp_mod.RBF, "matern12": gp_mod.Matern12,
            "matern32": gp_mod.Matern32, "matern52": gp_mod.Matern52}


def linear_system(matrix):
    """``LinearSystem`` from its (stacked) matrix."""
    return LinearSystem(np.asarray(matrix))


def quadratic_function(matrix):
    """``QuadraticFunction`` from its matrix ``P``."""
    return QuadraticFunction(np.asarray(matrix))


def stationary_kernel(kind, variance, lengthscales):
    """A stationary kernel (``"rbf"``, ``"matern12"``, ``"matern32"`` or
    ``"matern52"``) from its variance and per-dimension lengthscales."""
    ls = np.atleast_1d(np.asarray(lengthscales))
    return _KERNELS[kind](np.asarray(variance), ls, input_dim=len(ls))


def gaussian_process(kernel, x, y, noise_variance, beta, scale, capacity,
                     mean_function=None, adopt=None):
    """``GaussianProcess`` from its data and hyperparameters.

    Parameters
    ----------
    kernel : Kernel of the port (see :func:`stationary_kernel`)
    x, y : active training inputs and outputs
    noise_variance, beta, scale, capacity : as the JAX GP holds them
    mean_function : Function of the port, optional
    adopt : dict, optional
        ``chol_inv``, ``alpha``, ``X_buf`` and ``count`` of the JAX GP. When
        given, they replace the port's own factorization.
    """
    gp = gp_mod.GaussianProcess(
        kernel, np.asarray(x), np.asarray(y), float(noise_variance),
        beta=float(beta), mean_function=mean_function,
        capacity=int(capacity), scale=float(scale))
    if adopt is not None:
        x_buf = np.asarray(adopt["X_buf"])
        if x_buf.shape != tuple(gp.X_buf.shape):
            raise ValueError("adopted X_buf has shape {}, the GP {}".format(
                x_buf.shape, tuple(gp.X_buf.shape)))
        gp.X_buf = as_tensor(np.ascontiguousarray(x_buf))
        gp.count = int(adopt["count"])
        gp.chol_inv = as_tensor(np.ascontiguousarray(adopt["chol_inv"]))
        gp.alpha = as_tensor(np.ascontiguousarray(adopt["alpha"]))
        gp._host_cache = None
    return gp
