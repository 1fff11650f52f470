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

from .dynamics import CartPole, InvertedPendulum, VanDerPol
from .functions import gp as gp_mod
from .functions.base import Saturation, as_tensor
from .functions.linear import LinearSystem, QuadraticFunction
from .functions.neural import LyapunovNetwork, NeuralNetwork, RBFNetwork
from .functions.simplex import PiecewiseConstant, Triangulation

__all__ = ["linear_system", "quadratic_function", "stationary_kernel",
           "linear_kernel", "active_dims", "sum_kernel", "product_kernel",
           "saturation", "inverted_pendulum", "cart_pole", "van_der_pol",
           "gaussian_process",
           "stacked_gaussian_process", "neural_network",
           "lyapunov_network", "rbf_network", "triangulation",
           "piecewise_constant"]


def _tensors(arrays):
    """A tuple of weight arrays as tensors, ``None`` entries kept."""
    return tuple(None if a is None else as_tensor(np.asarray(a))
                 for a in arrays)


def neural_network(layers, nonlinearities, output_scale, weights, biases,
                   use_bias=True):
    """``NeuralNetwork`` with the given weights ``(fan_in, fan_out)`` and
    biases (``None`` for the output layer)."""
    net = NeuralNetwork(layers, nonlinearities, output_scale=output_scale,
                        use_bias=use_bias)
    return net.with_parameters({"weights": _tensors(weights),
                                "biases": _tensors(biases)})


def lyapunov_network(input_dim, layer_dims, activations, eps,
                     posdef_weights, extra_weights):
    """``LyapunovNetwork`` with the given weights (``None`` where a layer
    does not grow)."""
    net = LyapunovNetwork(input_dim, layer_dims, activations, eps=eps)
    return net.with_parameters({"posdef_weights": _tensors(posdef_weights),
                                "extra_weights": _tensors(extra_weights)})


def rbf_network(limits, num_states, variance, weights):
    """``RBFNetwork`` on the grid ``(limits, num_states)`` with the given
    output weights."""
    net = RBFNetwork(limits, num_states, variance=float(variance))
    return net.with_parameters({"weights": as_tensor(np.asarray(weights))})


def triangulation(discretization, vertex_values, project=False):
    """``Triangulation`` on a port ``GridWorld`` with the given vertex
    values."""
    return Triangulation(discretization, np.asarray(vertex_values),
                         project=bool(project))


def piecewise_constant(discretization, vertex_values):
    """``PiecewiseConstant`` on a port ``GridWorld`` with the given vertex
    values."""
    return PiecewiseConstant(discretization, np.asarray(vertex_values))

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


def linear_kernel(variances):
    """``LinearKernel`` from its per-dimension variances."""
    v = np.atleast_1d(np.asarray(variances))
    return gp_mod.LinearKernel(v, input_dim=len(v))


def active_dims(kernel, dims):
    """``ActiveDims`` of a converted kernel over the input columns
    ``dims``."""
    return gp_mod.ActiveDims(kernel, dims)


def sum_kernel(k1, k2):
    """``SumKernel`` of two converted kernels."""
    return gp_mod.SumKernel(k1, k2)


def product_kernel(k1, k2):
    """``ProductKernel`` of two converted kernels."""
    return gp_mod.ProductKernel(k1, k2)


def saturation(fun, lower, upper):
    """``Saturation`` of a converted function between its bounds."""
    lower, upper = np.asarray(lower), np.asarray(upper)
    if lower.ndim == 0 and upper.ndim == 0:
        lower, upper = float(lower), float(upper)
    return Saturation(fun, lower, upper)


def inverted_pendulum(mass, length, friction, dt, tx=None, tu=None):
    """``InvertedPendulum`` from its parameters; ``tx`` and ``tu`` are the
    normalization, or ``None``."""
    norm = None if tx is None else (np.asarray(tx), np.asarray(tu))
    return InvertedPendulum(float(np.asarray(mass)), float(np.asarray(
        length)), float(np.asarray(friction)), float(dt),
        normalization=norm)


def cart_pole(pendulum_mass, cart_mass, length, rot_friction, dt, tx=None,
              tu=None):
    """``CartPole`` from its parameters; ``tx`` and ``tu`` are the
    normalization, or ``None``."""
    norm = None if tx is None else (np.asarray(tx), np.asarray(tu))
    return CartPole(*(float(np.asarray(p)) for p in (
        pendulum_mass, cart_mass, length, rot_friction)), float(dt),
        normalization=norm)


def van_der_pol(damping, dt, tx=None):
    """``VanDerPol`` from its parameters; ``tx`` is the state
    normalization, or ``None``."""
    return VanDerPol(float(np.asarray(damping)), float(dt),
                     normalization=None if tx is None else np.asarray(tx))


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


def stacked_gaussian_process(kernels, x, y, noise_variances, betas, scale,
                             capacity, mean_functions=None, adopt=None):
    """``StackedGaussianProcess`` from its data and hyperparameters.

    Parameters
    ----------
    kernels : Kernels of the port, one per output
    x, y : active training inputs and outputs (one column per kernel)
    noise_variances, betas, scale, capacity : as the JAX stack holds them
    mean_functions : Functions of the port (or ``None``), optional
    adopt : dict, optional
        ``chol_inv`` ``(S, cap, cap)``, ``alpha`` ``(S, cap, 1)``,
        ``X_buf`` and ``count`` of the JAX stack. When given, they replace
        the port's own factorizations.
    """
    gp = gp_mod.StackedGaussianProcess(
        kernels, np.asarray(x), np.asarray(y), np.asarray(noise_variances),
        betas=np.asarray(betas), mean_functions=mean_functions,
        capacity=int(capacity), scale=float(scale))
    if adopt is not None:
        x_buf = np.asarray(adopt["X_buf"])
        if x_buf.shape != tuple(gp.X_buf.shape):
            raise ValueError("adopted X_buf has shape {}, the stack {}"
                             .format(x_buf.shape, tuple(gp.X_buf.shape)))
        gp.X_buf = as_tensor(np.ascontiguousarray(x_buf))
        gp.count = int(adopt["count"])
        gp.chol_inv = as_tensor(np.ascontiguousarray(adopt["chol_inv"]))
        gp.alpha = as_tensor(np.ascontiguousarray(adopt["alpha"]))
        gp._host_caches = None
    return gp
