"""Neural-network function approximators.

Counterpart of ``safe_learning_tpu/functions/neural.py``: the policy MLP
``NeuralNetwork`` with its spectral Lipschitz bound, and the example
layer's ``LyapunovNetwork`` and ``RBFNetwork``. Weights are laid out as
the JAX package lays them out (``(fan_in, fan_out)``, ``x @ W``), so
``convert`` can carry them across unchanged. Initialisation is
Xavier-uniform from an explicit ``torch.Generator``; the two packages'
generators differ, so parity needs the weights copied, not the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import config
# ``grids`` imports this package's ``base``: read its names at call time.
from .. import grids
from .base import DeterministicFunction, as_tensor, dot

__all__ = ["NeuralNetwork", "LyapunovNetwork", "RBFNetwork"]


def _softplus(x):
    # log(1 + e^x) without torch's linear cut-off above 20, as jax.nn.
    return torch.logaddexp(x, torch.zeros_like(x))


_ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": _softplus,
    "swish": torch.nn.functional.silu,
}


def _activation(name):
    if callable(name):
        return name
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError("unknown activation {!r}".format(name))


def _xavier(generator, shape):
    """Xavier-uniform weights of ``shape`` in the working dtype on
    ``config.device``, bound ``sqrt(6 / (fan_in + fan_out))``
    (``safe_learning_tpu/functions/neural.py:45-48``)."""
    bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return (2.0 * bound * u - bound).to(dtype=config.dtype,
                                         device=config.device)


def _generator(generator):
    return torch.Generator().manual_seed(0) if generator is None \
        else generator


class NeuralNetwork(DeterministicFunction):
    """A multilayer perceptron exposing its Lipschitz constant.

    Parameters
    ----------
    layers : list of int
        ``[input_dim, h1, ..., output_dim]``.
    nonlinearities : list
        One activation (name or callable) per layer after the first. The
        hidden layers have biases, the output layer has none (its entry in
        ``biases`` is ``None``).
    output_scale : float, optional
    use_bias : bool, optional
    generator : torch.Generator, optional
        Source of the Xavier-uniform weights (seed 0 when omitted); the
        biases start at zero.
    """

    _param_fields = ("weights", "biases")

    def __init__(self, layers, nonlinearities, output_scale=1.0,
                 use_bias=True, generator=None):
        self.layers = tuple(int(n) for n in layers)
        self.nonlinearities = tuple(nonlinearities)
        if len(self.nonlinearities) != len(self.layers) - 1:
            raise ValueError("need one nonlinearity per layer")
        self.output_scale = float(output_scale)
        self.use_bias = bool(use_bias)
        generator = _generator(generator)
        weights, biases = [], []
        for i, (n_in, n_out) in enumerate(zip(self.layers[:-1],
                                              self.layers[1:])):
            weights.append(_xavier(generator, (n_in, n_out)))
            hidden = i < len(self.layers) - 2
            biases.append(torch.zeros(n_out, dtype=config.dtype,
                                      device=config.device)
                          if use_bias and hidden else None)
        self.weights = tuple(weights)
        self.biases = tuple(biases)

    @property
    def input_dim(self):
        """Dimensionality of the input points."""
        return self.layers[0]

    @property
    def output_dim(self):
        """Dimensionality of the output values."""
        return self.layers[-1]

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        net = points
        for w, b, act in zip(self.weights, self.biases,
                             self.nonlinearities):
            net = dot(net, w)
            if b is not None:
                net = net + b
            net = _activation(act)(net)
        return net * self.output_scale

    def lipschitz(self):
        """Upper bound on the Lipschitz constant: the output scale times
        the product of the layers' spectral norms (contractive
        activations assumed), differentiable in the weights."""
        lip = torch.as_tensor(self.output_scale, dtype=self.weights[0].dtype,
                              device=self.weights[0].device)
        for w in self.weights:
            lip = lip * _svd_singular_values(w).max()
        return lip


def _svd_singular_values(a):
    """Singular values with stable gradients.

    ``S = U0^T A V0`` around an SVD of the detached matrix, as
    ``safe_learning_tpu/functions/neural.py:137-149``: the gradient never
    goes through the SVD's own derivative, which is unstable for close
    singular values. The diagonal of a non-square ``S`` is its first
    ``min(m, n)`` entries, as ``jnp.diagonal``.
    """
    u0, _, vt0 = torch.linalg.svd(a.detach(), full_matrices=True)
    return torch.diagonal(dot(dot(u0.T, a), vt0.T))


class LyapunovNetwork(DeterministicFunction):
    """A neural network that is positive definite by construction.

    Each layer's kernel is ``W0^T W0 + eps I``, extended with free rows
    where the width grows; the output is ``||phi(x)||^2``
    (``safe_learning_tpu/functions/neural.py:152-214``).
    """

    _param_fields = ("posdef_weights", "extra_weights")
    output_dim = 1

    def __init__(self, input_dim, layer_dims, activations, eps=1e-6,
                 generator=None):
        self.input_dim = int(input_dim)
        self.layer_dims = tuple(int(d) for d in layer_dims)
        self.activations = tuple(activations)
        self.eps = float(eps)
        if self.layer_dims[0] < self.input_dim:
            raise ValueError("The first layer dimension must be at least "
                             "the input dimension!")
        if np.any(np.diff(self.layer_dims) < 0):
            raise ValueError("Each layer must maintain or increase the "
                             "dimension of its input!")
        generator = _generator(generator)
        posdef, extra = [], []
        in_dim = self.input_dim
        for out_dim in self.layer_dims:
            hidden = int(np.ceil((in_dim + 1) / 2))
            posdef.append(_xavier(generator, (hidden, in_dim)))
            dim_diff = out_dim - in_dim
            extra.append(_xavier(generator, (dim_diff, in_dim))
                         if dim_diff > 0 else None)
            in_dim = out_dim
        self.posdef_weights = tuple(posdef)
        self.extra_weights = tuple(extra)

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        net = points
        in_dim = self.input_dim
        for w0, w1, out_dim, act in zip(self.posdef_weights,
                                        self.extra_weights, self.layer_dims,
                                        self.activations):
            kernel = dot(w0.T, w0) + self.eps * torch.eye(
                in_dim, dtype=w0.dtype, device=w0.device)
            if w1 is not None:
                kernel = torch.cat([kernel, w1], dim=0)
            net = _activation(act)(dot(net, kernel.T))
            in_dim = out_dim
        return (net * net).sum(dim=1, keepdim=True)


class RBFNetwork(DeterministicFunction):
    """Gaussian radial basis features on a grid with linear output weights
    (``safe_learning_tpu/functions/neural.py:217-257``)."""

    _param_fields = ("weights",)
    output_dim = 1

    def __init__(self, limits, num_states, variance=None, generator=None):
        self.discretization = grids.GridWorld(limits, num_states)
        if variance is None:
            variance = float(np.min(self.discretization.unit_maxes) ** 2)
        self.variance = float(variance)
        self.weights = _xavier(_generator(generator),
                               (self.discretization.nindex, 1))

    @property
    def input_dim(self):
        """Dimensionality of the input points."""
        return self.discretization.ndim

    @property
    def centers(self):
        """Feature centres: the grid's vertices."""
        return as_tensor(self.discretization.all_points)

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        beta = 1.0 / (2.0 * self.variance)
        centers = self.centers.to(points.dtype)
        sq = ((points ** 2).sum(dim=1, keepdim=True)
              + (centers ** 2).sum(dim=1)[None, :]
              - 2.0 * dot(points, centers.T))
        return dot(torch.exp(-beta * sq), self.weights)
