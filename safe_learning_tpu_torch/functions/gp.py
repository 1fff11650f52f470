"""Gaussian-process regression: stationary kernels and the exact GP.

Counterpart of ``safe_learning_tpu/functions/gp.py``, part 1: the
stationary kernels, the float64 host island that factorizes the kernel
matrix, and ``GaussianProcess`` construction, ``predict`` and
``evaluate``. The design is the JAX package's:

- the training set lives in fixed-capacity buffers with a count mask;
- the Cholesky factor of the scaled kernel matrix and its explicit
  lower-triangular inverse are computed on the host in float64 and
  uploaded, so the per-query path is ``a = L^-1 k``, ``mean = a^T alpha``,
  ``var = kdiag - sum(a^2)``;
- a stationary kernel's predict runs as one hand-written CUDA kernel on
  the GPU (``ops/gp_kernel.py``) that never writes ``K(X, q)`` to device
  memory;
- the ``scale`` conditioning trick of the reference is kept.

Not ported yet (ROADMAP queue 1): ``add_data_point`` (item 14),
``StackedGaussianProcess``, the composite kernels,
``fit_gp_hyperparameters`` and sampling (item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from .base import UncertainFunction, as_tensor, dot

__all__ = ["Kernel", "RBF", "Matern12", "Matern32", "Matern52",
           "STATIONARY_COVARIANCES", "GaussianProcess"]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------
class Kernel:
    """Base class for covariance functions."""

    def __call__(self, x, z=None):
        """Full covariance matrix ``K(x, z)``, shape ``(len(x), len(z))``."""
        raise NotImplementedError

    def diag(self, x):
        """Diagonal of ``K(x, x)``, shape ``(len(x),)``."""
        raise NotImplementedError


def _sqdist(x, z):
    """Pairwise squared distances with the cross term as a matmul."""
    xx = (x * x).sum(dim=1, keepdim=True)
    zz = (z * z).sum(dim=1, keepdim=True)
    cross = dot(x, z.T)
    return torch.clamp(xx - 2.0 * cross + zz.T, min=0.0)


class _StationaryKernel(Kernel):
    """Shared scaffolding for stationary kernels with ARD lengthscales."""

    def __init__(self, variance=1.0, lengthscales=1.0, input_dim=1):
        self.variance = as_tensor(np.asarray(variance, dtype=config.np_dtype))
        ls = np.atleast_1d(np.asarray(lengthscales, dtype=config.np_dtype))
        self.lengthscales = as_tensor(np.broadcast_to(ls, (input_dim,)).copy())

    def _scaled(self, x):
        return torch.atleast_2d(as_tensor(x)) / self.lengthscales

    def __call__(self, x, z=None):
        """Covariance matrix (see :class:`Kernel`)."""
        x = self._scaled(x)
        z = x if z is None else self._scaled(z)
        return self.variance * self._from_sqdist(_sqdist(x, z))

    def diag(self, x):
        """Diagonal of ``K(x, x)``: the variance at every row."""
        x = torch.atleast_2d(as_tensor(x))
        return self.variance.expand(x.shape[0])

    @staticmethod
    def _from_sqdist(r2):
        raise NotImplementedError


class RBF(_StationaryKernel):
    """Squared-exponential kernel ``v * exp(-r^2 / 2)``."""

    @staticmethod
    def _from_sqdist(r2):
        return torch.exp(-0.5 * r2)


class Matern12(_StationaryKernel):
    """Matern-1/2 (exponential) kernel."""

    @staticmethod
    def _from_sqdist(r2):
        return torch.exp(-torch.sqrt(r2 + 1e-36))


class Matern32(_StationaryKernel):
    """Matern-3/2 kernel."""

    @staticmethod
    def _from_sqdist(r2):
        r = torch.sqrt(3.0 * r2 + 1e-36)
        return (1.0 + r) * torch.exp(-r)


class Matern52(_StationaryKernel):
    """Matern-5/2 kernel."""

    @staticmethod
    def _from_sqdist(r2):
        r = torch.sqrt(5.0 * r2 + 1e-36)
        return (1.0 + r + r * r / 3.0) * torch.exp(-r)


#: r2 -> normalized covariance, by stationary family name: the single
#: source of the formulas in Python. The CUDA kernel
#: (``csrc/gp_predict.cu``) writes the same formulas in C++ and is held
#: against this map through the kernel's plain version.
STATIONARY_COVARIANCES = {
    "rbf": RBF._from_sqdist,
    "matern12": Matern12._from_sqdist,
    "matern32": Matern32._from_sqdist,
    "matern52": Matern52._from_sqdist,
}

_KIND_OF = {RBF: "rbf", Matern12: "matern12", Matern32: "matern32",
            Matern52: "matern52"}


# ---------------------------------------------------------------------------
# Float64 host island
# ---------------------------------------------------------------------------
def _round_capacity(n):
    return max(8, int(2 ** np.ceil(np.log2(max(n, 1)))))


def _assemble64(kernel, x_rows, z_rows=None):
    """Float64 kernel matrix of the float64 copy of ``kernel`` (CPU).

    The same matrix the float64 oracle's rebuilt GP factorizes
    (``oracle.lift64``), so the host island's factors are the exact
    model's factors up to f64 roundoff. Returns a float64 numpy array.
    """
    from ..oracle import lift64

    x = torch.as_tensor(np.asarray(x_rows), dtype=torch.float64)
    z = (x if z_rows is None
         else torch.as_tensor(np.asarray(z_rows), dtype=torch.float64))
    return lift64(kernel)(x, z).numpy()


def _prior64(mean_function, x_rows, width):
    """Float64 prior mean at rows, shape ``(n, width)``; ``None`` is zero."""
    x_rows = np.asarray(x_rows)
    n = x_rows.shape[0]
    if mean_function is None or n == 0:
        return np.zeros((n, width))
    from ..oracle import lift64

    x = torch.as_tensor(x_rows, dtype=torch.float64)
    out = lift64(mean_function)(x).numpy()
    return np.broadcast_to(out.reshape(n, -1), (n, width))


class _HostCache:
    """Float64 host copy of a GP's Cholesky cache."""

    __slots__ = ("chol", "chol_inv", "alpha", "count", "jitter", "x_rows")

    def __init__(self, chol, chol_inv, alpha, count, jitter, x_rows):
        self.chol = chol
        self.chol_inv = chol_inv
        self.alpha = alpha
        self.count = int(count)
        self.jitter = float(jitter)
        self.x_rows = x_rows


def _host_factorize(kernel, x_buf, y_buf, mean_function, count,
                    noise_variance, scale):
    """Float64 host factorization of the masked, scaled kernel matrix.

    Mirrors ``safe_learning_tpu/functions/gp.py:647-694``: rows
    ``count..cap`` of the factor (and of its inverse) are the identity, a
    matrix that is not positive definite is retried with growing jitter,
    and ``chol_inv`` is exactly lower-triangular. Returns a
    :class:`_HostCache`.
    """
    import scipy.linalg

    x_buf = np.asarray(x_buf)
    cap = x_buf.shape[0]
    n = int(count)
    s2 = float(scale) ** 2
    x_rows = x_buf[:n].copy()
    k = _assemble64(kernel, x_rows)
    a = np.eye(cap)
    a[:n, :n] = s2 * (k + float(noise_variance) * np.eye(n))
    mask = np.zeros(cap)
    mask[:n] = 1.0
    jitter = 0.0
    diag_scale = float(np.max(np.diagonal(a))) if cap else 1.0
    for _ in range(16):
        try:
            chol = np.linalg.cholesky(a + (jitter * s2) * np.diag(mask))
            break
        except np.linalg.LinAlgError:
            jitter = max(64.0 * np.finfo(np.float64).eps * diag_scale / s2,
                         10.0 * jitter)
    else:
        raise np.linalg.LinAlgError(
            "GP kernel matrix is not positive definite even after "
            "jitter {:.2e}".format(jitter))
    chol_inv = scipy.linalg.solve_triangular(
        chol, np.eye(cap), lower=True, check_finite=False)
    y_buf = np.asarray(y_buf)
    target = np.zeros((cap, y_buf.shape[1]))
    prior = _prior64(mean_function, x_rows, y_buf.shape[1])
    target[:n] = float(scale) * (y_buf[:n].astype(np.float64) - prior)
    alpha = chol_inv @ target
    return _HostCache(chol, chol_inv, alpha, n, jitter, x_rows)


def _cache_parts(kernel, x_buf, y_buf, mean_function, count,
                 noise_variance, scale):
    """Factorize on the host and upload ``(chol_inv, alpha)``.

    The factorization always runs in float64 on the host, in both working
    dtypes, so that a float32 GP's factors and the float64 oracle's
    (``oracle.lift64`` rebuilds the GP and lands in this same code) are the
    same numpy arrays bit for bit. Returns ``(host_cache, chol_inv,
    alpha)``, the last two in the working dtype on ``config.device``.
    """
    host = _host_factorize(kernel, x_buf, y_buf, mean_function, count,
                           noise_variance, scale)
    # solve_triangular returns Fortran order; the kernel takes row-major.
    return (host, as_tensor(np.ascontiguousarray(host.chol_inv)),
            as_tensor(np.ascontiguousarray(host.alpha)))


# ---------------------------------------------------------------------------
# Exact GP regression with a cached inverse factor
# ---------------------------------------------------------------------------
class GaussianProcess(UncertainFunction):
    """Exact GP posterior exposing ``(mean, beta * std)`` confidence bounds.

    Parameters
    ----------
    kernel : Kernel
    x : (n, input_dim) array of observed inputs
    y : (n, output_dim) array of observed outputs
    noise_variance : float
    beta : float
        Confidence-interval scaling.
    mean_function : Function, optional
        Prior mean (defaults to zero).
    capacity : int, optional
        Fixed buffer capacity (default: ``n`` rounded up to a power of two,
        at least 8).
    scale : float, optional
        Internal conditioning factor of the reference's GP.
    """

    def __init__(self, kernel, x, y, noise_variance, beta=2.0,
                 mean_function=None, capacity=None, scale=1.0):
        x = np.atleast_2d(np.asarray(x, dtype=config.np_dtype))
        y = np.atleast_2d(np.asarray(y, dtype=config.np_dtype))
        if len(x) != len(y):
            raise ValueError("x and y must have the same number of rows")
        n, d = x.shape
        cap = _round_capacity(n) if capacity is None else int(capacity)
        if cap < n:
            raise ValueError("capacity {} is below the {} data rows".format(
                cap, n))

        self.kernel = kernel
        self.beta = float(beta)
        self.scale = float(scale)
        self.input_dim = d
        self.output_dim = y.shape[1]
        self.mean_function = mean_function
        self.noise_variance = as_tensor(np.asarray(noise_variance,
                                                   dtype=config.np_dtype))
        x_buf = np.zeros((cap, d), dtype=config.np_dtype)
        y_buf = np.zeros((cap, y.shape[1]), dtype=config.np_dtype)
        x_buf[:n] = x
        y_buf[:n] = y
        self.X_buf = as_tensor(x_buf)
        self.Y_buf = as_tensor(y_buf)
        self.count = n
        self._host_cache, self.chol_inv, self.alpha = _cache_parts(
            kernel, x_buf, y_buf, mean_function, n,
            float(self.noise_variance), self.scale)

    # -- data views -------------------------------------------------------
    @property
    def capacity(self):
        """Fixed buffer capacity."""
        return int(self.X_buf.shape[0])

    @property
    def X(self):
        """Active observed inputs (host numpy copy)."""
        return self.X_buf[:self.count].cpu().numpy()

    @property
    def Y(self):
        """Active observed outputs (host numpy copy)."""
        return self.Y_buf[:self.count].cpu().numpy()

    def _mask(self):
        return (torch.arange(self.capacity, device=self.X_buf.device)
                < self.count).to(self.X_buf.dtype)

    def _prior_mean(self, points):
        if self.mean_function is None:
            return 0.0
        return self.mean_function(points)

    # -- prediction ---------------------------------------------------------
    def _stationary_kind(self):
        return _KIND_OF.get(type(self.kernel))

    def predict(self, points, full_cov=False):
        """Posterior mean and (co)variance at query points.

        With a stationary kernel and ``config.use_kernels``, the whole
        predict is one call of :func:`~safe_learning_tpu_torch.ops.
        gp_kernel.fused_gp_predict` (the CUDA kernel for a CUDA tensor,
        its plain version for a CPU tensor). Otherwise it is the plain
        matmul chain, as the JAX package's XLA path.
        """
        points = torch.atleast_2d(as_tensor(points))
        s2 = self.scale ** 2
        kind = self._stationary_kind()
        if (not full_cov and kind is not None and config.use_kernels
                and self.capacity <= config.kernel_max_capacity):
            from ..ops.gp_kernel import fused_gp_predict

            ls = self.kernel.lengthscales
            mean_num, var_num = fused_gp_predict(
                points / ls, self.X_buf / ls, self.chol_inv, self.alpha,
                self._mask(), self.kernel.variance * s2, kind=kind)
            mean = mean_num / self.scale + self._prior_mean(points)
            var = self.kernel.diag(points) - var_num / s2
            var = torch.clamp(var, min=1e-12)[:, None]
            return mean, var.expand(points.shape[0], self.output_dim)

        kx = s2 * self.kernel(self.X_buf, points) * self._mask()[:, None]
        a = dot(self.chol_inv, kx)
        mean = dot(a.T, self.alpha) / self.scale + self._prior_mean(points)
        if full_cov:
            return mean, self.kernel(points, points) - dot(a.T, a) / s2
        var = self.kernel.diag(points) - (a * a).sum(dim=0) / s2
        var = torch.clamp(var, min=1e-12)[:, None]
        return mean, var.expand(points.shape[0], self.output_dim)

    def evaluate(self, points):
        """Return ``(mean, beta * std)``."""
        mean, var = self.predict(points)
        return mean, self.beta * torch.sqrt(var)

    def add_data_point(self, x, y):
        """Append observations (not ported yet)."""
        raise NotImplementedError(
            "GaussianProcess.add_data_point is ROADMAP queue 1 item 14 "
            "(GP online learning)")
