"""Gaussian-process regression: kernels, the exact GP and the stacked GP.

Counterpart of ``safe_learning_tpu/functions/gp.py``: the stationary,
linear and composite kernels, the float64 host island that factorizes the
kernel matrix, ``GaussianProcess`` and ``StackedGaussianProcess``
construction, ``predict`` and ``evaluate``. The design is the JAX
package's:

- the training set lives in fixed-capacity buffers with a count mask;
- the Cholesky factor of the scaled kernel matrix and its explicit
  lower-triangular inverse are computed on the host in float64 and
  uploaded, so the per-query path is ``a = L^-1 k``, ``mean = a^T alpha``,
  ``var = kdiag - sum(a^2)``;
- the predict runs as one hand-written CUDA kernel on the GPU
  (``ops/gp_kernel.py``) that never writes ``K(X, q)`` to device memory:
  a stationary kernel has its own kernel, a composite kernel compiles to
  a covariance program, and a stacked GP runs all its outputs in one
  launch;
- the ``scale`` conditioning trick of the reference is kept;
- ``add_data_point`` returns a new GP whose host factors grow by an
  O(n^2) bordered Cholesky append in float64 (``_bordered_append``), or
  are refactorized when that is refused, and whose buffers are rebuilt at
  the next power of two past capacity;
- ``_device_border_append`` grows the device factors by one observation
  in the working dtype with no host round trip, between the measurements
  of ``explore.get_safe_sample_batch``;
- ``log_marginal_likelihood`` is differentiable through autograd, and
  ``fit_gp_hyperparameters`` maximizes it over the kernel's positive
  tensors and the noise (Adam, or scipy's L-BFGS-B);
- ``sample_gp_function`` draws exact posterior samples in a float64 host
  island, and a ``GPSampledFunction`` interpolates one consistently with
  the posterior.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import config
from .base import (DeterministicFunction, UncertainFunction, as_tensor,
                   concatenate_inputs, dot)

__all__ = ["Kernel", "RBF", "Matern12", "Matern32", "Matern52",
           "LinearKernel", "ActiveDims", "SumKernel", "ProductKernel",
           "STATIONARY_COVARIANCES", "GaussianProcess", "GPRCached",
           "StackedGaussianProcess", "coerce_stacked",
           "fit_gp_hyperparameters", "GPSampledFunction",
           "StackedSampledFunction", "sample_gp_function"]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------
class Kernel:
    """Base class for covariance functions.

    ``_leaf_fields`` name a kernel's positive hyperparameter tensors and
    ``_child_fields`` the kernels it holds, in the order of the JAX
    package's pytree fields (``_kernel_leaves``).
    """

    _leaf_fields = ()
    _child_fields = ()

    def __call__(self, x, z=None):
        """Full covariance matrix ``K(x, z)``, shape ``(len(x), len(z))``."""
        raise NotImplementedError

    def diag(self, x):
        """Diagonal of ``K(x, x)``, shape ``(len(x),)``."""
        raise NotImplementedError

    def __add__(self, other):
        """Pointwise sum (kernel algebra)."""
        return SumKernel(self, other)

    def __mul__(self, other):
        """Pointwise product (kernel algebra)."""
        return ProductKernel(self, other)


def _sqdist(x, z):
    """Pairwise squared distances with the cross term as a matmul."""
    xx = (x * x).sum(dim=1, keepdim=True)
    zz = (z * z).sum(dim=1, keepdim=True)
    cross = dot(x, z.T)
    return torch.clamp(xx - 2.0 * cross + zz.T, min=0.0)


class _StationaryKernel(Kernel):
    """Shared scaffolding for stationary kernels with ARD lengthscales."""

    _leaf_fields = ("variance", "lengthscales")

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


class LinearKernel(Kernel):
    """Dot-product kernel ``K(x, z) = x diag(v) z^T`` (gpflow ``Linear``)."""

    _leaf_fields = ("variances",)

    def __init__(self, variances=1.0, input_dim=1):
        v = np.atleast_1d(np.asarray(variances, dtype=config.np_dtype))
        self.variances = as_tensor(np.broadcast_to(v, (input_dim,)).copy())

    def __call__(self, x, z=None):
        """Covariance matrix (see :class:`Kernel`)."""
        x = torch.atleast_2d(as_tensor(x))
        z = x if z is None else torch.atleast_2d(as_tensor(z))
        return dot(x * self.variances, z.T)

    def diag(self, x):
        """Diagonal of ``K(x, x)``."""
        x = torch.atleast_2d(as_tensor(x))
        return (x * x * self.variances).sum(dim=1)


class ActiveDims(Kernel):
    """Restrict a kernel to a subset of input columns (gpflow
    ``active_dims``)."""

    _child_fields = ("kernel",)

    def __init__(self, kernel, dims):
        self.kernel = kernel
        self.dims = tuple(int(d) for d in dims)

    def _slice(self, x):
        x = torch.atleast_2d(as_tensor(x))
        lo, hi = self.dims[0], self.dims[-1] + 1
        if self.dims == tuple(range(lo, hi)):
            # A view: an index list would be copied to the device, and the
            # host would wait for the device at every call.
            return x[:, lo:hi]
        return x[:, list(self.dims)]

    def __call__(self, x, z=None):
        """Covariance matrix (see :class:`Kernel`)."""
        z = x if z is None else z
        return self.kernel(self._slice(x), self._slice(z))

    def diag(self, x):
        """Diagonal of ``K(x, x)``."""
        return self.kernel.diag(self._slice(x))


class SumKernel(Kernel):
    """Pointwise sum of two kernels (gpflow ``Add``)."""

    _child_fields = ("k1", "k2")

    def __init__(self, k1, k2):
        self.k1, self.k2 = k1, k2

    def __call__(self, x, z=None):
        """Covariance matrix (see :class:`Kernel`)."""
        return self.k1(x, z) + self.k2(x, z)

    def diag(self, x):
        """Diagonal of ``K(x, x)``."""
        return self.k1.diag(x) + self.k2.diag(x)


class ProductKernel(Kernel):
    """Pointwise product of two kernels (gpflow ``Prod``)."""

    _child_fields = ("k1", "k2")

    def __init__(self, k1, k2):
        self.k1, self.k2 = k1, k2

    def __call__(self, x, z=None):
        """Covariance matrix (see :class:`Kernel`)."""
        return self.k1(x, z) * self.k2(x, z)

    def diag(self, x):
        """Diagonal of ``K(x, x)``."""
        return self.k1.diag(x) * self.k2.diag(x)


def _kernel_leaves(kernel):
    """A kernel tree's positive hyperparameter tensors, in the order of
    ``jax.tree_util.tree_flatten`` of the JAX package's kernel: a
    stationary kernel's variance and lengthscales, a ``LinearKernel``'s
    variances, with sums, products and ``ActiveDims`` recursed into."""
    leaves = [getattr(kernel, name) for name in kernel._leaf_fields]
    for name in kernel._child_fields:
        leaves += _kernel_leaves(getattr(kernel, name))
    return leaves


def _with_kernel_leaves(kernel, leaves):
    """A copy of a kernel tree with its :func:`_kernel_leaves` replaced by
    ``leaves``, in the same order."""
    leaves = iter(leaves)

    def rebuild(node):
        new = copy.copy(node)
        for name in node._leaf_fields:
            setattr(new, name, next(leaves))
        for name in node._child_fields:
            setattr(new, name, rebuild(getattr(node, name)))
        return new

    return rebuild(kernel)


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
    """Float64 host copy of a GP's Cholesky cache.

    ``x_rows`` are the active training inputs as stored (working dtype),
    so an append needs no copy from the device. ``fresh`` is True for a
    factorization from scratch (bit for bit the float64 oracle's) and
    False after a bordered append.
    """

    __slots__ = ("chol", "chol_inv", "alpha", "count", "jitter", "x_rows",
                 "fresh")

    def __init__(self, chol, chol_inv, alpha, count, jitter, x_rows,
                 fresh=True):
        self.chol = chol
        self.chol_inv = chol_inv
        self.alpha = alpha
        self.count = int(count)
        self.jitter = float(jitter)
        self.x_rows = x_rows
        self.fresh = bool(fresh)


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


def _bordered_append(host, kernel, x_new, y_new, mean_function,
                     noise_variance, scale, capacity):
    """O(n^2) bordered Cholesky append of ``m`` observations, in float64.

    The recurrence a fresh factorization runs for the new rows (the
    leading block of the factor does not change), with the kernel columns
    and the prior assembled by the same float64 code as
    :func:`_host_factorize`, so the result matches a refactorization to
    float64 roundoff (``safe_learning_tpu/functions/gp.py:704-771``).
    Returns the new :class:`_HostCache`, or ``None`` past ``capacity`` or
    when a pivot is not safely positive: the caller then refactorizes,
    with the jitter loop.
    """
    import scipy.linalg

    n = host.count
    m = len(y_new)
    if n + m > int(capacity):
        return None
    s = float(scale)
    s2 = s * s
    x_new = np.asarray(x_new, dtype=host.x_rows.dtype).reshape(m, -1)
    rows = np.vstack([host.x_rows, x_new]) if n else x_new
    k_cols = _assemble64(kernel, rows, x_new) * s2
    prior_new = _prior64(mean_function, x_new, y_new.shape[1])
    target_new = s * (np.asarray(y_new, dtype=np.float64) - prior_new)
    noise = float(noise_variance)

    chol = host.chol.copy()
    chol_inv = host.chol_inv.copy()
    alpha = host.alpha.copy()
    for j in range(m):
        i = n + j
        diag = k_cols[i, j] + s2 * (noise + host.jitter)
        lj = scipy.linalg.solve_triangular(
            chol[:i, :i], k_cols[:i, j], lower=True, check_finite=False)
        d2 = diag - lj @ lj
        # A pivot near float64 roundoff of the quadratic form goes to the
        # refactorization and its jitter instead.
        if not np.isfinite(d2) or d2 <= 1e-12 * max(diag, 1e-30):
            return None
        d = np.sqrt(d2)
        chol[i, :i] = lj
        chol[i, i] = d
        chol_inv[i, :i] = -(lj @ chol_inv[:i, :i]) / d
        chol_inv[i, i] = 1.0 / d
        alpha[i, :] = (target_new[j] - lj @ alpha[:i, :]) / d
    return _HostCache(chol, chol_inv, alpha, n + m, host.jitter, rows,
                      fresh=False)


def _append_rows(buf, rows, n):
    """A copy of the buffer ``buf`` with ``rows`` written from row ``n``."""
    out = buf.clone()
    if not torch.is_tensor(rows):
        rows = torch.as_tensor(np.array(rows))
    out[n:n + len(rows)] = rows.to(device=buf.device, dtype=buf.dtype)
    return out


def _border_one(kernel, chol_inv, alpha, noise, x_buf, x_new, mask, i, s2,
                target):
    """One output's bordered step at row ``i``: the new rows of
    ``chol_inv`` (``(cap,)``) and of ``alpha`` (``(p,)``).

    ``y = L^-1 k`` comes from the cached inverse, not from a solve with
    ``L`` (equal in exact arithmetic), so no device factor ``L`` is kept.
    The pivot is clamped at ``1e-10 max(diag, 1e-30)``, as the JAX
    package's device append (``safe_learning_tpu/functions/gp.py:
    799-818``); rows past ``i`` stay as the host factorization left them,
    so ``chol_inv[count:, :count] == 0`` still holds.
    """
    kj = s2 * kernel(x_buf, x_new)[:, 0] * mask
    diag = s2 * (kernel.diag(x_new)[0] + noise)
    y = chol_inv @ kj
    d2 = diag - (y * y).sum()
    d = torch.sqrt(torch.maximum(
        d2, 1e-10 * torch.clamp(diag, min=1e-30)))
    inv_row = -(y @ chol_inv) / d
    inv_row[i] = 1.0 / d
    return inv_row, (target - y @ alpha) / d


def _device_border_append(gp, x_new, y_new):
    """Append one observation of every output on the device (selection
    grade); returns a new GP.

    The working-dtype counterpart of :func:`_bordered_append`
    (``safe_learning_tpu/functions/gp.py:774-843``) for
    :class:`GaussianProcess` and :class:`StackedGaussianProcess`:
    ``x_new`` is a ``(1, input_dim)`` and ``y_new`` a ``(1, output_dim)``
    tensor on the GP's device. The buffers, ``chol_inv`` and ``alpha`` are
    new tensors with row ``count`` written; the count becomes
    ``count + 1`` on the host, so nothing waits for the device. The new
    GP has no float64 host cache: its :meth:`add_data_point` refactorizes.
    ``explore.get_safe_sample_batch`` advances its copy of the GP with it
    between measurements and refreshes the original once, in float64.
    """
    i = gp.count
    if i >= gp.capacity:
        raise ValueError("the GP is full (capacity {})".format(gp.capacity))
    s = gp.scale
    s2 = s * s
    x_new = x_new.to(gp.X_buf.dtype).reshape(1, -1)
    y_new = y_new.to(gp.Y_buf.dtype).reshape(1, -1)
    mask = gp._mask()
    x_buf = _append_rows(gp.X_buf, x_new, i)
    new = copy.copy(gp)
    new.X_buf = x_buf
    new.Y_buf = _append_rows(gp.Y_buf, y_new, i)
    new.count = i + 1
    chol_inv = gp.chol_inv.clone()
    alpha = gp.alpha.clone()
    if isinstance(gp, StackedGaussianProcess):
        target = s * (y_new - gp._prior_means(x_new))[0]
        for out, kernel in enumerate(gp.kernels):
            chol_inv[out, i], alpha[out, i] = _border_one(
                kernel, gp.chol_inv[out], gp.alpha[out],
                gp.noise_variances[out], x_buf, x_new, mask, i, s2,
                target[out:out + 1])
        new._host_caches = None
    else:
        prior = gp._prior_mean(x_new)
        target = s * (y_new - prior)[0]
        chol_inv[i], alpha[i] = _border_one(
            gp.kernel, gp.chol_inv, gp.alpha, gp.noise_variance, x_buf,
            x_new, mask, i, s2, target)
        new._host_cache = None
    new.chol_inv, new.alpha = chol_inv, alpha
    # Its factors are working-dtype arithmetic, not rounded float64 ones:
    # ``errorbounds`` refuses to derive a margin on it.
    new._device_appended = True
    return new


def _host(tensor):
    return tensor.detach().cpu().numpy()


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

    def _fused_numerators(self, points):
        """``(mean_num, var_num)`` through a fused predict, or ``None``.

        A stationary kernel goes to :func:`~safe_learning_tpu_torch.ops.
        gp_kernel.fused_gp_predict` on pre-scaled inputs; a kernel that
        compiles to a covariance program goes to
        :func:`~safe_learning_tpu_torch.ops.gp_kernel.
        fused_gp_predict_general`. Each is the CUDA kernel for a CUDA
        tensor and its plain version for a CPU tensor; the GP's host
        ``count`` bounds the kernels' loops (no device sync). ``None``
        means the kernel does not compile; the caller then takes the
        matmul chain, as the JAX package does.
        """
        from ..ops.gp_kernel import (compile_kernel_program,
                                     fused_gp_predict,
                                     fused_gp_predict_general,
                                     program_params)

        s2 = self.scale ** 2
        kind = self._stationary_kind()
        if kind is not None:
            ls = self.kernel.lengthscales
            return fused_gp_predict(
                points / ls, self.X_buf / ls, self.chol_inv, self.alpha,
                self._mask(), self.kernel.variance * s2, kind=kind,
                count=self.count)
        # The walk that collects the parameter vector also yields the
        # program; the built CUDA library is cached per program.
        compiled = compile_kernel_program(self.kernel,
                                          input_dim=self.input_dim)
        if compiled is None:
            return None
        program, param_list = compiled
        return fused_gp_predict_general(
            points, self.X_buf, program_params(param_list, points),
            self.chol_inv, self.alpha, self._mask(), s2, program,
            count=self.count)

    def predict(self, points, full_cov=False):
        """Posterior mean and (co)variance at query points.

        With ``config.use_kernels`` and a kernel that has a fused route
        (:meth:`_fused_numerators`), the whole predict is one kernel call.
        Otherwise it is the plain matmul chain, as the JAX package's XLA
        path.
        """
        points = torch.atleast_2d(as_tensor(points))
        s2 = self.scale ** 2
        fused = None
        if (not full_cov and config.use_kernels
                and self.capacity <= config.kernel_max_capacity):
            fused = self._fused_numerators(points)
        if fused is not None:
            mean_num, var_num = fused
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

    def log_marginal_likelihood(self, kernel=None, noise_variance=None):
        """Exact log marginal likelihood of the active data, summed over
        the outputs (``safe_learning_tpu/functions/gp.py:508-526``).

        Differentiable through autograd with respect to the tensors of
        ``kernel`` and ``noise_variance`` (the GP's own by default).
        """
        kernel = self.kernel if kernel is None else kernel
        noise = (self.noise_variance if noise_variance is None
                 else noise_variance)
        return _log_marginal_likelihood(kernel, noise, self.X_buf,
                                        self.Y_buf, self.mean_function,
                                        self.count)

    def add_data_point(self, x, y):
        """Append observations; returns a new GP.

        Past capacity the GP is rebuilt at the next power of two. Else the
        rows are written into copies of the buffers and, with the host
        factors at hand, the factors grow by :func:`_bordered_append`;
        otherwise (or when that refuses) they are refactorized
        (``safe_learning_tpu/functions/gp.py:529-574``).
        """
        x = np.atleast_2d(np.asarray(x, dtype=config.np_dtype))
        y = np.atleast_2d(np.asarray(y, dtype=config.np_dtype))
        n, n_new = self.count, len(x)
        if n + n_new > self.capacity:
            return GaussianProcess(
                self.kernel, np.vstack([self.X, x]), np.vstack([self.Y, y]),
                float(self.noise_variance), beta=self.beta,
                mean_function=self.mean_function,
                capacity=_round_capacity(n + n_new), scale=self.scale)
        new = copy.copy(self)
        new.X_buf = _append_rows(self.X_buf, x, n)
        new.Y_buf = _append_rows(self.Y_buf, y, n)
        new.count = n + n_new
        # The factors below are float64 host ones again.
        new._device_appended = False
        host = self._host_cache
        host_new = None
        if host is not None and host.count == n:
            host_new = _bordered_append(
                host, self.kernel, x, y, self.mean_function,
                float(self.noise_variance), self.scale, self.capacity)
        if host_new is None:
            new._host_cache, new.chol_inv, new.alpha = _cache_parts(
                self.kernel, _host(new.X_buf), _host(new.Y_buf),
                self.mean_function, new.count, float(self.noise_variance),
                self.scale)
        else:
            new._host_cache = host_new
            new.chol_inv = as_tensor(np.ascontiguousarray(host_new.chol_inv))
            new.alpha = as_tensor(np.ascontiguousarray(host_new.alpha))
        return new


#: The reference's two GP names are one class here
#: (``safe_learning_tpu/functions/gp.py:577-583``).
GPRCached = GaussianProcess


def _log_marginal_likelihood(kernel, noise_variance, x_buf, y_buf,
                             mean_function, count):
    """Masked exact GP log marginal likelihood, summed over outputs.

    As ``safe_learning_tpu/functions/gp.py:586-613``: inactive buffer rows
    contribute identity rows to the factor and nothing to the quadratic
    form or the log determinant, so the result is the unpadded
    ``-1/2 r' K^-1 r - 1/2 log|K| - n/2 log(2 pi)`` per output column.
    """
    cap = x_buf.shape[0]
    dtype, device = x_buf.dtype, x_buf.device
    mask = (torch.arange(cap, device=device) < count).to(dtype)
    outer = mask[:, None] * mask[None, :]
    eye = torch.eye(cap, dtype=dtype, device=device)
    k = kernel(x_buf, x_buf) + noise_variance * eye
    k = torch.where(outer > 0, k, eye)
    chol = torch.linalg.cholesky(k)
    prior = 0.0 if mean_function is None else mean_function(x_buf)
    resid = (y_buf - prior) * mask[:, None]
    alpha = torch.linalg.solve_triangular(chol, resid, upper=False)
    quad = (alpha ** 2).sum()
    # Identity rows have log diag 0, so the masked logdet is free.
    logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
    p = y_buf.shape[1]
    return (-0.5 * quad - 0.5 * p * logdet
            - 0.5 * p * float(count) * np.log(2.0 * np.pi))


# ---------------------------------------------------------------------------
# Batched multi-output GP over shared inputs
# ---------------------------------------------------------------------------
class StackedGaussianProcess(UncertainFunction):
    """A stack of single-output GPs over one shared training set.

    Counterpart of ``safe_learning_tpu.StackedGaussianProcess``: the
    batched form of per-dimension GPs in a
    :class:`~safe_learning_tpu_torch.functions.base.FunctionStack`. Each
    output keeps its own kernel, noise variance, ``beta`` and prior mean;
    the training inputs are stored once, and the predict runs every output
    in one fused kernel launch (``ops/gp_kernel.py::
    fused_gp_predict_stacked``).

    Parameters
    ----------
    kernels : sequence of Kernel, one per output
    x : (n, input_dim) shared observed inputs
    y : (n, num_fun) observed outputs, one column per kernel
    noise_variances : float or (num_fun,) array
    betas : float or (num_fun,) array
    mean_functions : sequence of Function or None, optional
    capacity : int, optional
    scale : float, optional
    """

    def __init__(self, kernels, x, y, noise_variances, betas=2.0,
                 mean_functions=None, capacity=None, scale=1.0):
        kernels = tuple(kernels)
        n_out = len(kernels)
        x = np.atleast_2d(np.asarray(x, dtype=config.np_dtype))
        y = np.atleast_2d(np.asarray(y, dtype=config.np_dtype))
        if y.shape[1] != n_out:
            raise ValueError("y must have one column per kernel")
        if len(x) != len(y):
            raise ValueError("x and y must have the same number of rows")
        n, d = x.shape
        cap = _round_capacity(n) if capacity is None else int(capacity)
        if cap < n:
            raise ValueError("capacity {} is below the {} data rows".format(
                cap, n))

        self.kernels = kernels
        self.num_fun = n_out
        self.input_dim = d
        self.output_dim = n_out
        self.scale = float(scale)
        betas = np.broadcast_to(np.asarray(betas, dtype=float), (n_out,))
        self.betas = tuple(float(b) for b in betas)
        # On the device once: a copy at every evaluate would make the host
        # wait for the device.
        self._betas = as_tensor(np.asarray(self.betas))
        if mean_functions is None:
            mean_functions = (None,) * n_out
        self.mean_functions = tuple(mean_functions)
        if len(self.mean_functions) != n_out:
            raise ValueError("need one mean function (or None) per output")
        noise = np.broadcast_to(
            np.asarray(noise_variances, dtype=config.np_dtype), (n_out,))
        self.noise_variances = as_tensor(noise.copy())

        x_buf = np.zeros((cap, d), dtype=config.np_dtype)
        y_buf = np.zeros((cap, n_out), dtype=config.np_dtype)
        x_buf[:n] = x
        y_buf[:n] = y
        self.X_buf = as_tensor(x_buf)
        self.Y_buf = as_tensor(y_buf)
        self.count = n
        self._host_caches, self.chol_inv, self.alpha = _stacked_cache(
            self.kernels, x_buf, y_buf, self.mean_functions, n,
            noise.astype(np.float64), self.scale)

    @classmethod
    def from_gps(cls, gps):
        """Batch single-output GPs that share training inputs."""
        gps = list(gps)
        for gp in gps:
            if not isinstance(gp, GaussianProcess):
                raise TypeError("from_gps needs GaussianProcess members")
            if gp.output_dim != 1:
                raise ValueError("stack members must be single-output")
        x0 = gps[0].X
        for gp in gps[1:]:
            if not np.array_equal(gp.X, x0):
                raise ValueError("stack members must share training inputs")
            if gp.scale != gps[0].scale:
                raise ValueError("stack members must share `scale`")
        y = (np.column_stack([gp.Y[:, 0] for gp in gps])
             if len(x0) else np.empty((0, len(gps))))
        return cls([gp.kernel for gp in gps], x0, y,
                   noise_variances=np.array([float(gp.noise_variance)
                                             for gp in gps]),
                   betas=np.array([gp.beta for gp in gps]),
                   mean_functions=[gp.mean_function for gp in gps],
                   capacity=max(gp.capacity for gp in gps),
                   scale=gps[0].scale)

    def unstack(self):
        """Per-output :class:`GaussianProcess` views (inverse of
        :meth:`from_gps`).

        The views reuse the stack's factors (sliced along the output axis)
        and its float64 host caches: nothing is refactorized.
        """
        views = []
        hosts = self._host_caches or (None,) * self.num_fun
        for s in range(self.num_fun):
            gp = object.__new__(GaussianProcess)
            gp.__dict__.update(
                kernel=self.kernels[s], beta=self.betas[s],
                scale=self.scale, input_dim=self.input_dim, output_dim=1,
                mean_function=self.mean_functions[s],
                noise_variance=self.noise_variances[s].clone(),
                X_buf=self.X_buf, Y_buf=self.Y_buf[:, s:s + 1].contiguous(),
                count=self.count, _host_cache=hosts[s],
                chol_inv=self.chol_inv[s], alpha=self.alpha[s])
            views.append(gp)
        return views

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

    def _prior_means(self, points):
        """Stacked prior means, shape ``(len(points), num_fun)``."""
        cols = []
        for fun in self.mean_functions:
            if fun is None:
                cols.append(torch.zeros((points.shape[0], 1),
                                        dtype=points.dtype,
                                        device=points.device))
            else:
                cols.append(fun(points).reshape(-1, 1))
        return torch.cat(cols, dim=1)

    # -- prediction -------------------------------------------------------
    def _programs(self):
        """``(programs, param_list)`` of all outputs in one parameter
        space, or ``None`` when a kernel does not compile."""
        from ..ops.gp_kernel import compile_kernel_program

        param_list, programs = [], []
        for kernel in self.kernels:
            compiled = compile_kernel_program(kernel,
                                              input_dim=self.input_dim,
                                              params=param_list)
            if compiled is None:
                return None
            program, param_list = compiled
            programs.append(program)
        return tuple(programs), param_list

    def predict(self, points, full_cov=False):
        """Posterior mean and variance for every output.

        Returns ``(mean, var)`` of shape ``(Q, num_fun)``, or with
        ``full_cov=True`` ``(mean, cov)`` where ``cov`` is
        ``(num_fun, Q, Q)`` (the outputs are independent GPs).

        With ``config.use_kernels``, every kernel compiling to a program,
        and ``num_fun * capacity**2 <= kernel_max_capacity**2``, all
        outputs run in one call of :func:`~safe_learning_tpu_torch.ops.
        gp_kernel.fused_gp_predict_stacked`. Otherwise each output takes
        the plain matmul chain, as the JAX package's XLA path.
        """
        points = torch.atleast_2d(as_tensor(points))
        s2 = self.scale ** 2
        mask = self._mask()

        if full_cov:
            means, covs = [], []
            for s in range(self.num_fun):
                a, mean = self._chain(s, points, mask)
                means.append(mean)
                covs.append(self.kernels[s](points, points)
                            - dot(a.T, a) / s2)
            mean = torch.cat(means, dim=1) + self._prior_means(points)
            return mean, torch.stack(covs, dim=0)

        compiled = None
        if (config.use_kernels and self.num_fun * self.capacity ** 2
                <= config.kernel_max_capacity ** 2):
            compiled = self._programs()
        if compiled is not None:
            from ..ops.gp_kernel import (fused_gp_predict_stacked,
                                         program_params)

            programs, param_list = compiled
            mean_num, var_num = fused_gp_predict_stacked(
                points, self.X_buf, program_params(param_list, points),
                self.chol_inv, self.alpha[:, :, 0], mask, s2, programs,
                count=self.count)
            mean = mean_num / self.scale + self._prior_means(points)
            kdiag = torch.stack([k.diag(points) for k in self.kernels],
                                dim=1)
            return mean, torch.clamp(kdiag - var_num / s2, min=1e-12)

        means, variances = [], []
        for s in range(self.num_fun):
            a, mean = self._chain(s, points, mask)
            means.append(mean)
            var = self.kernels[s].diag(points) - (a * a).sum(dim=0) / s2
            variances.append(torch.clamp(var, min=1e-12))
        mean = torch.cat(means, dim=1) + self._prior_means(points)
        return mean, torch.stack(variances, dim=1)

    def _chain(self, s, points, mask):
        """Output ``s``'s plain matmul chain: ``(a, mean numerator /
        scale)`` with ``a = L^-1 k``, as the JAX package's XLA path."""
        kx = (self.scale ** 2 * self.kernels[s](self.X_buf, points)
              * mask[:, None])
        a = dot(self.chol_inv[s], kx)
        return a, dot(a.T, self.alpha[s]) / self.scale

    def evaluate(self, points):
        """Return ``(mean, beta_s * std_s)`` stacked over outputs."""
        mean, var = self.predict(points)
        return mean, self._betas.to(var.dtype) * torch.sqrt(var)

    def log_marginal_likelihood(self, kernels=None, noise_variances=None):
        """Sum of the per-output exact log marginal likelihoods
        (``safe_learning_tpu/functions/gp.py:1142-1157``), differentiable
        with respect to the kernels' tensors and the noise variances."""
        kernels = self.kernels if kernels is None else kernels
        noises = (self.noise_variances if noise_variances is None
                  else torch.as_tensor(noise_variances))
        total = 0.0
        for s in range(self.num_fun):
            total = total + _log_marginal_likelihood(
                kernels[s], noises[s], self.X_buf, self.Y_buf[:, s:s + 1],
                self.mean_functions[s], self.count)
        return total

    def add_data_point(self, x, y):
        """Append measurements of every output; returns a new stack.

        One buffer append for all outputs, then each output's factors as
        :meth:`GaussianProcess.add_data_point` grows them; if one output's
        bordered append refuses, all are refactorized
        (``safe_learning_tpu/functions/gp.py:1160-1224``).
        """
        x = np.atleast_2d(np.asarray(x, dtype=config.np_dtype))
        y = np.atleast_2d(np.asarray(y, dtype=config.np_dtype))
        n, n_new = self.count, len(x)
        noises = _host(self.noise_variances).astype(np.float64)
        if n + n_new > self.capacity:
            return StackedGaussianProcess(
                self.kernels, np.vstack([self.X, x]), np.vstack([self.Y, y]),
                _host(self.noise_variances), betas=np.asarray(self.betas),
                mean_functions=self.mean_functions,
                capacity=_round_capacity(n + n_new), scale=self.scale)
        new = copy.copy(self)
        new.X_buf = _append_rows(self.X_buf, x, n)
        new.Y_buf = _append_rows(self.Y_buf, y, n)
        new.count = n + n_new
        # The factors below are float64 host ones again.
        new._device_appended = False
        hosts = self._host_caches
        hosts_new = None
        if hosts is not None and all(h.count == n for h in hosts):
            hosts_new = [_bordered_append(
                hosts[s], self.kernels[s], x, y[:, s:s + 1],
                self.mean_functions[s], float(noises[s]), self.scale,
                self.capacity) for s in range(self.num_fun)]
            if any(h is None for h in hosts_new):
                hosts_new = None
        if hosts_new is None:
            new._host_caches, new.chol_inv, new.alpha = _stacked_cache(
                self.kernels, _host(new.X_buf), _host(new.Y_buf),
                self.mean_functions, new.count, noises, self.scale)
        else:
            new._host_caches = hosts_new
            new.chol_inv, new.alpha = _upload_stacked(hosts_new)
        return new


def _stacked_cache(kernels, x_buf, y_buf, mean_functions, count, noises,
                   scale):
    """Per-output host factorizations, uploaded stacked along a leading
    output axis.

    Returns ``(hosts, chol_inv, alpha)``: the float64 :class:`_HostCache`
    of each output, ``chol_inv`` of shape ``(num_fun, cap, cap)`` and
    ``alpha`` of shape ``(num_fun, cap, 1)``, in the working dtype on
    ``config.device`` (counterpart of ``safe_learning_tpu/functions/
    gp.py:1227-1248``).
    """
    hosts = [_host_factorize(kernel, x_buf, y_buf[:, s:s + 1], mean,
                             count, float(noises[s]), scale)
             for s, (kernel, mean) in enumerate(zip(kernels,
                                                    mean_functions))]
    return (hosts,) + _upload_stacked(hosts)


def _upload_stacked(hosts):
    """``(chol_inv, alpha)`` of per-output host caches, stacked along a
    leading output axis, in the working dtype on ``config.device``."""
    # solve_triangular returns Fortran order; the kernels take row-major.
    chol_inv = np.ascontiguousarray(np.stack([h.chol_inv for h in hosts]))
    alpha = np.ascontiguousarray(np.stack([h.alpha for h in hosts]))
    return as_tensor(chol_inv), as_tensor(alpha)


def coerce_stacked(dynamics):
    """A ``FunctionStack`` of GPs becomes its :class:`StackedGaussianProcess`
    twin; anything else passes through unchanged.

    Members must share training inputs and ``scale``
    (:meth:`StackedGaussianProcess.from_gps` raises otherwise).
    """
    from .base import FunctionStack

    if isinstance(dynamics, FunctionStack) and dynamics.functions and \
            all(isinstance(f, GaussianProcess) for f in dynamics.functions):
        return StackedGaussianProcess.from_gps(dynamics.functions)
    return dynamics


# ---------------------------------------------------------------------------
# Hyperparameter fitting
# ---------------------------------------------------------------------------
def fit_gp_hyperparameters(gp, steps=150, learning_rate=0.05,
                           optimize_noise=True, min_noise=None,
                           method="adam", bounds=None):
    """Fit kernel hyperparameters by maximizing the log marginal likelihood.

    Counterpart of ``safe_learning_tpu/functions/gp.py:1275-1476``: the
    optimization runs in log space over every positive kernel tensor
    (:func:`_kernel_leaves`) and, with ``optimize_noise``, over the noise
    as ``min_noise + exp(.)``. ``method="adam"`` takes ``steps`` steps of
    ``torch.optim.Adam`` (optax's defaults, the same update) on the GP's
    device, each followed by the log-space box clip of ``bounds``;
    ``method="lbfgs"`` runs scipy's L-BFGS-B for at most ``steps``
    iterations on the host, driven by an autograd value and gradient,
    with ``bounds`` on the kernel coordinates and the noise coordinate
    pinned when it is not optimized. A :class:`StackedGaussianProcess` is
    fitted member by member and re-batched, the histories padded with each
    member's last value and summed.

    Parameters
    ----------
    gp : GaussianProcess or StackedGaussianProcess
    steps : int
    learning_rate : float
        Adam's step size (L-BFGS-B ignores it).
    optimize_noise : bool
    min_noise : float, optional
        Lower bound of the fitted noise (1e-8 in float64, 1e-6 in
        float32).
    method : {"adam", "lbfgs"}
    bounds : (lo, hi), optional
        Box on every kernel tensor, in its original (not log) space.

    Returns
    -------
    fitted : the GP with the fitted hyperparameters and a refreshed host
        factorization
    history : ndarray, the negative log marginal likelihood per Adam step
        or L-BFGS-B evaluation
    """
    if method not in ("adam", "lbfgs"):
        raise ValueError("method must be 'adam' or 'lbfgs', got "
                         + repr(method))
    if isinstance(gp, StackedGaussianProcess):
        fitted_members, histories = [], []
        for member in gp.unstack():
            fitted_member, history = fit_gp_hyperparameters(
                member, steps=steps, learning_rate=learning_rate,
                optimize_noise=optimize_noise, min_noise=min_noise,
                method=method, bounds=bounds)
            fitted_members.append(fitted_member)
            histories.append(history)
        width = max(len(h) for h in histories)
        histories = [np.concatenate([h, np.full(width - len(h),
                                                h[-1] if len(h) else 0.0)])
                     for h in histories]
        return (StackedGaussianProcess.from_gps(fitted_members),
                np.sum(histories, axis=0))

    if min_noise is None:
        min_noise = 1e-8 if config.dtype == torch.float64 else 1e-6
    device = gp.X_buf.device
    min_noise = torch.as_tensor(min_noise, dtype=config.dtype, device=device)
    leaves = _kernel_leaves(gp.kernel)
    start = [torch.log(torch.clamp(leaf, min=1e-12)).detach()
             for leaf in leaves]
    start.append(torch.log(torch.clamp(gp.noise_variance - min_noise,
                                       min=1e-12)).detach())

    def unpack(state):
        """``(kernel, noise)`` of the log parameters."""
        kernel = _with_kernel_leaves(gp.kernel,
                                     [torch.exp(t) for t in state[:-1]])
        noise = (min_noise + torch.exp(state[-1]) if optimize_noise
                 else gp.noise_variance)
        return kernel, noise

    def nll(state):
        """Negative log marginal likelihood of the log parameters."""
        return -_log_marginal_likelihood(*unpack(state), gp.X_buf, gp.Y_buf,
                                         gp.mean_function, gp.count)

    if method == "lbfgs":
        state, history = _fit_lbfgs(nll, start, steps, optimize_noise,
                                    bounds)
    else:
        state, history = _fit_adam(nll, start, steps, learning_rate,
                                   bounds)
    kernel, noise = unpack(state)
    fitted = copy.copy(gp)
    fitted.kernel = kernel
    fitted.noise_variance = noise.detach().to(config.dtype).clone()
    fitted._host_cache, fitted.chol_inv, fitted.alpha = _cache_parts(
        kernel, _host(gp.X_buf), _host(gp.Y_buf), gp.mean_function, gp.count,
        float(fitted.noise_variance), gp.scale)
    return fitted, history


def _fit_adam(nll, start, steps, learning_rate, bounds):
    """``steps`` Adam steps from the log parameters ``start``, the kernel
    coordinates clipped to the log-space box after each. Returns the
    final parameters (detached) and the loss before each step."""
    state = [t.clone().requires_grad_(True) for t in start]
    optimizer = torch.optim.Adam(state, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)
    losses = []
    for _ in range(int(steps)):
        optimizer.zero_grad()
        loss = nll(state)
        loss.backward()
        optimizer.step()
        if bounds is not None:
            lo = float(np.log(max(float(bounds[0]), 1e-12)))
            hi = float(np.log(float(bounds[1])))
            with torch.no_grad():
                for t in state[:-1]:
                    t.clamp_(lo, hi)
        losses.append(loss.detach())
    history = (torch.stack(losses).cpu().numpy() if losses
               else np.empty(0))
    return [t.detach() for t in state], history


def _fit_lbfgs(nll, start, steps, optimize_noise, bounds):
    """scipy's L-BFGS-B over the flat log parameters, float64 on the
    host, the value and gradient from autograd in the working dtype.
    Returns the final parameters and the loss of every evaluation."""
    import scipy.optimize

    shapes = [t.shape for t in start]
    sizes = [t.numel() for t in start]
    like = start[0]

    def to_vector(tensors):
        return np.concatenate([
            np.zeros(size) if t is None
            else t.detach().cpu().double().numpy().ravel()
            for t, size in zip(tensors, sizes)])

    def from_vector(vec):
        out, off = [], 0
        for size, shape in zip(sizes, shapes):
            out.append(torch.as_tensor(vec[off:off + size], dtype=like.dtype,
                                       device=like.device).reshape(shape))
            off += size
        return out

    history = []

    def objective(vec):
        state = [t.requires_grad_(True) for t in from_vector(vec)]
        loss = nll(state)
        grads = torch.autograd.grad(loss, state, allow_unused=True)
        value = float(loss.detach())
        history.append(value)
        return value, to_vector(grads)

    n_kernel = sum(sizes[:-1])
    box = None
    if bounds is not None:
        lo = float(np.log(max(float(bounds[0]), 1e-12)))
        hi = float(np.log(float(bounds[1])))
        box = [(lo, hi)] * n_kernel + [(None, None)]
    elif not optimize_noise:
        box = [(None, None)] * (n_kernel + 1)
    if not optimize_noise and box is not None:
        x0_noise = float(start[-1])
        box[-1] = (x0_noise, x0_noise)  # pin the noise coordinate
    result = scipy.optimize.minimize(
        objective, to_vector(start), jac=True, method="L-BFGS-B",
        bounds=box, options={"maxiter": int(steps)})
    return from_vector(result.x), np.asarray(history)


# ---------------------------------------------------------------------------
# Posterior function sampling
# ---------------------------------------------------------------------------
class GPSampledFunction(DeterministicFunction):
    """A posterior sample of a GP, evaluable anywhere.

    As ``safe_learning_tpu/functions/gp.py:1482-1540``, the sample is
    interpolated with the posterior covariance,
    ``f(x) = m_post(x) + Cov_post(x, D) Cov_post(D, D)^+ (s - m_post(D))``,
    which reproduces the sampled values on the discretization ``D`` and
    respects the GP's data everywhere. ``a_disc`` is ``L^-1 K(X, D)`` of
    the GP's cache and ``alpha`` the sample's ``(len(D), 1)`` coefficients.
    Calling the function returns noiseless values; ``noise_key`` (a
    ``torch.Generator``) adds a noisy measurement's noise.
    """

    output_dim = 1

    def __init__(self, gp, points, a_disc, alpha):
        self.gp = gp
        self.points = as_tensor(points)
        self.a_disc = as_tensor(a_disc)
        self.alpha = as_tensor(alpha)
        self.input_dim = int(self.points.shape[1])

    @property
    def noise_variance(self):
        """Observation-noise variance of the sampled GP."""
        return self.gp.noise_variance

    def __call__(self, *points, noise_key=None):
        """Evaluate (see the class docstring)."""
        values = self.evaluate(concatenate_inputs(*points))
        if noise_key is not None:
            values = values + torch.sqrt(self.noise_variance) * torch.randn(
                values.shape, generator=noise_key, dtype=values.dtype,
                device=noise_key.device).to(values.device)
        return values

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        gp = self.gp
        points = torch.atleast_2d(as_tensor(points))
        s2 = gp.scale ** 2
        kx = s2 * gp.kernel(gp.X_buf, points) * gp._mask()[:, None]
        a_x = dot(gp.chol_inv, kx)
        mean = dot(a_x.T, gp.alpha) / gp.scale + gp._prior_mean(points)
        cross = gp.kernel(points, self.points) - dot(a_x.T, self.a_disc) / s2
        return mean + dot(cross, self.alpha)


class StackedSampledFunction(DeterministicFunction):
    """Per-output posterior samples of a stacked GP as one multi-output
    function (``safe_learning_tpu/functions/gp.py:1543-1580``)."""

    def __init__(self, members):
        self.members = tuple(members)
        self.input_dim = self.members[0].input_dim
        self.output_dim = len(self.members)

    def __call__(self, *points, noise_key=None):
        """Evaluate (see the class docstring); the members draw their
        noise from ``noise_key`` in turn."""
        merged = concatenate_inputs(*points)
        return torch.cat([m(merged, noise_key=noise_key)
                          for m in self.members], dim=1)

    def evaluate(self, points):
        """Evaluate the function at ``points``."""
        return torch.cat([m.evaluate(points) for m in self.members], dim=1)


def _standard_normals(generator, number, n):
    """The sampler's standard normals: ``(number, n)`` float32 draws from
    ``generator``, as a float64 numpy array. The one source of the draws,
    so that a caller can feed another generator's numbers."""
    z = torch.randn((number, n), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return z.cpu().numpy().astype(np.float64)


def sample_gp_function(discretization, gp, key, number=1,
                       return_function=True, jitter=0.0, cut_rel=None):
    """Draw exact posterior samples of a GP on a discretization.

    Counterpart of ``safe_learning_tpu/functions/gp.py:1583-1691``. The
    draw is a float64 host island: the float64 copy of the GP
    (``oracle.lift64``) predicts the full posterior covariance at the
    float64 discretization (a grid's ``all_points_f64``), symmetrized;
    its eigendecomposition is truncated at ``cut_rel`` (default 1e-6) of
    the largest eigenvalue; float32 standard normals over the whole
    discretization (:func:`_standard_normals` from the ``torch.Generator``
    ``key``) are paired with the eigenpairs by absolute position, so an
    eigenvalue crossing the cut changes only its own term. ``jitter`` is
    added to the kept eigenvalues. A :class:`StackedGaussianProcess` is
    sampled member by member from the same generator.

    Returns ``number`` :class:`GPSampledFunction` (or
    :class:`StackedSampledFunction`) objects, or with
    ``return_function=False`` the samples as a ``(number, len(D))`` array
    (``(number, len(D), num_fun)`` for a stack) in the working dtype.
    """
    from ..grids import GridWorld
    from ..oracle import _oracle_env, lift64

    if isinstance(discretization, GridWorld):
        points64 = discretization.all_points_f64
    elif torch.is_tensor(discretization):
        points64 = discretization.detach().cpu().double().numpy()
    else:
        points64 = np.asarray(discretization, dtype=np.float64)

    if isinstance(gp, StackedGaussianProcess):
        per_out = [sample_gp_function(points64, member, key, number,
                                      return_function, jitter, cut_rel)
                   for member in gp.unstack()]
        if not return_function:
            return np.stack(per_out, axis=-1)
        return [StackedSampledFunction([per_out[s][i]
                                        for s in range(gp.num_fun)])
                for i in range(number)]

    with _oracle_env():
        gp64 = lift64(gp)
        mean, cov = gp64.predict(torch.as_tensor(points64), full_cov=True)
        mean64 = mean.numpy()[:, 0]
        cov64 = cov.numpy()
    cov64 = 0.5 * (cov64 + cov64.T)
    w, v = np.linalg.eigh(cov64)
    if cut_rel is None:
        cut_rel = 1e-6
    w_max = max(float(w[-1]), 0.0)
    keep = w > cut_rel * w_max
    wr = w[keep] + float(jitter)
    vr = v[:, keep]
    z = _standard_normals(key, number, len(points64))[:, keep]
    samples = mean64[None, :] + z @ (np.sqrt(wr)[:, None] * vr.T)
    if not return_function:
        return np.asarray(samples, dtype=config.np_dtype)

    # alpha_i = C^+ (sample_i - mean) = vr (z_i / sqrt(wr)).
    alphas = (z / np.sqrt(wr)) @ vr.T
    points = as_tensor(points64.astype(config.np_dtype))
    kx = gp.scale ** 2 * gp.kernel(gp.X_buf, points) * gp._mask()[:, None]
    a_disc = dot(gp.chol_inv, kx)
    return [GPSampledFunction(gp, points, a_disc,
                              as_tensor(alphas[i][:, None]))
            for i in range(number)]
