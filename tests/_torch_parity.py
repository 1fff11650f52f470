"""Shared helpers for the parity tests of the PyTorch port.

Every parity test builds one instance from numpy data in both packages
and compares the outputs as numpy arrays. Tier-1 runs several pytest
workers at once, so torch is held to one intra-op thread here, and the
port, which runs on ``cuda:0`` by default, is asked for the CPU.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import convert

torch.set_num_threads(1)
st.config.device = "cpu"

KINDS = {"rbf": (sl.RBF, st.RBF), "matern12": (sl.Matern12, st.Matern12),
         "matern32": (sl.Matern32, st.Matern32),
         "matern52": (sl.Matern52, st.Matern52)}


@contextlib.contextmanager
def working_dtype(name):
    """Set both packages' working dtype (``"float32"`` or ``"float64"``).

    The tests' conftest turns JAX's x64 mode on, so float32 cases set the
    JAX package's dtype explicitly; both settings are restored after.
    """
    jax_old, port_old = sl.config._dtype, st.config.dtype
    sl.config.dtype = getattr(jnp, name)
    st.config.dtype = getattr(torch, name)
    try:
        yield
    finally:
        sl.config._dtype = jax_old
        st.config.dtype = port_old


def to_numpy(value):
    """Numpy copy of a JAX array or a torch tensor."""
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def port_kernel(kernel):
    """The port's copy of a JAX kernel tree: stationary, linear,
    ``ActiveDims``, sums and products, through ``convert``."""
    from safe_learning_tpu.functions.gp import (ActiveDims, LinearKernel,
                                                ProductKernel, SumKernel)

    kinds = {cls: name for name, (cls, _) in KINDS.items()}
    if type(kernel) in kinds:
        return convert.stationary_kernel(kinds[type(kernel)],
                                         np.asarray(kernel.variance),
                                         np.asarray(kernel.lengthscales))
    if isinstance(kernel, LinearKernel):
        return convert.linear_kernel(np.asarray(kernel.variances))
    if isinstance(kernel, ActiveDims):
        return convert.active_dims(port_kernel(kernel.kernel), kernel.dims)
    if isinstance(kernel, SumKernel):
        return convert.sum_kernel(port_kernel(kernel.k1),
                                  port_kernel(kernel.k2))
    if isinstance(kernel, ProductKernel):
        return convert.product_kernel(port_kernel(kernel.k1),
                                      port_kernel(kernel.k2))
    raise TypeError("no converter for {}".format(type(kernel).__name__))


def port_mean(fun):
    """The port's copy of a JAX ``LinearSystem`` prior mean (or None)."""
    if fun is None:
        return None
    return convert.linear_system(np.asarray(fun.matrix))


def port_gp(gp, adopt=False):
    """The port's copy of a JAX GP with a ``LinearSystem`` or no prior.

    ``adopt=True`` feeds the port the JAX GP's own cache.
    """
    mean = port_mean(gp.mean_function)
    cache = None
    if adopt:
        cache = dict(chol_inv=np.asarray(gp.chol_inv),
                     alpha=np.asarray(gp.alpha),
                     X_buf=np.asarray(gp.X_buf), count=int(gp.count))
    return convert.gaussian_process(
        port_kernel(gp.kernel), gp.X, gp.Y, float(gp.noise_variance),
        beta=gp.beta, scale=gp.scale, capacity=gp.capacity,
        mean_function=mean, adopt=cache)


def port_stacked_gp(gp, adopt=False):
    """The port's copy of a JAX ``StackedGaussianProcess`` with
    ``LinearSystem`` or no priors; ``adopt=True`` feeds it the JAX stack's
    own cache."""
    cache = None
    if adopt:
        cache = dict(chol_inv=np.asarray(gp.chol_inv),
                     alpha=np.asarray(gp.alpha),
                     X_buf=np.asarray(gp.X_buf), count=int(gp.count))
    return convert.stacked_gaussian_process(
        [port_kernel(k) for k in gp.kernels], gp.X, gp.Y,
        np.asarray(gp.noise_variances), betas=np.asarray(gp.betas),
        scale=gp.scale, capacity=gp.capacity,
        mean_functions=[port_mean(m) for m in gp.mean_functions],
        adopt=cache)


def flagship_pair(num_points, route, tau=None):
    """The flagship instance in both packages, on the same numbers.

    The port builds it (``chip_smoke.build_flagship_instance``); the JAX
    package's twin takes the port's linearizations, LQR solution,
    measurements and initial set, and builds its GPs as
    ``examples/inverted_pendulum.py:27-48`` (stacked) or
    ``examples/adaptive_safety_verification.py:53-57`` (fan-out) do.
    Returns ``(port_lyapunov, jax_lyapunov, inst)``.
    """
    from chip_smoke import build_flagship_instance

    lyap, inst = build_flagship_instance(num_points, route=route, tau=tau)
    a, b, variances = inst["a"], inst["b"], inst["variances"]
    kernels, means = [], []
    for dim in range(2):
        kernels.append(
            sl.LinearKernel(variances=variances[dim], input_dim=3)
            + sl.ActiveDims(sl.Matern32(lengthscales=1.0, input_dim=1),
                            dims=[0])
            * sl.ActiveDims(sl.LinearKernel(variances=variances[dim, 1],
                                            input_dim=1), dims=[0]))
        means.append(sl.LinearSystem([a[[dim]], b[[dim]]]))
    xu, meas, noise = inst["xu"], inst["meas"], inst["noise"]
    if route == "stacked":
        dynamics = sl.StackedGaussianProcess(
            kernels, xu, meas, noise_variances=noise, betas=2.0,
            mean_functions=means, capacity=32)
    else:
        dynamics = sl.FunctionStack([
            sl.GaussianProcess(kernel, xu, meas[:, dim:dim + 1],
                               noise_variance=noise, beta=2.0,
                               mean_function=mean, capacity=32)
            for dim, (kernel, mean) in enumerate(zip(kernels, means))])
    policy = sl.Saturation(sl.LinearSystem(-inst["k"]), -1.0, 1.0)
    grid = sl.GridWorld([[-2.0, 2.0], [-1.5, 1.5]], num_points)
    jlyap = sl.Lyapunov(grid, sl.QuadraticFunction(inst["s"]), dynamics,
                        inst["lf"], inst["lv"], inst["tau"], policy,
                        initial_set=inst["initial_set"])
    return lyap, jlyap, inst


def adaptive_pair(num_states, capacity, route="stacked"):
    """The adaptive example's instance in both packages.

    The JAX twin from ``examples/adaptive_safety_verification.
    build_instance``, the port's from ``chip_smoke.build_adaptive_instance``
    (``route`` "stacked" or "fan_out"), each built by its own package. The
    pieces must agree: the Riccati matrix ``P``, the gain ``K``, the prior
    variances, ``tau``, ``L_f``, the initial set and the GP's data.
    Returns ``(port_lyapunov, jax_lyapunov, inst)``.
    """
    from chip_smoke import build_adaptive_instance
    from examples.adaptive_safety_verification import build_instance

    jlyap, jtrue = build_instance(num_states, capacity=capacity,
                                  stacked=route == "stacked")
    lyap, inst = build_adaptive_instance(num_states, capacity, route)
    assert_allclose(inst["p"], np.asarray(jlyap.lyapunov_function.matrix),
                    rtol=1e-12)
    assert_allclose(-inst["k"], np.asarray(jlyap.policy.fun.matrix),
                    rtol=1e-12)
    jgps = (jlyap.dynamics.unstack() if route == "stacked"
            else jlyap.dynamics.functions)
    gps = (lyap.dynamics.unstack() if route == "stacked"
           else lyap.dynamics.functions)
    for dim, (gp, jgp) in enumerate(zip(gps, jgps)):
        assert_allclose(inst["variances"][dim],
                        np.asarray(jgp.kernel.k1.variances), rtol=1e-12)
        assert_array_equal(gp.X, np.asarray(jgp.X))
        assert_array_equal(gp.Y, np.asarray(jgp.Y))
        assert gp.capacity == jgp.capacity == capacity
    assert lyap.tau == jlyap.tau
    assert_allclose(lyap._lipschitz_dynamics, jlyap._lipschitz_dynamics,
                    rtol=1e-12)
    assert_array_equal(lyap.initial_safe_set, jlyap.initial_safe_set)
    assert_array_equal(lyap.discretization.all_points,
                       jlyap.discretization.all_points)
    inst["jax_true"] = jtrue
    return lyap, jlyap, inst


def jax_bench_lyapunov(n_points):
    """``bench.py``'s instance in the JAX package, with its raw data."""
    from bench import _build_instance

    (grid, policy, v, lv, lf, gp, tau, initial_set, a, x_train, y_train,
     params) = _build_instance(n_points=n_points)
    lyap = sl.Lyapunov(grid, v, gp, lf, lv, tau, policy,
                       initial_set=initial_set)
    return lyap, dict(a=a, x_train=x_train, y_train=y_train, params=params,
                      lf=lf, tau=tau, initial_set=initial_set)


def port_bench_lyapunov(n_points):
    """``bench.py``'s instance in the port, from
    ``chip_smoke.build_bench_instance``."""
    from chip_smoke import build_bench_instance

    inst = build_bench_instance(n_points)
    lyap = st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                       inst["lv"], inst["tau"], inst["policy"],
                       initial_set=inst["initial_set"])
    return lyap, inst


def variant_inputs(cap, n, d, p, seed, n_q=517):
    """Kernel 1's inputs as numpy float64, from a numpy seed: ``n`` of
    ``cap`` rows active (x zero, chol_inv the identity and the mask zero
    past them), chol_inv the inverse Cholesky factor of an RBF Gram
    matrix with noise 1e-2, and ``n_q`` queries, all divided by
    lengthscales between 0.7 and 1.4. Returns ``(q, x, chol_inv, alpha,
    mask, var_s2)``."""
    rng = np.random.default_rng(seed)
    ls = np.linspace(0.7, 1.4, d)
    x = np.zeros((cap, d))
    x[:n] = rng.uniform(-1.0, 1.0, (n, d)) / ls
    q = rng.uniform(-1.2, 1.2, (n_q, d)) / ls
    r2 = ((x[:n, None, :] - x[None, :n, :]) ** 2).sum(-1)
    gram = np.exp(-0.5 * r2) + 1e-2 * np.eye(n)
    chol_inv = np.eye(cap)
    chol_inv[:n, :n] = np.linalg.inv(np.linalg.cholesky(gram))
    alpha = np.zeros((cap, p))
    alpha[:n] = rng.normal(size=(n, p))
    mask = (np.arange(cap) < n).astype(float)
    return q, x, chol_inv, alpha, mask, 1.3


def variant_scales(q, x, chol_inv, alpha, mask, var_s2, kind):
    """The absolute sums behind each output, in float64: ``w^T |alpha|``
    for the means and ``sum w^2`` for the variances, ``w = |chol_inv|
    |k|`` with k by per-dimension differences."""
    from safe_learning_tpu_torch.functions.gp import STATIONARY_COVARIANCES

    r2 = ((x[:, None, :] - q[None, :, :]) ** 2).sum(-1)
    k = STATIONARY_COVARIANCES[kind](torch.as_tensor(r2)).numpy()
    w = np.abs(chol_inv) @ np.abs(k * var_s2 * mask[:, None])
    return w.T @ np.abs(alpha), (w * w).sum(0)


def assert_within_scales(got, want, scales, tol):
    """``|got - want| <= tol * scale`` elementwise for both outputs."""
    for g, w, s in zip(got, want, scales):
        err = np.abs(to_numpy(g).astype(float) - to_numpy(w).astype(float))
        assert np.all(err <= tol * s), (err / s).max()
