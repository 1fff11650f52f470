"""The port's Gaussian process against the JAX package's.

The float64 host island must give the JAX package's factors to f64
roundoff, a GP and its float64 oracle copy must share factors bit for
bit, and the posterior must match the JAX GP and the reference's pinned
values.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.oracle import lift64

from _torch_parity import (KINDS, jax_bench_lyapunov, port_gp, to_numpy,
                           working_dtype)


def _bench_gp_data():
    rng = np.random.default_rng(0)
    a = np.array([[0.25, 0.05], [0.0, 0.3]])
    x = np.column_stack([rng.uniform(-0.4, 0.4, 128),
                         rng.uniform(-0.4, 0.4, 128), np.zeros(128)])
    y = x[:, :2] @ a.T + 0.02 * np.sin(3 * x[:, :2])
    return a, x, y


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_host_island_matches_jax(dtype):
    """The bench GP's float64 factors agree with the JAX host cache."""
    a, x, y = _bench_gp_data()
    with working_dtype(dtype):
        jgp = sl.GaussianProcess(
            sl.RBF(1.0, [0.3] * 3, input_dim=3), x, y, noise_variance=1e-4,
            beta=2.0, mean_function=sl.LinearSystem([a, np.zeros((2, 1))]))
        pgp = port_gp(jgp)
    jhost, phost = jgp._host_cache, pgp._host_cache
    # The two packages assemble K with differently ordered f64 dot
    # products (ulp-level differences); cond(K) ~ 6e5 amplifies them to
    # ~4e-13 in the factor, ~2e-12 (relative) in alpha and ~1e-11
    # (relative) in the explicit inverse.
    assert_allclose(phost.chol, jhost.chol, rtol=0, atol=2e-12)
    assert_allclose(phost.alpha, jhost.alpha, rtol=0,
                    atol=1e-11 * np.max(np.abs(jhost.alpha)))
    assert_allclose(phost.chol_inv, jhost.chol_inv, rtol=0,
                    atol=5e-11 * np.max(np.abs(jhost.chol_inv)))
    assert phost.count == jhost.count and phost.jitter == jhost.jitter
    # Exactly lower-triangular, identity on the padding rows.
    assert not np.triu(phost.chol_inv, 1).any()
    assert pgp.chol_inv.dtype == getattr(torch, dtype)


def test_float32_gp_and_its_lift64_share_factors_bitwise():
    a, x, y = _bench_gp_data()
    with working_dtype("float32"):
        gp = st.GaussianProcess(
            st.RBF(1.0, [0.3] * 3, input_dim=3), x[:100], y[:100],
            noise_variance=1e-4, beta=2.0,
            mean_function=st.LinearSystem([a, np.zeros((2, 1))]))
    gp64 = lift64(gp)
    assert gp64.X_buf.dtype == torch.float64
    assert gp64.capacity == gp.capacity == 128
    for name in ("chol", "chol_inv", "alpha"):
        assert_array_equal(getattr(gp64._host_cache, name),
                           getattr(gp._host_cache, name))


def test_reference_pinned_posterior_values():
    """The golden values of ``tests/test_gp.py:281``: an RBF GP with unit
    hyperparameters on three points (the pinned test adds the third
    online; online learning is not ported, so it starts with all three)."""
    with working_dtype("float64"):
        gp = st.GaussianProcess(
            st.RBF(1.0, [1.0, 1.0], input_dim=2),
            np.array([[1.0, 0.0], [0.0, 1.0], [1.2, 2.3]]),
            np.array([[0.0], [1.0], [2.4]]), noise_variance=1.0, beta=2.0)
        test_points = np.array([[0.9, 0.1], [3.0, 2.0]])
        mean, error = map(to_numpy, gp(test_points))
        mean2, error2 = map(to_numpy, gp(test_points[:, [0]],
                                         test_points[:, [1]]))
    assert_allclose(mean, [[0.16371139], [0.22048311]], atol=1e-7)
    assert_allclose(error, [[1.37678679], [1.98183191]], atol=1e-7)
    assert_array_equal(mean, mean2)
    assert_array_equal(error, error2)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("use_kernels", [True, False])
def test_predict_matches_jax(kind, use_kernels):
    """Posterior mean and variance through both routes of ``predict``
    (the fused kernel's plain version and the matmul chain)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.0, 1.0, size=(23, 3))
    y = np.column_stack([np.sin(x.sum(axis=1)), np.cos(x[:, 0])])
    q = rng.uniform(-1.5, 1.5, size=(57, 3))
    jcls, pcls = KINDS[kind]
    with working_dtype("float64"):
        jgp = sl.GaussianProcess(jcls(0.8, [0.5, 0.9, 1.3], input_dim=3),
                                 x, y, noise_variance=1e-3, beta=2.5,
                                 scale=4.0)
        pgp = st.GaussianProcess(pcls(0.8, [0.5, 0.9, 1.3], input_dim=3),
                                 x, y, noise_variance=1e-3, beta=2.5,
                                 scale=4.0)
        old = st.config.use_kernels
        st.config.use_kernels = use_kernels
        try:
            mean_t, err_t = map(to_numpy, pgp(q))
        finally:
            st.config.use_kernels = old
        mean_j, err_j = map(np.asarray, jgp(q))
    assert mean_t.shape == (57, 2) and err_t.shape == (57, 2)
    assert_allclose(mean_t, mean_j, rtol=1e-9, atol=1e-11)
    assert_allclose(err_t, err_j, rtol=1e-9, atol=1e-11)


def test_full_covariance_and_capacity_routing():
    """``full_cov`` and a GP above ``kernel_max_capacity`` take the matmul
    chain; both agree with the JAX GP."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1.0, 1.0, size=(10, 2))
    y = np.sin(x[:, :1])
    q = rng.uniform(-1.0, 1.0, size=(7, 2))
    with working_dtype("float64"):
        jgp = sl.GaussianProcess(sl.Matern32(1.1, [0.6, 0.8], input_dim=2),
                                 x, y, noise_variance=1e-2, capacity=16)
        pgp = port_gp(jgp)
        mean_j, cov_j = map(np.asarray, jgp.predict(q, full_cov=True))
        mean_t, cov_t = map(to_numpy, pgp.predict(q, full_cov=True))
        old = st.config.kernel_max_capacity
        st.config.kernel_max_capacity = 8
        try:
            mean_c, var_c = map(to_numpy, pgp.predict(q))
        finally:
            st.config.kernel_max_capacity = old
    assert_allclose(mean_t, mean_j, rtol=1e-9, atol=1e-11)
    assert_allclose(cov_t, cov_j, rtol=1e-9, atol=1e-11)
    assert_allclose(mean_c, mean_j, rtol=1e-9, atol=1e-11)
    assert_allclose(var_c[:, 0], np.diag(cov_j), rtol=1e-9, atol=1e-11)


def test_bench_gp_posterior_matches_jax_at_grid_points():
    jlyap, _ = jax_bench_lyapunov(20)
    points = jlyap.discretization.all_points
    states = np.column_stack([points, np.zeros(len(points))])
    with working_dtype("float64"):
        pgp = port_gp(jlyap.dynamics)
        mean_t, err_t = map(to_numpy, pgp(states))
    mean_j, err_j = map(np.asarray, jlyap.dynamics(states))
    assert_allclose(mean_t, mean_j, rtol=1e-10, atol=1e-12)
    assert_allclose(err_t, err_j, rtol=1e-10, atol=1e-12)


def test_unported_paths_raise():
    """Bad input raises. ``add_data_point``, which raised until online updates
    were ported, now returns a grown GP and leaves the old one as it was
    (``tests/test_torch_gp_append.py`` holds it against the JAX
    package)."""
    with working_dtype("float64"):
        gp = st.GaussianProcess(st.RBF(1.0, 1.0), np.zeros((2, 1)),
                                np.zeros((2, 1)), noise_variance=0.1)
        grown = gp.add_data_point(np.ones((1, 1)), np.ones((1, 1)))
    assert (grown.count, gp.count) == (3, 2)
    assert_allclose(grown.Y[-1], [1.0])
    with pytest.raises(ValueError, match="capacity"):
        st.GaussianProcess(st.RBF(1.0, 1.0), np.zeros((9, 1)),
                           np.zeros((9, 1)), noise_variance=0.1,
                           capacity=8)
