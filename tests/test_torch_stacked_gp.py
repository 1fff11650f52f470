"""The port's ``StackedGaussianProcess`` and the stacked predict's plain
twin against the JAX package.

``gp_predict_stacked_plain`` must match the Pallas kernel
``fused_gp_predict_stacked(..., interpret=True)``, run as
``tests/test_ops_gp_kernel.py:303`` runs it, on the JAX stack's own cache;
the stack's ``predict``, ``evaluate``, ``from_gps`` and ``unstack`` must
match the JAX package's; and, as ``tests/test_gp.py:422`` and ``:489``
check for the JAX package, the stack must equal the fan-out of its
members, alone and inside a Lyapunov sweep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu.functions.gp import ActiveDims, LinearKernel
from safe_learning_tpu.ops.gp_kernel import (compile_kernel_program as
                                             jax_compile,
                                             fused_gp_predict_stacked as
                                             jax_stacked)
from safe_learning_tpu_torch.functions.gp import coerce_stacked
from safe_learning_tpu_torch.ops import gp_kernel

from _torch_parity import (port_gp, port_stacked_gp, to_numpy,
                           working_dtype)

# float64: both sides evaluate the same programs and differ by summation
# order, amplified by |L^-1| (tests/test_torch_gp_kernel.py).
TOL = dict(rtol=1e-8, atol=1e-10)
# Two float64 factorizations of the same data (the port's and the JAX
# package's host islands) agree to about 1e-11 relative
# (tests/test_torch_gp.py::test_host_island_matches_jax).
MODEL_TOL = dict(rtol=1e-9, atol=1e-11)


def _jax_members(rng, n=9):
    """``tests/test_gp.py:397-419``: two single-output GPs with the
    notebooks' composite kernels and linear priors over shared inputs."""
    x = rng.uniform(-1, 1, size=(n, 3))
    y = np.column_stack([np.sin(2 * x[:, 0]) + 0.3 * x[:, 2],
                         np.cos(x[:, 1]) - 0.2 * x[:, 2]])
    gps = []
    for dim in range(2):
        kernel = (LinearKernel(variances=[0.3, 0.1, 0.4 + 0.1 * dim],
                               input_dim=3)
                  + ActiveDims(sl.Matern32(variance=1.0,
                                           lengthscales=0.8 + 0.2 * dim,
                                           input_dim=1), dims=[0])
                  * ActiveDims(LinearKernel(variances=0.4, input_dim=1),
                               dims=[0]))
        mean = sl.LinearSystem([[0.9, 0.1 * dim, 0.05]])
        gps.append(sl.GaussianProcess(kernel, x, y[:, dim:dim + 1],
                                      noise_variance=1e-4 * (1 + dim),
                                      beta=2.0 + dim, mean_function=mean))
    return gps


def _jax_stack(n_out, seed=13):
    """A JAX stack of ``n_out`` outputs with different kernels over 11
    points in 3 dimensions, scale 1.4 (``tests/test_ops_gp_kernel.py:
    311-322`` with a third output)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, size=(11, 3))
    y = np.column_stack([np.sin(x[:, 0] * 2), x[:, 1] - 0.3 * x[:, 2],
                         np.cos(x.sum(axis=1))])[:, :n_out]
    kernels = [
        LinearKernel(variances=[0.3, 0.1, 0.5], input_dim=3)
        + ActiveDims(sl.Matern32(variance=1.0, lengthscales=0.7,
                                 input_dim=1), dims=[0])
        * ActiveDims(LinearKernel(variances=0.4, input_dim=1), dims=[0]),
        sl.RBF(variance=0.8, lengthscales=[0.5, 0.9, 1.3], input_dim=3),
        ActiveDims(sl.Matern52(0.9, [0.6, 1.1], input_dim=2), dims=[0, 1])
        * ActiveDims(sl.Matern12(1.2, 0.8, input_dim=1), dims=[2]),
    ][:n_out]
    return sl.StackedGaussianProcess(kernels, x, y,
                                     [1e-4, 3e-4, 2e-4][:n_out], scale=1.4,
                                     capacity=16), rng


@pytest.mark.parametrize("n_out", [1, 2, 3])
def test_stacked_plain_matches_pallas_kernel(n_out):
    with working_dtype("float64"):
        stacked, rng = _jax_stack(n_out)
        q = rng.uniform(-2, 2, size=(143, 3))
        params, programs = [], []
        for kernel in stacked.kernels:
            program, params = jax_compile(kernel, input_dim=3,
                                          params=params)
            programs.append(program)
        jparams = jnp.concatenate([jnp.asarray(p).reshape(-1)
                                   for p in params])
        s2 = stacked.scale ** 2
        mean_j, var_j = jax_stacked(
            jnp.asarray(q), stacked.X_buf, jparams, stacked.chol_inv,
            stacked.alpha[:, :, 0], stacked._mask(), s2, tuple(programs),
            tile=128, interpret=True)
        pstack = port_stacked_gp(stacked, adopt=True)
        pprograms, pparams = pstack._programs()
        assert pprograms == tuple(programs)
        qt = torch.as_tensor(q)
        mean_t, var_t = gp_kernel.gp_predict_stacked_plain(
            qt, pstack.X_buf, gp_kernel.program_params(pparams, qt),
            pstack.chol_inv, pstack.alpha[:, :, 0], pstack._mask(), s2,
            pprograms)
    assert mean_t.shape == (143, n_out) and var_t.shape == (143, n_out)
    assert_allclose(to_numpy(mean_t), np.asarray(mean_j), **TOL)
    assert_allclose(to_numpy(var_t), np.asarray(var_j), **TOL)


def test_stacked_gradient_matches_pallas_jvp():
    with working_dtype("float64"):
        stacked, rng = _jax_stack(3, seed=12)
        q = rng.uniform(-1, 1, size=(40, 3))
        params, programs = [], []
        for kernel in stacked.kernels:
            program, params = jax_compile(kernel, input_dim=3,
                                          params=params)
            programs.append(program)
        args = (stacked.X_buf, jnp.concatenate(
            [jnp.asarray(p).reshape(-1) for p in params]),
            stacked.chol_inv, stacked.alpha[:, :, 0], stacked._mask(), 1.0)

        def loss(qs):
            mean, var = jax_stacked(qs, *args, tuple(programs), tile=128,
                                    interpret=True)
            return jnp.sum(mean ** 2) + jnp.sum(var)

        grad_j = np.asarray(jax.grad(loss)(jnp.asarray(q)))
        pstack = port_stacked_gp(stacked, adopt=True)
        pprograms, pparams = pstack._programs()
        qt = torch.as_tensor(q).requires_grad_(True)
        mean, var = gp_kernel.fused_gp_predict_stacked(
            qt, pstack.X_buf, gp_kernel.program_params(pparams, qt),
            pstack.chol_inv, pstack.alpha[:, :, 0], pstack._mask(), 1.0,
            pprograms)
        ((mean ** 2).sum() + var.sum()).backward()
    assert_allclose(qt.grad.numpy(), grad_j, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_stacked_predict_and_evaluate_match_jax(use_kernels):
    """The port's stack, factorized by its own host island, against the
    JAX stack: both ``predict`` branches and ``evaluate`` with per-output
    betas, through the fused route's twin and the matmul chain."""
    with working_dtype("float64"):
        stacked = sl.StackedGaussianProcess.from_gps(
            _jax_members(np.random.default_rng(4)))
        pstack = port_stacked_gp(stacked)
        q = np.random.default_rng(5).uniform(-1, 1, size=(33, 3))
        old = st.config.use_kernels
        st.config.use_kernels = use_kernels
        try:
            mean_t, var_t = map(to_numpy, pstack.predict(q))
            mean_e, err_t = map(to_numpy, pstack(q))
            mean_c, cov_t = map(to_numpy, pstack.predict(q[:7],
                                                         full_cov=True))
        finally:
            st.config.use_kernels = old
        mean_j, var_j = map(np.asarray, stacked.predict(q))
        _, err_j = map(np.asarray, stacked(q))
        _, cov_j = map(np.asarray, stacked.predict(q[:7], full_cov=True))
    assert var_t.shape == (33, 2) and cov_t.shape == (2, 7, 7)
    for got, want in ((mean_t, mean_j), (var_t, var_j), (mean_e, mean_j),
                      (err_t, err_j), (mean_c, mean_j[:7]),
                      (cov_t, cov_j)):
        assert_allclose(got, want, **MODEL_TOL)


def test_from_gps_and_unstack_match_jax():
    """``from_gps`` on the port's members equals the JAX ``from_gps``;
    ``unstack`` gives members that predict as the originals, reuse the
    stack's factors and carry every attribute of a ``GaussianProcess``."""
    with working_dtype("float64"):
        jgps = _jax_members(np.random.default_rng(6))
        pgps = [port_gp(g) for g in jgps]
        pstack = st.StackedGaussianProcess.from_gps(pgps)
        jstack = sl.StackedGaussianProcess.from_gps(jgps)
        q = np.random.default_rng(7).uniform(-1, 1, size=(9, 3))
        assert pstack.betas == jstack.betas
        assert_allclose(to_numpy(pstack.noise_variances),
                        np.asarray(jstack.noise_variances))
        for got, want in zip(map(to_numpy, pstack(q)), jstack(q)):
            assert_allclose(got, np.asarray(want), **MODEL_TOL)
        views = pstack.unstack()
        for orig, back, s in zip(pgps, views, range(2)):
            assert set(vars(back)) == set(vars(orig))
            assert back.chol_inv.data_ptr() == pstack.chol_inv[s].data_ptr()
            assert back._host_cache is pstack._host_caches[s]
            for got, want in zip(back.predict(q), orig.predict(q)):
                assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-12,
                                atol=1e-14)
        other = st.GaussianProcess(st.RBF(1.0, 1.0, input_dim=3),
                                   np.ones((9, 3)), np.zeros((9, 1)), 1e-4)
    with pytest.raises(ValueError, match="share training inputs"):
        st.StackedGaussianProcess.from_gps([pgps[0], other])
    with pytest.raises(TypeError):
        st.StackedGaussianProcess.from_gps([pgps[0], st.LinearSystem(
            np.ones((1, 3)))])


def test_stacked_equals_fan_out():
    """``tests/test_gp.py:422`` in the port: the batched stack reproduces
    the per-member ``FunctionStack`` (same kernels, data, priors, betas),
    and ``coerce_stacked`` turns the one into the other."""
    with working_dtype("float64"):
        gps = [port_gp(g) for g in _jax_members(np.random.default_rng(4))]
        stacked = st.StackedGaussianProcess.from_gps(gps)
        fan_out = st.FunctionStack(gps)
        q = np.random.default_rng(8).uniform(-1, 1, size=(33, 3))
        mean_s, err_s = map(to_numpy, stacked(q))
        mean_f, err_f = map(to_numpy, fan_out(q))
        _, var_s = map(to_numpy, stacked.predict(q))
        coerced = coerce_stacked(fan_out)
        mean_c, err_c = map(to_numpy, coerced(q))
    assert mean_s.shape == (33, 2)
    assert_allclose(mean_s, mean_f, atol=1e-9)
    assert_allclose(err_s, err_f, atol=1e-9)
    assert_allclose(err_s, np.array(stacked.betas) * np.sqrt(var_s),
                    atol=1e-12)
    assert isinstance(coerced, st.StackedGaussianProcess)
    assert_array_equal(mean_c, mean_s)
    assert_array_equal(err_c, err_s)
    assert coerce_stacked(gps[0]) is gps[0]


def test_stacked_and_fan_out_give_the_same_sweep():
    """``tests/test_gp.py:489`` in the port: the stack and the fan-out
    drive the same ``update_safe_set``."""
    with working_dtype("float64"):
        gps = [port_gp(g) for g in _jax_members(np.random.default_rng(7))]
        grid = st.GridWorld([[-0.5, 0.5], [-0.5, 0.5]], 21)
        policy = st.Saturation(st.LinearSystem([[-0.4, -0.6]]), -1.0, 1.0)
        v = st.QuadraticFunction(np.array([[1.0, 0.1], [0.1, 1.0]]))
        results = []
        for dyn in (st.StackedGaussianProcess.from_gps(gps),
                    st.FunctionStack(gps)):
            lyap = st.Lyapunov(grid, v, dyn, lipschitz_dynamics=0.9,
                               lipschitz_lyapunov=2.0, tau=0.01,
                               policy=policy,
                               initial_set=[grid.nindex // 2])
            lyap.update_safe_set()
            results.append((np.array(lyap.safe_set), lyap.c_max))
    assert_array_equal(results[0][0], results[1][0])
    assert_allclose(results[0][1], results[1][1], rtol=1e-12)


def test_kernel_routing_rule():
    """``num_fun * cap**2 <= kernel_max_capacity**2`` takes the fused route
    (one stacked launch); above it, or with a kernel that does not
    compile, each output takes the matmul chain. All agree."""
    class Weird(st.Matern32):
        pass

    with working_dtype("float64"):
        jstack, rng = _jax_stack(2)
        pstack = port_stacked_gp(jstack)
        q = rng.uniform(-1, 1, size=(21, 3))
        fused = pstack.predict(q)
        old = st.config.kernel_max_capacity
        st.config.kernel_max_capacity = 22  # 2 * 16**2 > 22**2
        try:
            assert 2 * pstack.capacity ** 2 > 22 ** 2
            chain = pstack.predict(q)
        finally:
            st.config.kernel_max_capacity = old
        weird = st.StackedGaussianProcess(
            [Weird(1.0, [0.5, 0.9, 1.3], input_dim=3)] * 2, pstack.X,
            pstack.Y, [1e-4, 3e-4], capacity=16)
        assert weird._programs() is None
        plain = st.StackedGaussianProcess(
            [st.Matern32(1.0, [0.5, 0.9, 1.3], input_dim=3)] * 2, pstack.X,
            pstack.Y, [1e-4, 3e-4], capacity=16)
        for got, want in zip(weird.predict(q), plain.predict(q)):
            assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-10,
                            atol=1e-12)
    for got, want in zip(fused, chain):
        assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-10,
                        atol=1e-12)


def test_unported_paths_raise():
    """Bad input raises. ``add_data_point``, which raised until online updates
    were ported, now appends to the stack and to a ``FunctionStack`` of
    its members alike (``tests/test_torch_gp_append.py`` holds it
    against the JAX package)."""
    with working_dtype("float64"):
        gps = [port_gp(g) for g in _jax_members(np.random.default_rng(9))]
        stacked = st.StackedGaussianProcess.from_gps(gps)
        grown = [model.add_data_point(np.ones((1, 3)), np.ones((1, 2)))
                 for model in (stacked, st.FunctionStack(gps))]
        q = np.random.default_rng(10).uniform(-1, 1, (7, 3))
        for got, want in zip(grown[0](q), grown[1](q)):
            assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-10,
                            atol=1e-12)
    assert grown[0].count == stacked.count + 1
    with pytest.raises(ValueError, match="one column per kernel"):
        st.StackedGaussianProcess(stacked.kernels, np.zeros((3, 3)),
                                  np.zeros((3, 3)), 1e-4)
