"""GP log marginal likelihood, hyperparameter fitting and posterior
sampling against the JAX package, in float64.

The likelihood and its gradient agree to 1e-10 (the same masked Cholesky
and triangular solve, summed in another order). The Adam fit runs the same
update (``torch.optim.Adam`` and optax's ``adam`` with the same defaults),
so its history and hyperparameters agree to 1e-9 relative after dozens of
steps; L-BFGS-B is scipy's in both packages, driven by gradients that
agree to rounding, so its final value agrees to 1e-8 and its parameters to
1e-5. The samples are fed the JAX package's normals (the two packages'
generators differ); the float64 island is the same numpy eigh on
covariances that agree to about 1e-13, so samples and their interpolants
agree to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.functions import gp as gp_mod

from _torch_parity import (port_gp, port_kernel, port_stacked_gp, to_numpy,
                           working_dtype)


def _rbf_data(seed, n=24, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, d))
    y = np.sin(1.5 * x[:, :1]) + 0.3 * x[:, 1:2] \
        + 0.05 * rng.standard_normal((n, 1))
    return x, y


def _one_d_kernel(lib):
    """The 1-D example's kernel, ``Matern32 * Linear`` on column 0."""
    return (lib.ActiveDims(lib.Matern32(variance=0.4 ** 2, lengthscales=1.0,
                                        input_dim=1), dims=[0])
            * lib.ActiveDims(lib.LinearKernel(variances=1.0, input_dim=1),
                             dims=[0]))


def _jax_gps(kind):
    """A JAX GP of each test family: an ARD RBF at a padded capacity with a
    linear prior, or the 1-D example's composite kernel on (x, 0)."""
    if kind == "rbf":
        x, y = _rbf_data(3)
        return sl.GaussianProcess(sl.RBF(0.8, [0.6, 1.1], input_dim=2), x, y,
                                  noise_variance=1e-2, capacity=32,
                                  mean_function=sl.LinearSystem(
                                      [[0.2, -0.1]]))
    rng = np.random.default_rng(7)
    x = np.column_stack([rng.uniform(-1, 1, 18), np.zeros(18)])
    y = 0.25 * x[:, :1] + 0.1 * np.sin(4 * x[:, :1])
    return sl.GaussianProcess(_one_d_kernel(sl), x, y,
                              noise_variance=0.01 ** 2, capacity=32,
                              mean_function=sl.LinearSystem([[0.25, 0.0]]))


def _leaves(kernel):
    return [to_numpy(t) for t in gp_mod._kernel_leaves(kernel)]


def test_kernel_leaves_follow_the_jax_tree_order():
    with working_dtype("float64"):
        jkernel = (sl.RBF(0.7, [0.3, 0.4], input_dim=2)
                   + _one_d_kernel(sl) * sl.LinearKernel([0.2, 0.5],
                                                         input_dim=2))
        kernel = port_kernel(jkernel)
        got = _leaves(kernel)
        want = [np.asarray(t) for t in jax.tree_util.tree_leaves(jkernel)]
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert_array_equal(g, w)
        rebuilt = gp_mod._with_kernel_leaves(
            kernel, [2.0 * t for t in gp_mod._kernel_leaves(kernel)])
        for g, w in zip(_leaves(rebuilt), want):
            assert_array_equal(g, 2.0 * w)
        # The original tree is left as it was.
        for g, w in zip(_leaves(kernel), want):
            assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["rbf", "one_d"])
def test_log_marginal_likelihood_and_gradient_match_jax(kind):
    """The masked likelihood at a padded capacity, and its gradient with
    respect to every kernel tensor and the noise, to 1e-10."""
    with working_dtype("float64"):
        jgp = _jax_gps(kind)
        gp = port_gp(jgp)
        want = float(jgp.log_marginal_likelihood())
        jgrads = jax.grad(lambda k, n: jgp.log_marginal_likelihood(k, n),
                          argnums=(0, 1))(jgp.kernel, jgp.noise_variance)
        leaves = [t.clone().requires_grad_(True)
                  for t in gp_mod._kernel_leaves(gp.kernel)]
        noise = gp.noise_variance.clone().requires_grad_(True)
        lml = gp.log_marginal_likelihood(
            gp_mod._with_kernel_leaves(gp.kernel, leaves), noise)
        grads = torch.autograd.grad(lml, leaves + [noise])
    assert_allclose(float(lml.detach()), want, rtol=1e-10)
    want_grads = jax.tree_util.tree_leaves(jgrads[0]) + [jgrads[1]]
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        assert_allclose(to_numpy(g), np.asarray(w), rtol=1e-10,
                        atol=1e-10 * np.abs(np.asarray(w)).max())


def test_stacked_log_marginal_likelihood_matches_jax():
    """The stacked sum, and its gradient in the noise variances."""
    x, y = _rbf_data(9, n=20)
    y2 = np.column_stack([y[:, 0], np.cos(x[:, 1])])
    with working_dtype("float64"):
        jst = sl.StackedGaussianProcess(
            [sl.RBF(0.6, [1.0, 0.7], input_dim=2), _one_d_kernel(sl)], x, y2,
            noise_variances=[0.05, 0.02], capacity=32)
        stacked = port_stacked_gp(jst)
        want = float(jst.log_marginal_likelihood())
        jgrad = jax.grad(lambda n: jst.log_marginal_likelihood(
            noise_variances=n))(jst.noise_variances)
        noises = stacked.noise_variances.clone().requires_grad_(True)
        lml = stacked.log_marginal_likelihood(noise_variances=noises)
        (grad,) = torch.autograd.grad(lml, [noises])
        members = sum(float(g.log_marginal_likelihood())
                      for g in stacked.unstack())
    assert_allclose(float(lml.detach()), want, rtol=1e-10)
    assert_allclose(members, want, rtol=1e-10)
    assert_allclose(to_numpy(grad), np.asarray(jgrad), rtol=1e-10)


def _compare_fits(got, want, history, jhistory, rtol, param_rtol):
    fitted, jfitted = got, want
    assert_allclose(history[-1], jhistory[-1], rtol=rtol)
    for g, w in zip(_leaves(fitted.kernel),
                    jax.tree_util.tree_leaves(jfitted.kernel)):
        assert_allclose(g, np.asarray(w), rtol=param_rtol)
    assert_allclose(float(fitted.noise_variance),
                    float(jfitted.noise_variance), rtol=param_rtol)


@pytest.mark.parametrize("kind", ["rbf", "one_d"])
def test_adam_fit_matches_jax(kind):
    """60 Adam steps with bounds: every step's loss and the fitted
    hyperparameters to 1e-9 relative; the returned GP's factors are the
    host island's for the fitted model."""
    with working_dtype("float64"):
        jgp = _jax_gps(kind)
        gp = port_gp(jgp)
        jfitted, jhistory = sl.fit_gp_hyperparameters(
            jgp, steps=60, learning_rate=0.05, bounds=(1e-3, 20.0))
        fitted, history = st.fit_gp_hyperparameters(
            gp, steps=60, learning_rate=0.05, bounds=(1e-3, 20.0))
        refit = gp_mod.GaussianProcess(
            fitted.kernel, fitted.X, fitted.Y, float(fitted.noise_variance),
            mean_function=fitted.mean_function, capacity=fitted.capacity)
    assert history.shape == (60,)
    assert history[-1] < history[0]
    assert_allclose(history, np.asarray(jhistory), rtol=1e-9)
    _compare_fits(fitted, jfitted, history, jhistory, 1e-9, 1e-9)
    assert_allclose(to_numpy(fitted.chol_inv), to_numpy(refit.chol_inv),
                    rtol=0, atol=0)
    assert fitted._host_cache is not None and fitted.count == gp.count
    # The input GP is unchanged.
    for g, w in zip(_leaves(gp.kernel),
                    jax.tree_util.tree_leaves(jgp.kernel)):
        assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("kind", ["rbf", "one_d"])
def test_lbfgs_fit_matches_jax(kind):
    """L-BFGS-B: the final likelihood to 1e-8 relative, the parameters to
    1e-5, within the bounds; with the noise pinned it stays as it was."""
    with working_dtype("float64"):
        jgp = _jax_gps(kind)
        gp = port_gp(jgp)
        jfitted, jhistory = sl.fit_gp_hyperparameters(jgp, steps=100,
                                                      method="lbfgs")
        fitted, history = st.fit_gp_hyperparameters(gp, steps=100,
                                                    method="lbfgs")
        _compare_fits(fitted, jfitted, history, jhistory, 1e-8, 1e-5)
        assert history[-1] < history[0]

        bounds = (0.5, 1.5)
        jpinned, jph = sl.fit_gp_hyperparameters(
            jgp, steps=100, method="lbfgs", bounds=bounds,
            optimize_noise=False)
        pinned, ph = st.fit_gp_hyperparameters(
            gp, steps=100, method="lbfgs", bounds=bounds,
            optimize_noise=False)
    _compare_fits(pinned, jpinned, ph, jph, 1e-8, 1e-5)
    for leaf in _leaves(pinned.kernel):
        assert np.all(leaf >= bounds[0] - 1e-9)
        assert np.all(leaf <= bounds[1] + 1e-9)
    assert float(pinned.noise_variance) == float(gp.noise_variance)


@pytest.mark.parametrize("method", ["adam", "lbfgs"])
def test_stacked_fit_matches_jax(method):
    """A stack is fitted member by member; the padded, summed history and
    each member's hyperparameters match the JAX package's."""
    x, y = _rbf_data(11, n=20)
    y2 = np.column_stack([y[:, 0], np.cos(x[:, 1]) + 0.5 * np.sin(x[:, 0])])
    steps = 40 if method == "adam" else 30
    with working_dtype("float64"):
        jst = sl.StackedGaussianProcess(
            [sl.RBF(0.6, [1.0, 0.7], input_dim=2),
             sl.Matern52(0.9, [0.8, 1.2], input_dim=2)], x, y2,
            noise_variances=[0.05, 0.02], capacity=32)
        stacked = port_stacked_gp(jst)
        jfitted, jhistory = sl.fit_gp_hyperparameters(jst, steps=steps,
                                                      method=method)
        fitted, history = st.fit_gp_hyperparameters(stacked, steps=steps,
                                                    method=method)
    assert isinstance(fitted, st.StackedGaussianProcess)
    assert history.shape == np.asarray(jhistory).shape
    rtol, param_rtol = (1e-9, 1e-9) if method == "adam" else (1e-8, 1e-5)
    assert_allclose(history, np.asarray(jhistory),
                    rtol=rtol if method == "adam" else 1e-6)
    assert_allclose(history[-1], jhistory[-1], rtol=rtol)
    for k, jk in zip(fitted.kernels, jfitted.kernels):
        for g, w in zip(_leaves(k), jax.tree_util.tree_leaves(jk)):
            assert_allclose(g, np.asarray(w), rtol=param_rtol)
    assert_allclose(to_numpy(fitted.noise_variances),
                    np.asarray(jfitted.noise_variances), rtol=param_rtol)


@pytest.fixture
def jax_normals(monkeypatch):
    """Feed the port's sampler the JAX package's normals: ``keys`` holds
    the JAX keys in the order the port draws (one per ``sample_gp_function``
    call on a single GP)."""
    keys = []

    def normals(generator, number, n):
        key = keys.pop(0)
        return np.asarray(jax.random.normal(key, (number, n), jnp.float32),
                          dtype=np.float64)

    monkeypatch.setattr(gp_mod, "_standard_normals", normals)
    return keys


def _sampling_gp():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(5, 1))
    return sl.GaussianProcess(sl.RBF(1.0, 0.4, input_dim=1), x,
                              np.sin(2 * x), 1e-6)


def test_full_covariance_matches_jax():
    """The float64 island's input: the full posterior covariance of the
    lifted GP, to about 1e-13."""
    with working_dtype("float64"):
        for jgp in (_sampling_gp(), _jax_gps("one_d")):
            gp = port_gp(jgp)
            pts = np.column_stack([np.linspace(-1, 1, 41)]
                                  + [np.zeros(41)] * (gp.input_dim - 1))
            jmean, jcov = jgp.predict(pts, full_cov=True)
            mean, cov = st.oracle.lift64(gp).predict(
                torch.as_tensor(pts), full_cov=True)
            assert_allclose(to_numpy(mean), np.asarray(jmean), rtol=1e-13,
                            atol=1e-13)
            assert_allclose(to_numpy(cov), np.asarray(jcov), rtol=0,
                            atol=1e-13)


def test_sample_gp_function_matches_jax(jax_normals):
    """Samples on a grid and their interpolants off it, fed JAX's
    normals, to 1e-8; the interpolant reproduces the samples; a noisy
    call adds noise of the GP's scale."""
    key = jax.random.PRNGKey(0)
    off_grid = np.linspace(-0.97, 0.93, 17)[:, None]
    with working_dtype("float64"):
        jgp = _sampling_gp()
        gp = port_gp(jgp)
        grid, jgrid = st.GridWorld([[-1, 1]], 31), sl.GridWorld([[-1, 1]],
                                                                 31)
        jraw = sl.sample_gp_function(jgrid, jgp, key, number=2,
                                     return_function=False)
        jfuns = sl.sample_gp_function(jgrid, jgp, key, number=2)
        jax_normals.extend([key, key])
        raw = st.sample_gp_function(grid, gp, torch.Generator(), number=2,
                                    return_function=False)
        funs = st.sample_gp_function(grid, gp, torch.Generator(), number=2)
        got = [to_numpy(f(off_grid)) for f in funs]
        on_grid = to_numpy(funs[0](grid.all_points))
        noisy = to_numpy(funs[0](off_grid,
                                 noise_key=torch.Generator().manual_seed(1)))
    assert raw.shape == (2, 31) and len(funs) == 2
    assert isinstance(funs[0], st.GPSampledFunction)
    assert_allclose(raw, np.asarray(jraw), rtol=0, atol=1e-8)
    for g, jf in zip(got, jfuns):
        assert_allclose(g, np.asarray(jf(off_grid)), rtol=0, atol=1e-8)
    assert_allclose(on_grid[:, 0], raw[0], atol=1e-6)
    assert not np.allclose(noisy, got[0])
    assert_allclose(noisy, got[0], atol=1e-2)


def test_sample_stacked_gp_function_matches_jax(jax_normals):
    """A stack is sampled member by member with JAX's split keys."""
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, size=(9, 3))
    y = np.column_stack([np.sin(2 * x[:, 0]) + 0.3 * x[:, 2],
                         np.cos(x[:, 1]) - 0.2 * x[:, 2]])
    disc = rng.uniform(-1, 1, size=(40, 3))
    q = rng.uniform(-1, 1, size=(13, 3))
    key = jax.random.PRNGKey(7)
    with working_dtype("float64"):
        jst = sl.StackedGaussianProcess(
            [sl.Matern32(1.0, [0.8, 0.9, 1.1], input_dim=3),
             sl.LinearKernel([0.3, 0.1, 0.4], input_dim=3)
             + sl.ActiveDims(sl.RBF(0.5, 0.7, input_dim=1), dims=[1])], x, y,
            noise_variances=[1e-4, 2e-4], mean_functions=[
                sl.LinearSystem([[0.9, 0.0, 0.05]]), None])
        stacked = port_stacked_gp(jst)
        jraw = sl.sample_gp_function(disc, jst, key, number=3,
                                     return_function=False)
        jfuns = sl.sample_gp_function(disc, jst, key, number=3)
        split = list(jax.random.split(key, 2))
        jax_normals.extend(split + split)
        raw = st.sample_gp_function(disc, stacked, torch.Generator(),
                                    number=3, return_function=False)
        funs = st.sample_gp_function(disc, stacked, torch.Generator(),
                                     number=3)
        got = [to_numpy(f(q)) for f in funs]
    assert raw.shape == (3, 40, 2)
    assert isinstance(funs[0], st.StackedSampledFunction)
    assert funs[0].output_dim == 2 and funs[0].input_dim == 3
    assert_allclose(raw, np.asarray(jraw), rtol=0, atol=1e-8)
    for g, jf in zip(got, jfuns):
        assert g.shape == (13, 2)
        assert_allclose(g, np.asarray(jf(q)), rtol=0, atol=1e-8)


@pytest.mark.parametrize("cut_rel", [1e-12, 1e-2])
def test_sample_truncation_pairing_matches_jax(jax_normals, cut_rel):
    """``tests/test_gp.py``'s truncation-pairing case in both packages: at
    either cut the samples are the JAX package's, and the two cuts share
    their dominant eigenpairs."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, size=(6, 1))
    key = jax.random.PRNGKey(7)
    with working_dtype("float64"):
        jgp = sl.GaussianProcess(sl.RBF(1.0, 0.4, input_dim=1), x,
                                 np.sin(2 * x), 1e-6)
        gp = port_gp(jgp)
        grid, jgrid = st.GridWorld([[-1, 1]], 41), sl.GridWorld([[-1, 1]],
                                                                 41)
        want = [sl.sample_gp_function(jgrid, jgp, key, return_function=False,
                                      cut_rel=c)[0] for c in (cut_rel, 1e-6)]
        jax_normals.extend([key, key])
        got = [st.sample_gp_function(grid, gp, torch.Generator(),
                                     return_function=False, cut_rel=c)[0]
               for c in (cut_rel, 1e-6)]
    for g, w in zip(got, want):
        assert_allclose(g, np.asarray(w), rtol=0, atol=1e-8)
    assert not np.array_equal(got[0], got[1])
    assert np.corrcoef(got[0], got[1])[0, 1] > 0.99


def test_one_d_normals_constant_is_jax_draw():
    """The normals ``chip_smoke.py`` feeds the 1-D example on the card are
    ``jax.random.normal(PRNGKey(0), (1, 201), float32)``, bit for bit."""
    from chip_smoke import ONE_D_NORMALS

    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 201),
                                        jnp.float32))
    got = np.asarray(ONE_D_NORMALS, dtype=np.float32).reshape(1, -1)
    assert_array_equal(got, want)


def test_gprcached_is_the_gaussian_process():
    assert st.GPRCached is st.GaussianProcess is gp_mod.GPRCached
