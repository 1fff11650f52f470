"""The port's online GP updates (``add_data_point``) against the JAX
package's.

Both packages start from the same GP (converted with ``convert``) and
append the same numpy measurements: from an empty GP at capacity 8 (as the
safe-learning example starts at capacity 64), past the capacity (a
rebuild at the next power of two), and with a duplicate input at tiny
noise, whose bordered append is refused and refactorized. The float64
host factors must agree with the JAX package's and with a fresh
factorization of the same data, and the posteriors with the JAX
package's. Tolerances: posteriors 1e-10 relative (absolute 1e-12); host
factors 1e-9 relative, because the two packages' float64 kernel matrices
differ in the last bits (differently ordered sums) and the condition
number of the scaled kernel matrix amplifies that.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu.config import config as jax_config
from safe_learning_tpu_torch.functions.gp import _host_factorize

from _torch_parity import (port_gp, port_stacked_gp, to_numpy,
                           working_dtype)

RTOL, ATOL = 1e-10, 1e-12


def stacked_pair(capacity, noise=1e-6):
    """The safe-learning example's stacked GP with no data, both
    packages (``examples/inverted_pendulum.py:27-48``)."""
    rng = np.random.default_rng(0)
    a = np.eye(2) + 0.05 * rng.normal(size=(2, 2))
    b = 0.1 * rng.normal(size=(2, 1))
    variances = np.clip((0.03 * rng.normal(size=(2, 3))) ** 2, 1e-5, None)
    kernels = [sl.LinearKernel(variances=variances[dim], input_dim=3)
               + sl.ActiveDims(sl.Matern32(lengthscales=1.0, input_dim=1),
                               dims=[0])
               * sl.ActiveDims(sl.LinearKernel(variances=variances[dim, 1],
                                               input_dim=1), dims=[0])
               for dim in range(2)]
    jgp = sl.StackedGaussianProcess(
        kernels, np.empty((0, 3)), np.empty((0, 2)), noise_variances=noise,
        betas=2.0, mean_functions=[sl.LinearSystem([a[[d]], b[[d]]])
                                   for d in range(2)], capacity=capacity)
    return port_stacked_gp(jgp), jgp


def gp_pair(capacity, noise):
    """A single-output RBF GP with a linear prior on 3 points, both
    packages."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (3, 2))
    y = np.sin(x.sum(axis=1, keepdims=True))
    jgp = sl.GaussianProcess(sl.RBF(1.0, [0.6, 0.9], input_dim=2), x, y,
                             noise, beta=2.0,
                             mean_function=sl.LinearSystem([[0.3, -0.2]]),
                             capacity=capacity)
    return port_gp(jgp), jgp


def check_pair(gp, jgp, queries, fresh, jax_fresh=None):
    """Same count and capacity, equal posteriors, equal host factors
    (``fresh``: refactorized rather than bordered; ``jax_fresh``, the JAX
    package's where it differs), and host factors equal to a fresh
    factorization of the same data."""
    assert (gp.count, gp.capacity) == (int(jgp.count), jgp.capacity)
    for got, want in zip(gp(queries), jgp(queries)):
        assert_allclose(to_numpy(got), np.asarray(want), rtol=RTOL,
                        atol=ATOL)
    stacked = isinstance(gp, st.StackedGaussianProcess)
    hosts = gp._host_caches if stacked else [gp._host_cache]
    jhosts = jgp._host_caches if stacked else [jgp._host_cache]
    kernels = gp.kernels if stacked else [gp.kernel]
    means = gp.mean_functions if stacked else [gp.mean_function]
    noises = (to_numpy(gp.noise_variances) if stacked
              else [float(gp.noise_variance)])
    for s, (host, jhost) in enumerate(zip(hosts, jhosts)):
        assert host.fresh == fresh
        assert jhost.fresh == (fresh if jax_fresh is None else jax_fresh)
        assert host.count == gp.count
        ref = _host_factorize(kernels[s], to_numpy(gp.X_buf),
                              to_numpy(gp.Y_buf)[:, s:s + 1], means[s],
                              gp.count, float(noises[s]), gp.scale)
        for name in ("chol", "chol_inv", "alpha"):
            got = getattr(host, name)
            scale = np.abs(getattr(ref, name)).max()
            assert_allclose(got, getattr(jhost, name), rtol=0,
                            atol=1e-9 * scale)
            assert_allclose(got, getattr(ref, name), rtol=0,
                            atol=1e-9 * scale)


def test_stacked_append_from_empty_matches_jax():
    """Count 0 at capacity 8, then one point at a time up to 8 (bordered
    appends), then two at once past the capacity (a rebuild at 16)."""
    rng = np.random.default_rng(2)
    queries = rng.uniform(-1, 1, (40, 3))
    with working_dtype("float64"):
        gp, jgp = stacked_pair(8)
        for got, want in zip(gp(queries), jgp(queries)):
            assert_allclose(to_numpy(got), np.asarray(want), rtol=RTOL)
        for step in range(8):
            x = rng.uniform(-1, 1, (1, 3))
            y = 0.1 * rng.normal(size=(1, 2))
            old = gp
            gp, jgp = gp.add_data_point(x, y), jgp.add_data_point(x, y)
            check_pair(gp, jgp, queries, fresh=False)
            assert old.count == step  # the old GP is untouched
        x, y = rng.uniform(-1, 1, (2, 3)), 0.1 * rng.normal(size=(2, 2))
        gp, jgp = gp.add_data_point(x, y), jgp.add_data_point(x, y)
        check_pair(gp, jgp, queries, fresh=True)
        assert gp.capacity == 16 and gp.count == 10
        assert gp._programs()[0] == old._programs()[0]


def test_gp_append_matches_jax():
    rng = np.random.default_rng(3)
    queries = rng.uniform(-1, 1, (30, 2))
    with working_dtype("float64"):
        gp, jgp = gp_pair(8, 1e-3)
        for n_new in (1, 2, 1):
            x = rng.uniform(-1, 1, (n_new, 2))
            y = np.sin(x.sum(axis=1, keepdims=True))
            gp, jgp = gp.add_data_point(x, y), jgp.add_data_point(x, y)
            check_pair(gp, jgp, queries, fresh=False)
        x = rng.uniform(-1, 1, (2, 2))
        gp, jgp = (gp.add_data_point(x, x[:, :1]),
                   jgp.add_data_point(x, x[:, :1]))
        check_pair(gp, jgp, queries, fresh=True)
        assert gp.capacity == 16


@pytest.mark.parametrize("stacked", [False, True])
def test_duplicate_point_refactorizes(stacked):
    """A duplicate input at a noise far below the kernel's scale (1e-13
    against 1 for the RBF GP; none at all for the stacked GP, whose
    kernel values are about 1e-5) leaves a pivot near float64 roundoff:
    the bordered append refuses and the GP is refactorized, with the
    jitter loop where the matrix is singular, in both packages alike."""
    rng = np.random.default_rng(4)
    with working_dtype("float64"):
        if stacked:
            gp, jgp = stacked_pair(8, noise=0.0)
            x = rng.uniform(-1, 1, (1, 3))
            y = np.zeros((1, 2))
            queries = rng.uniform(-1, 1, (20, 3))
        else:
            gp, jgp = gp_pair(8, 1e-13)
            x = gp.X[:1]
            y = gp.Y[:1]
            queries = rng.uniform(-1, 1, (20, 2))
        if stacked:
            gp, jgp = gp.add_data_point(x, y), jgp.add_data_point(x, y)
        gp, jgp = gp.add_data_point(x, y), jgp.add_data_point(x, y)
        check_pair(gp, jgp, queries, fresh=True)
        hosts = gp._host_caches if stacked else [gp._host_cache]
        jhosts = jgp._host_caches if stacked else [jgp._host_cache]
        assert [h.jitter for h in hosts] == [h.jitter for h in jhosts]


@pytest.mark.parametrize("stacked", [False, True])
def test_bordered_append_matches_jax_refactorization(stacked):
    """The port's bordered append against the JAX package with
    ``incremental_gp_updates`` off, which refactorizes: the same factors
    and posteriors by the two routes."""
    rng = np.random.default_rng(5)
    old = jax_config.incremental_gp_updates
    try:
        jax_config.incremental_gp_updates = False
        with working_dtype("float64"):
            gp, jgp = stacked_pair(8) if stacked else gp_pair(8, 1e-3)
            d = 3 if stacked else 2
            x = rng.uniform(-1, 1, (2, d))
            y = 0.1 * rng.normal(size=(2, 2 if stacked else 1))
            gp, jgp = gp.add_data_point(x, y), jgp.add_data_point(x, y)
            check_pair(gp, jgp, rng.uniform(-1, 1, (20, d)), fresh=False,
                       jax_fresh=True)
    finally:
        jax_config.incremental_gp_updates = old


def test_function_stack_fans_the_measurement_out():
    """``FunctionStack.add_data_point`` appends column ``i`` to member
    ``i``, as the stacked GP appends to its outputs."""
    rng = np.random.default_rng(6)
    with working_dtype("float64"):
        stacked, _ = stacked_pair(8)
        stack = st.FunctionStack(stacked.unstack())
        x, y = rng.uniform(-1, 1, (3, 3)), rng.normal(size=(3, 2))
        grown, stacked = stack.add_data_point(x, y), stacked.add_data_point(
            x, y)
        queries = rng.uniform(-1, 1, (15, 3))
        for got, want in zip(grown(queries), stacked(queries)):
            assert_allclose(to_numpy(got), to_numpy(want), rtol=RTOL,
                            atol=ATOL)
    assert [f.count for f in grown.functions] == [3, 3]
    assert [f.count for f in stack.functions] == [0, 0]


def test_float32_append_keeps_working_dtype_buffers():
    """In float32 the buffers, factors and predictions stay float32 while
    the host factors are float64 and match a fresh factorization."""
    rng = np.random.default_rng(7)
    with working_dtype("float32"):
        gp, _ = stacked_pair(8)
        for _ in range(3):
            gp = gp.add_data_point(rng.uniform(-1, 1, (1, 3)),
                                   0.1 * rng.normal(size=(1, 2)))
        assert gp.X_buf.dtype == gp.chol_inv.dtype == torch.float32
        assert gp._host_caches[0].chol_inv.dtype == np.float64
        mean, err = gp(rng.uniform(-1, 1, (5, 3)))
        assert mean.dtype == torch.float32 and mean.shape == (5, 2)
        assert torch.isfinite(err).all()
