"""The port's k-step exploration and its device GP append against the JAX
package's.

- ``_device_border_append``: for a ``GaussianProcess`` (RBF, two outputs)
  and a ``StackedGaussianProcess`` (the adaptive example's composite
  kernels), five appends in a row from the same data in both packages:
  ``chol_inv``, ``alpha`` and the predictions to 1e-10, float64; after
  every append the kernels' precondition holds (``mask[count:] == 0``,
  ``chol_inv[count:, :count] == 0``, the padding rows untouched).
- ``get_safe_sample_batch``: the counterparts of ``tests/test_explore.py``
  ``:198`` (the batch against the sequential loop, and against the JAX
  package's batch), ``:246`` (the backup warning) and ``:263`` (the backup
  rows have no perturbation), with and without the membership check and a
  subsample; pairs, measurements and bounds to 1e-8 and the same safe
  flags; the capacity, empty-safe-set and noise-key errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu.functions.gp import \
    _device_border_append as jax_append
from safe_learning_tpu_torch.functions.gp import _device_border_append

from _torch_parity import port_gp, port_stacked_gp, to_numpy, working_dtype

TOL = 1e-10


def _check_precondition(gp, fresh):
    """The kernels' precondition after an append, and the rows past the
    count as the host factorization ``fresh`` left them."""
    n = gp.count
    chol_inv = to_numpy(gp.chol_inv).reshape(-1, gp.capacity, gp.capacity)
    fresh = to_numpy(fresh).reshape(chol_inv.shape)
    assert not to_numpy(gp._mask())[n:].any()
    assert not chol_inv[:, n:, :n].any()
    assert_array_equal(chol_inv[:, n:], fresh[:, n:])


def _gp_pair():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(6, 3))
    y = np.column_stack([np.sin(2 * x[:, 0]), x[:, 1] * x[:, 2]])
    jgp = sl.GaussianProcess(sl.RBF(1.3, [0.7, 1.4, 0.9], input_dim=3), x, y,
                             1e-3, beta=2.0, capacity=16, scale=1.5)
    return jgp, port_gp(jgp)


def _stacked_pair():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(4, 3))
    y = np.column_stack([np.sin(2 * x[:, 0]), x[:, 1] * x[:, 2]])
    kernels, means = [], []
    for dim, var in enumerate(([0.3, 0.1, 0.5], [0.2, 0.4, 0.1])):
        kernels.append(
            sl.LinearKernel(variances=var, input_dim=3)
            + sl.ActiveDims(sl.Matern32(lengthscales=1.0, input_dim=1), [0])
            * sl.ActiveDims(sl.LinearKernel(variances=var[1], input_dim=1),
                            [0]))
        means.append(sl.LinearSystem(np.array([[0.9, 0.1 * dim, 0.2]])))
    jgp = sl.StackedGaussianProcess(kernels, x, y, noise_variances=1e-3,
                                    betas=2.0, mean_functions=means,
                                    capacity=16)
    return jgp, port_stacked_gp(jgp)


@pytest.mark.parametrize("build", [_gp_pair, _stacked_pair])
def test_device_append_matches_jax(build):
    rng = np.random.default_rng(2)
    queries = rng.uniform(-1.2, 1.2, size=(50, 3))
    with working_dtype("float64"):
        jgp, gp = build()
        fresh = gp.chol_inv.clone()
        for step in range(5):
            x = rng.uniform(-1, 1, size=(1, 3))
            y = rng.normal(size=(1, 2))
            jgp = jax_append(jgp, x, y)
            gp = _device_border_append(gp, torch.as_tensor(x),
                                       torch.as_tensor(y))
            assert gp.count == int(jgp.count) == 7 - 2 * (
                build is _stacked_pair) + step
            _check_precondition(gp, fresh)
            for got, want in ((gp.chol_inv, jgp.chol_inv),
                              (gp.alpha, jgp.alpha),
                              (gp.X_buf, jgp.X_buf), (gp.Y_buf, jgp.Y_buf)):
                assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                                atol=TOL)
            for got, want in zip(gp(queries), jgp(queries)):
                assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                                atol=TOL)
    # The carried GP has no float64 host cache: a host append refactorizes.
    assert getattr(gp, "_host_cache", None) is None
    assert getattr(gp, "_host_caches", None) is None


def test_device_append_refuses_a_full_gp():
    with working_dtype("float64"):
        _, gp = _gp_pair()
        gp.count = gp.capacity
        with pytest.raises(ValueError, match="full"):
            _device_border_append(gp, torch.zeros(1, 3), torch.zeros(1, 2))


# ---------------------------------------------------------------------------
# get_safe_sample_batch
# ---------------------------------------------------------------------------
def lyapunov_pair():
    """``tests/test_explore.py:37``'s instance in both packages: a GP
    learned from 60 samples of ``0.6 x + 0.4 u`` on an 11-point grid,
    certified once, float64."""
    with working_dtype("float64"):
        rng = np.random.default_rng(0)
        x = rng.uniform(-1, 1, size=(60, 2))
        y = 0.6 * x[:, :1] + 0.4 * x[:, 1:]
        jgp = sl.GaussianProcess(sl.RBF(1.0, [0.7, 0.7], input_dim=2), x, y,
                                 1e-4, beta=2.0)
        jlyap = sl.Lyapunov(
            sl.GridWorld([[-1, 1]], 11),
            sl.LambdaFunction(lambda s: (s ** 2).sum(axis=1, keepdims=True)),
            jgp, 1.0, 1.0, 1e-3, sl.LambdaFunction(lambda s: -0.2 * s),
            initial_set=[4, 5, 6])
        lyap = st.Lyapunov(
            st.GridWorld([[-1, 1]], 11),
            st.LambdaFunction(lambda s: (s ** 2).sum(dim=1, keepdim=True)),
            port_gp(jgp), 1.0, 1.0, 1e-3,
            st.LambdaFunction(lambda s: -0.2 * s), initial_set=[4, 5, 6])
        jlyap.update_safe_set()
        lyap.update_safe_set()
    assert_array_equal(lyap.safe_set, jlyap.safe_set)
    return lyap, jlyap


def true_pair(slope=0.7, wiggle=0.05):
    """``tests/test_explore.py:213``'s measured system in both packages."""
    return (st.LambdaFunction(lambda sa: slope * sa[:, :1] + 0.4 * sa[:, 1:]
                              + wiggle * torch.sin(3.0 * sa[:, :1])),
            sl.LambdaFunction(lambda sa: slope * sa[:, :1] + 0.4 * sa[:, 1:]
                              + wiggle * jnp.sin(3.0 * sa[:, :1])))


def both_batches(lyap, jlyap, k, pert, seed=0, **kwargs):
    true, jtrue = true_pair()
    with working_dtype("float64"):
        got = st.get_safe_sample_batch(lyap, true, k, pert,
                                       rng=np.random.default_rng(seed),
                                       **kwargs)
        want = sl.get_safe_sample_batch(jlyap, jtrue, k, pert,
                                        rng=np.random.default_rng(seed),
                                        **kwargs)
    return got, [np.asarray(w) for w in want]


def assert_same_batch(got, want):
    sas, ys, bounds, safes = got
    assert sas.dtype == ys.dtype == np.float64
    for a, b in zip((sas, ys, bounds), want[:3]):
        assert_allclose(a, b, rtol=0, atol=1e-8)
    assert_array_equal(safes, want[3])


@pytest.mark.parametrize("options", [
    dict(), dict(positive=True), dict(num_samples=3),
    dict(limits=np.array([[-0.15, 0.15]]), num_samples=5)])
def test_batch_matches_jax(options):
    """The same k = 4 pairs, measurements, bounds and flags as the JAX
    package's batch, and the same GP after the float64 refresh."""
    lyap, jlyap = lyapunov_pair()
    pert = np.array([[-0.1], [0.0], [0.1]])
    got, want = both_batches(lyap, jlyap, 4, pert, **options)
    assert got[3].all()
    assert_same_batch(got, want)
    assert lyap.dynamics.count == int(jlyap.dynamics.count) == 64
    q = np.array([[0.15, -0.2], [-0.3, 0.1]])
    with working_dtype("float64"):
        for a, b in zip(lyap.dynamics(q), jlyap.dynamics(q)):
            assert_allclose(to_numpy(a), np.asarray(b), rtol=0, atol=1e-10)


def test_batch_matches_sequential_loop():
    """``tests/test_explore.py:198``: the batch reproduces the sequential
    ``get_safe_sample`` and ``add_data_point`` loop (each step with the
    full safe set), and the final GPs predict alike."""
    true, _ = true_pair()
    pert = np.array([[-0.1], [0.0], [0.1]])
    seq, _ = lyapunov_pair()
    batch, _ = lyapunov_pair()
    with working_dtype("float64"):
        pairs, ys = [], []
        for _ in range(4):
            sa, _ = st.get_safe_sample(seq, pert,
                                       rng=np.random.default_rng(0))
            y = to_numpy(true(sa))
            seq.dynamics = seq.dynamics.add_data_point(sa, y)
            pairs.append(sa[0])
            ys.append(y[0])
        sas, bys, _, safes = st.get_safe_sample_batch(
            batch, true, 4, pert, rng=np.random.default_rng(0))
        q = np.array([[0.15, -0.2], [-0.3, 0.1]])
        final = [(to_numpy(a), to_numpy(b)) for a, b in
                 zip(seq.dynamics(q), batch.dynamics(q))]
    assert safes.all()
    assert_allclose(sas, np.asarray(pairs), atol=1e-6)
    assert_allclose(bys, np.asarray(ys), atol=1e-6)
    assert batch.dynamics.count == seq.dynamics.count == 64
    for a, b in final:
        assert_allclose(a, b, atol=1e-6)


def test_apply_false_leaves_the_gp():
    lyap, _ = lyapunov_pair()
    gp = lyap.dynamics
    true, _ = true_pair()
    with working_dtype("float64"):
        sas, _, _, _ = st.get_safe_sample_batch(
            lyap, true, 2, np.zeros((1, 1)), rng=np.random.default_rng(0),
            apply=False)
    assert lyap.dynamics is gp and gp.count == 60
    assert sas.shape == (2, 2)


def test_backup_warning_matches_jax():
    """``tests/test_explore.py:246``: with ``c_max = -inf`` every step
    takes the backup rows, with one ``RuntimeWarning``."""
    lyap, jlyap = lyapunov_pair()
    lyap.c_max = jlyap.c_max = -np.inf
    with pytest.warns(RuntimeWarning, match="backup"):
        got, want = both_batches(lyap, jlyap, 3, np.zeros((1, 1)))
    assert not got[3].any()
    assert got[0].shape == (3, 2)
    assert_same_batch(got, want)


def test_backup_uses_zero_perturbation():
    """``tests/test_explore.py:263``: the backup rows are the policy's own
    actions, not the perturbed ones, as in the JAX package."""
    lyap, jlyap = lyapunov_pair()
    lyap.c_max = jlyap.c_max = -np.inf
    pert = np.array([[-0.5], [0.5]])
    with pytest.warns(RuntimeWarning, match="backup"):
        got, want = both_batches(lyap, jlyap, 3, pert)
    assert not got[3].any()
    assert_allclose(got[0][:, 1], -0.2 * got[0][:, 0], atol=1e-12)
    assert_same_batch(got, want)


def test_batch_errors():
    lyap, _ = lyapunov_pair()
    true, _ = true_pair()
    pert = np.zeros((1, 1))
    with working_dtype("float64"):
        with pytest.raises(ValueError, match="capacity"):
            st.get_safe_sample_batch(lyap, true, 5, pert)
        with pytest.raises(TypeError, match="torch.Generator"):
            st.get_safe_sample_batch(lyap, true, 1, pert,
                                     noise_key=np.zeros(2, np.uint32))
        lyap.safe_set[:] = False
        lyap.initial_safe_set = None
        with pytest.raises(RuntimeError, match="safe set is empty"):
            st.get_safe_sample_batch(lyap, true, 1, pert)


def test_noise_key_reaches_the_measurement():
    """A generator is passed to every measurement as ``noise_key=``."""
    lyap, _ = lyapunov_pair()
    seen = []

    class Noisy(st.DeterministicFunction):
        def __call__(self, sa, noise_key=None):
            seen.append(noise_key)
            noise = torch.randn(sa.shape[0], 1, generator=noise_key,
                                dtype=sa.dtype)
            return 0.6 * sa[:, :1] + 0.4 * sa[:, 1:] + 1e-3 * noise

    gen = torch.Generator().manual_seed(0)
    with working_dtype("float64"):
        st.get_safe_sample_batch(lyap, Noisy(), 2, np.zeros((1, 1)),
                                 rng=np.random.default_rng(0),
                                 noise_key=gen)
    assert seen == [gen, gen]
