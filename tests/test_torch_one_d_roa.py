"""The 1-D region-of-attraction example against the JAX package's.

``safe_learning_tpu_torch.examples.one_d_region_of_attraction_estimate``
at 501 states and 5 updates, fed the JAX package's normals for its true
system, against the JAX example's loop
(``examples/one_d_region_of_attraction_estimate.py:46-135``) on the same
sizes: the true system's samples, the measured states, the safe-fraction
history and ``c_max`` are equal in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
from safe_learning_tpu_torch.examples import \
    one_d_region_of_attraction_estimate as one_d
from safe_learning_tpu_torch.functions import gp as gp_mod

from _torch_parity import to_numpy, working_dtype

NUM_STATES, UPDATES, SEED = 501, 5, 0


def jax_example(num_states, n_updates, seed):
    """The JAX example's ``main`` at these sizes (no options)."""
    discretization = sl.GridWorld([[-1.0, 1.0]], num_states)
    tau = 1.0 / discretization.nindex
    kernel = (sl.ActiveDims(sl.Matern32(variance=0.4 ** 2, lengthscales=1.0,
                                        input_dim=1), dims=[0])
              * sl.ActiveDims(sl.LinearKernel(variances=1.0, input_dim=1),
                              dims=[0]))
    gp = sl.GaussianProcess(kernel, np.empty((0, 2)), np.empty((0, 1)),
                            noise_variance=0.01 ** 2, beta=2.0,
                            mean_function=sl.LinearSystem([[0.25, 0.0]]),
                            capacity=max(32, n_updates))
    sample_disc = np.hstack([np.linspace(-1, 1, 201)[:, None],
                             np.zeros((201, 1))])
    true_dynamics = sl.sample_gp_function(sample_disc, gp,
                                          jax.random.PRNGKey(seed))[0]
    lyap = sl.Lyapunov(discretization,
                       sl.Triangulation(sl.GridWorld([[-1.0, 1.0]], 3),
                                        [1.0, 0.0, 1.0]),
                       gp, lipschitz_dynamics=0.25, lipschitz_lyapunov=1.0,
                       tau=tau, policy=sl.LinearSystem([[0.0]]))
    initial = np.abs(discretization.all_points.squeeze()) < 0.2
    lyap.initial_safe_set = initial
    lyap.safe_set |= initial
    lyap.update_safe_set()
    initial_fraction = float(lyap.safe_set.mean())
    grid = discretization.all_points
    xu_all = np.hstack([grid, np.asarray(lyap.policy(grid))])
    fractions, measured = [], []
    for _ in range(n_updates):
        _, std = lyap.dynamics.evaluate(xu_all)
        std = np.asarray(std)[:, 0]
        max_id = int(np.argmax(np.where(lyap.safe_set, std, -np.inf)))
        arg = xu_all[[max_id]]
        measured.append(arg[0])
        lyap.dynamics = lyap.dynamics.add_data_point(
            arg, np.asarray(true_dynamics(arg)))
        lyap.update_safe_set()
        fractions.append(float(lyap.safe_set.mean()))
    return dict(initial=initial_fraction, fractions=fractions,
                c_max=float(lyap.c_max), measured=np.array(measured),
                true=np.asarray(true_dynamics(sample_disc))[:, 0])


@pytest.fixture(scope="module")
def runs():
    def normals(generator, number, n):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(SEED),
                                            (number, n), jnp.float32),
                          dtype=np.float64)

    saved = gp_mod._standard_normals
    gp_mod._standard_normals = normals
    try:
        with working_dtype("float64"):
            want = jax_example(NUM_STATES, UPDATES, SEED)
            got = one_d.run(num_states=NUM_STATES, n_updates=UPDATES,
                            seed=SEED)
    finally:
        gp_mod._standard_normals = saved
    return got, want


def test_true_system_matches_jax(runs):
    got, want = runs
    disc = np.hstack([np.linspace(-1, 1, 201)[:, None], np.zeros((201, 1))])
    with working_dtype("float64"):
        values = to_numpy(got.true_dynamics(disc))[:, 0]
    assert_allclose(values, want["true"], rtol=0, atol=1e-8)


def test_safe_set_history_matches_jax(runs):
    got, want = runs
    assert got.initial_fraction == want["initial"]
    assert_array_equal(got.measured, want["measured"])
    assert got.fractions == want["fractions"]
    assert_allclose(got.lyap.c_max, want["c_max"], rtol=1e-12)
    assert got.fractions[-1] > got.initial_fraction
    assert got.lyap.dynamics.count == UPDATES


def test_rigor_modes_raise():
    with pytest.raises(NotImplementedError, match="items 17 and 18"):
        one_d.run(num_states=11, n_updates=1, extended=True)
    with pytest.raises(NotImplementedError, match="item 22"):
        one_d.main(["--plot"])
