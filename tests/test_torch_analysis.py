"""The port's ``analysis.py`` against the JAX package's, in float64:
``compute_roa`` (whole and in segments, with trajectories),
``reward_rollout`` (the frozen sum after the first contribution below
``tol``), ``compute_closedloop_response`` and ``gridify``. ROA masks must
be equal; trajectories, rewards and responses within 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st

from _torch_parity import working_dtype

RTOL = 1e-12


def pendulum_loop(pkg):
    """The inverted pendulum under its LQR gain (a weaker one, so that
    part of the grid falls out of the ROA)."""
    pend = pkg.InvertedPendulum(0.15, 0.5, 0.1, 0.01)
    a, b = (np.asarray(m) for m in pend.linearize())
    k, _ = sl.utils.dlqr(a, b, np.eye(2), np.eye(1))
    pol = pkg.Saturation(pkg.LinearSystem(-0.6 * k), -1.0, 1.0)
    return lambda x: pend(x, pol(x))


@pytest.mark.parametrize("segment_steps", [None, 7, 200])
def test_compute_roa_matches_jax(segment_steps):
    with working_dtype("float64"):
        grid, jgrid = (pkg.GridWorld([[-1.5, 1.5], [-2.0, 2.0]], 17)
                       for pkg in (st, sl))
        got = st.compute_roa(grid, pendulum_loop(st), horizon=40, tol=0.3,
                             segment_steps=segment_steps)
        want = sl.compute_roa(jgrid, pendulum_loop(sl), horizon=40, tol=0.3,
                              segment_steps=segment_steps)
    assert got.dtype == bool
    assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    with pytest.raises(ValueError, match="segment_steps"):
        st.compute_roa(grid, pendulum_loop(st), segment_steps=0)
    with pytest.raises(ValueError, match="no_traj"):
        st.compute_roa(grid, pendulum_loop(st), no_traj=False,
                       segment_steps=5)


def test_compute_roa_trajectories_match_jax():
    points = np.random.default_rng(0).uniform(-1, 1, (30, 2))
    with working_dtype("float64"):
        roa, traj = st.compute_roa(points, pendulum_loop(st), horizon=25,
                                   tol=0.5, equilibrium=np.zeros((1, 2)),
                                   no_traj=False)
        jroa, jtraj = sl.compute_roa(points, pendulum_loop(sl), horizon=25,
                                     tol=0.5, no_traj=False)
    assert traj.shape == jtraj.shape == (30, 2, 25)
    assert_array_equal(roa, jroa)
    assert_allclose(traj, jtraj, rtol=RTOL, atol=1e-14)
    assert_array_equal(traj[:, :, 0], points)


@pytest.mark.parametrize("horizon", [10, 100])
def test_reward_rollout_matches_jax(horizon, capsys):
    with working_dtype("float64"):
        grid, jgrid = (pkg.GridWorld([[-1, 1]], 5) for pkg in (st, sl))
        got = st.reward_rollout(grid, st.LinearSystem([[0.5]]),
                                lambda x: x[:, :1] ** 2, discount=0.9,
                                horizon=horizon)
        said = capsys.readouterr().out
        want = sl.reward_rollout(jgrid, sl.LinearSystem([[0.5]]),
                                 lambda x: jnp.asarray(x)[:, :1] ** 2,
                                 discount=0.9, horizon=horizon)
        assert capsys.readouterr().out == said
    assert_allclose(got, want, rtol=RTOL)
    q = 0.9 * 0.25
    steps = next(t for t in range(100) if q ** t < 1e-3) + 1
    if horizon > steps:
        assert "converged after {} steps".format(steps) in said
    else:
        assert "did not converge" in said


@pytest.mark.parametrize("reference", ["impulse", "step", "zero"])
def test_compute_closedloop_response_matches_jax(reference):
    results = []
    for pkg in (st, sl):
        with working_dtype("float64"):
            pend = pkg.InvertedPendulum(0.25, 0.5, 0.1, 0.01)
            k, _ = sl.utils.dlqr(*(np.asarray(m) for m in pend.linearize()),
                                 np.eye(2), np.eye(1))
            results.append(pkg.compute_closedloop_response(
                pend, pkg.LinearSystem(-k), 2, steps=30, dt=0.01,
                reference=reference, const=0.1, ic=[0.1, -0.2]))
    for got, want in zip(*results):
        assert isinstance(got, np.ndarray)
        assert got.shape == np.asarray(want).shape
        assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-14)
    with pytest.raises(ValueError, match="unknown reference"):
        st.compute_closedloop_response(None, st.LinearSystem([[1.0, 0.0]]),
                                       2, 3, 0.1, reference="ramp")


def test_gridify_matches_jax():
    for args, kwargs in ((([2.0, 4.0],), {"num_points": 5}),
                         (([2.0, 4.0], [1.0, 8.0]), {"num_points": [3, 7]})):
        got, want = st.gridify(*args, **kwargs), sl.gridify(*args, **kwargs)
        assert isinstance(got, st.GridWorld)
        assert_allclose(got.limits, want.limits)
        assert_array_equal(got.num_points, want.num_points)
    assert torch.is_tensor(st.analysis._grid_points(got))
