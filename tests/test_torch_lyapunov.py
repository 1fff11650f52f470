"""The port's fused Lyapunov sweep against the JAX package's.

The 1-D closed form of ``tests/test_lyapunov.py:31``, the semantics the
JAX package keeps on purpose (``-inf`` when nothing verifies, previously
safe states kept with ``can_shrink=False``), and ``bench.py``'s instance
at 200x200 in float64: the same safe set and the same certified level as
the JAX package.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st

from _torch_parity import (jax_bench_lyapunov, port_gp, to_numpy,
                           working_dtype)


def _quad_v():
    return st.LambdaFunction(lambda x: (x ** 2).sum(dim=1, keepdim=True))


@pytest.mark.parametrize("tau,expected,c_max", [
    (0.5, [False, True, False], 0.0), (0.0, [True, True, True], 1.0)])
def test_update_safe_set_closed_form(tau, expected, c_max):
    """3-point 1-D grid, exact expected safe sets."""
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1]], 3)
        policy = st.LambdaFunction(lambda x: -0.1 * x)
        dyn = st.LinearSystem(np.array([[1.0, 1.0]]))  # f(x, u) = x + u
        lyap = st.Lyapunov(grid, _quad_v(), dyn, 0.4, 0.3, tau, policy,
                           initial_set=[1])
        lyap.update_safe_set()
    assert_array_equal(lyap.safe_set, expected)
    assert_allclose(lyap.c_max, c_max)


def test_no_safe_prefix_gives_minus_inf_and_can_shrink():
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1]], 3)
        policy = st.LambdaFunction(lambda x: 0.0 * x)
        dyn = st.LinearSystem(np.array([[2.0, 0.0]]))  # expanding
        lyap = st.Lyapunov(grid, _quad_v(), dyn, 0.4, 0.3, 0.5, policy)
        lyap.update_safe_set()
        assert not lyap.safe_set.any()
        assert lyap.c_max == -np.inf
        lyap.safe_set[0] = True
        lyap.update_safe_set(can_shrink=False)
    assert_array_equal(lyap.safe_set, [True, False, False])


def test_initial_set_and_exempt_cache_follow_mutation():
    """An in-place change of the initial set reaches the next sweep."""
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1]], 5)
        policy = st.LambdaFunction(lambda x: 0.0 * x)
        dyn = st.LinearSystem(np.array([[2.0, 0.0]]))
        lyap = st.Lyapunov(grid, _quad_v(), dyn, 0.4, 0.3, 0.5, policy,
                           initial_set=[2])
        assert_array_equal(lyap.safe_set, [0, 0, 1, 0, 0])
        lyap.update_safe_set()
        assert_array_equal(lyap.safe_set, [0, 0, 1, 0, 0])
        assert lyap.c_max == 0.0
        lyap.initial_safe_set[1] = True
        lyap.initial_safe_set[3] = True
        lyap.update_safe_set()
    # With the stale mask, v_bad would be v(x_1) = 0.25 and c_max 0.
    assert_array_equal(lyap.safe_set, [0, 1, 1, 1, 0])
    assert lyap.c_max == 0.25


def test_threshold_is_safe_and_margins():
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1], [-1, 1]], 5)
        lyap = st.Lyapunov(
            grid, st.QuadraticFunction(np.eye(2)),
            st.LinearSystem([0.5 * np.eye(2), np.zeros((2, 1))]), 0.5,
            st.LambdaFunction(lambda x: 2.0 * torch.abs(x)), 0.1,
            st.LinearSystem(np.zeros((1, 2))), initial_set=[12])
        thr = to_numpy(lyap.threshold(np.array([[0.5, -0.25]])))
        assert_allclose(thr, [[-2.0 * 0.75 * 1.5 * 0.1]])
        lyap.update_safe_set()
        assert lyap.is_safe(np.array([[0.0, 0.0]]))[0]
        full = lyap.safe_set.sum()
        lyap.certificate_margin = np.full(grid.nindex, 10.0)
        lyap.update_safe_set()
        assert lyap.safe_set.sum() == 1 < full
        with pytest.raises(ValueError, match="nindex"):
            lyap.certificate_margin = np.zeros(3)


def test_level_margin_trims_the_cut():
    """Dynamics that expand only near the edges: the corners fail, so
    ``v_bad = 1`` and the level margin moves the cut below 0.25."""
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1]], 5)
        dyn = st.LambdaFunction(lambda z: 0.5 * z[:, :1] + 0.6 * z[:, :1] ** 3)
        lyap = st.Lyapunov(grid, _quad_v(), dyn, 0.5, 0.3, 0.01,
                           st.LambdaFunction(lambda x: 0.0 * x),
                           initial_set=[2])
        lyap.update_safe_set()
        assert lyap.c_max == 0.25
        assert_array_equal(lyap.safe_set, [0, 1, 1, 1, 0])
        lyap.level_margin = 0.8
        lyap.update_safe_set()
    assert lyap.c_max == 0.0
    assert_array_equal(lyap.safe_set, [0, 0, 1, 0, 0])


def test_unported_paths_raise():
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1]], 9)
        args = (grid, _quad_v(), st.LinearSystem(np.array([[0.5, 0.0]])),
                0.4, 0.3, 0.1, st.LambdaFunction(lambda x: 0.0 * x))
        with pytest.raises(NotImplementedError, match="item 23"):
            st.Lyapunov(*args, mesh=object())
        lyap = st.Lyapunov(*args)
        with pytest.raises(NotImplementedError, match="item 18"):
            lyap.update_safe_set(extended=True)
        old = st.config.fused_sweep_limit, st.config.gp_batch_size
        st.config.fused_sweep_limit, st.config.gp_batch_size = 4, 4
        try:
            # Above the fused limit the grid streams (no longer raises):
            # the stable value sort's prefix before the first failing
            # state, in 3 batches of 4.
            lyap.update_safe_set()
            assert lyap.last_sweep_counts["coarse_batches"] == 3
        finally:
            st.config.fused_sweep_limit, st.config.gp_batch_size = old
        values = to_numpy(lyap.values)
        order = np.argsort(values, kind="stable")
        passed = lyap.safety_constraint(lyap.policy)[order]
        stop = len(order) if passed.all() else int(np.argmin(passed))
        expected = np.zeros(len(order), dtype=bool)
        expected[order[:stop]] = True
        assert_array_equal(lyap.safe_set, expected)
        with pytest.warns(RuntimeWarning, match="no effect"):
            lyap.update_safe_set(safety_factor=2.0)


@pytest.fixture(scope="module")
def bench_pair():
    """``bench.py``'s instance at 200x200 in both packages, float64."""
    with working_dtype("float64"):
        jlyap, _ = jax_bench_lyapunov(200)
        jlyap.update_safe_set()
        plyap = st.Lyapunov(
            st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 200),
            st.QuadraticFunction(np.eye(2)), port_gp(jlyap.dynamics),
            jlyap._lipschitz_dynamics,
            st.LambdaFunction(lambda x: 2.0 * torch.abs(x)), jlyap.tau,
            st.LinearSystem(np.zeros((1, 2))),
            initial_set=np.flatnonzero(jlyap.initial_safe_set))
        plyap.update_safe_set()
    return jlyap, plyap


def test_bench_instance_float64_matches_jax(bench_pair):
    jlyap, plyap = bench_pair
    assert_array_equal(plyap.discretization.all_points,
                       jlyap.discretization.all_points)
    assert 0.05 < plyap.safe_set.mean() < 0.95
    assert_array_equal(plyap.safe_set, jlyap.safe_set)
    assert_allclose(plyap.c_max, jlyap.c_max, rtol=0, atol=1e-12)
    assert_allclose(to_numpy(plyap.values), np.asarray(jlyap.values),
                    rtol=1e-14, atol=1e-15)


def test_bench_instance_decrease_margins_match_jax(bench_pair):
    """Per-point decrease and threshold of the batch check."""
    from safe_learning_tpu.lyapunov import _negative_batch as jax_batch
    from safe_learning_tpu_torch.lyapunov import _negative_batch

    jlyap, plyap = bench_pair
    pts = jlyap.discretization.all_points[::97]
    neg_j, dec_j, thr_j = map(np.asarray, jax_batch(
        jlyap.policy, jlyap.dynamics, jlyap.lyapunov_function,
        jlyap._lipschitz_lyapunov, jlyap._lipschitz_dynamics, jlyap.tau,
        pts))
    with working_dtype("float64"):
        neg_t, dec_t, thr_t = map(to_numpy, _negative_batch(
            plyap.policy, plyap.dynamics, plyap.lyapunov_function,
            plyap._lipschitz_lyapunov, plyap._lipschitz_dynamics,
            plyap.tau, torch.as_tensor(pts)))
    assert_array_equal(neg_t, neg_j)
    assert_allclose(dec_t, dec_j, rtol=0, atol=1e-12)
    assert_allclose(thr_t, thr_j, rtol=0, atol=1e-15)


@pytest.mark.parametrize("include_initial", [True, False])
def test_safety_constraint_matches_jax(bench_pair, include_initial):
    """The policy-facing mask of ``one_d_example.py``'s constraint: the
    decrease check on the whole grid under a policy, equal to JAX's."""
    jlyap, plyap = bench_pair
    k = np.array([[0.3, -0.2]])
    with working_dtype("float64"):
        got = plyap.safety_constraint(st.LinearSystem(k),
                                      include_initial=include_initial)
        want = jlyap.safety_constraint(sl.LinearSystem(k),
                                       include_initial=include_initial)
    assert got.dtype == bool and got.shape == (plyap.discretization.nindex,)
    assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    if include_initial:
        assert got[plyap.initial_safe_set].all()


def test_v_decrease_bound_and_lipschitz_match_jax(bench_pair):
    jlyap, plyap = bench_pair
    pts = jlyap.discretization.all_points[::131]
    with working_dtype("float64"):
        x = torch.as_tensor(pts)
        nxt = plyap.dynamics(x, plyap.policy(x))
        jnxt = jlyap.dynamics(pts, jlyap.policy(pts))
        for got, want in ((plyap.v_decrease_bound(x, nxt),
                           jlyap.v_decrease_bound(pts, jnxt)),
                          (plyap.v_decrease_bound(x, nxt[0]),
                           jlyap.v_decrease_bound(pts, jnxt[0])),
                          (plyap.lipschitz_lyapunov(x),
                           jlyap.lipschitz_lyapunov(pts))):
            # The decrease is a difference of values near 1: 1e-12
            # absolute, as the batch check above.
            assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-12,
                            atol=1e-12)
        dot, err = plyap.v_decrease_confidence(x, nxt)
        jdot, jerr = jlyap.v_decrease_confidence(pts, jnxt)
        assert_allclose(to_numpy(err), np.asarray(jerr), rtol=1e-12,
                        atol=1e-12)
        assert float(plyap.v_decrease_confidence(x, nxt[0])[1]) == 0.0
        assert plyap.lipschitz_dynamics(x) == jlyap.lipschitz_dynamics(pts)
