"""The port's fused Lyapunov sweep against the JAX package's.

The 1-D closed form of ``tests/test_lyapunov.py:31``, the semantics the
JAX package keeps on purpose (``-inf`` when nothing verifies, previously
safe states kept with ``can_shrink=False``), and ``bench.py``'s instance
at 200x200 in float64: the same safe set and the same certified level as
the JAX package. Every sweep (fused, sorted, streamed, each without and
over an in-process mesh) leaves the JAX package's safe set, refinement
levels and ``c_max``, with and without an initial set and keeping the
previous set or not; its levels take one byte a state up to refinement
255 (a wider dtype above), the safe set is exactly the nonzero levels, and
neither aliases the other or an earlier sweep's arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.parallel import make_mesh

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
        # Meshes are ported: anything but a parallel.Mesh is refused.
        with pytest.raises(TypeError, match="parallel.Mesh"):
            st.Lyapunov(*args, mesh=object())
        lyap = st.Lyapunov(*args)
        # The rigor mode (ported) refuses the callable policy.
        with pytest.raises(NotImplementedError, match="policies"):
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


def _unstable_pair(adaptive, initial, mesh=None, n=32):
    """``tests/test_lyapunov.py:281-308``'s instance in both packages (the
    JAX package's first) on an ``n x n`` grid without the origin: ``x+ = x
    (0.25 + 0.9 |x|^2)``, unstable outside ``|x| ~ 0.73``; the initial set
    ``|x| <= 0.25`` or none. With an initial set the sorted sweep runs at
    the grid's unit ``tau`` (the coarse check fails in a band outside the
    initial set and refinement rescues it); else at 1/16 of it, where the
    coarse check passes near the origin."""
    pair = []
    for pkg, xp in ((sl, jnp), (st, torch)):
        grid = pkg.GridWorld([[-1, 1], [-1, 1]], n)

        def f(xu):
            x = xu[:, :2]
            return x * (0.25 + 0.9 * (x ** 2).sum(1, keepdims=True))

        tau = float(np.min(grid.unit_maxes)) / (
            1.0 if adaptive and initial else 16.0)
        init = (np.flatnonzero(np.linalg.norm(grid.all_points, axis=1)
                               <= 0.25) if initial else None)
        extra = {} if pkg is sl else dict(mesh=mesh)
        pair.append(pkg.Lyapunov(
            grid, pkg.QuadraticFunction(np.eye(2)),
            pkg.LambdaFunction(f, input_dim=3, output_dim=2), 2.05,
            pkg.LambdaFunction(lambda x, xp=xp: 2.0 * xp.abs(x)), tau,
            pkg.LambdaFunction(lambda x: 0.0 * x[:, :1]),
            initial_set=init, adaptive=adaptive, **extra))
    return pair


def _fail_one_state(lyap):
    """Fail a certified state of value about 0.2 by its margin and take it
    out of the safe set, so a sweep that keeps the previous set keeps the
    states past it at their levels; add a corner state never certified.
    Returns the failed state's index."""
    points = lyap.discretization.all_points
    k = int(np.argmin(np.abs((points ** 2).sum(axis=1) - 0.2)))
    margin = np.zeros(len(points))
    margin[k] = 10.0
    lyap.certificate_margin = margin
    lyap.safe_set[k] = False
    lyap.safe_set[0] = True
    return k


def _assert_same_certificate(plyap, jlyap):
    assert_array_equal(plyap.safe_set, jlyap.safe_set)
    assert_array_equal(plyap._refinement, jlyap._refinement)
    # One ulp: the packages round |x|^2 differently at a few states.
    assert_allclose(plyap.c_max, jlyap.c_max, rtol=1e-14)
    assert plyap._refinement.dtype == np.uint8
    assert_array_equal(plyap.safe_set, plyap._refinement != 0)


@pytest.mark.parametrize("initial", [True, False],
                         ids=["initial", "no_initial"])
@pytest.mark.parametrize("can_shrink", [True, False],
                         ids=["shrink", "keep"])
@pytest.mark.parametrize("entries", [None, 8], ids=["one", "mesh8"])
@pytest.mark.parametrize("kind", ["fused", "sorted", "streamed"])
def test_levels_one_byte_a_state_match_jax(kind, entries, can_shrink,
                                           initial, monkeypatch):
    """Each sweep, twice: from the initial set, then with one certified
    state failed and taken out of the safe set (``_fail_one_state``), and
    for an initial set once more after an in-place change of it (the fused
    sweep's cached exempt copy must follow). Each time the safe set, the
    levels (one byte a state) and ``c_max`` are the JAX package's, and the
    safe set is the nonzero levels. An earlier sweep's arrays stay as they
    were, and a change of the safe set leaves the levels alone."""
    if kind == "streamed":
        for cfg in (sl.config, st.config):
            monkeypatch.setattr(cfg, "fused_sweep_limit", 256)
            monkeypatch.setattr(cfg, "gp_batch_size", 256)
    mesh = None if entries is None else make_mesh(devices=["cpu"] * entries)
    with working_dtype("float64"):
        jlyap, plyap = _unstable_pair(kind == "sorted", initial, mesh)
        assert plyap._refinement.dtype == np.uint8
        for lyap in (jlyap, plyap):
            lyap.update_safe_set(max_refinement=8)
        _assert_same_certificate(plyap, jlyap)
        assert 100 < plyap.safe_set.sum() < 800
        if kind == "sorted" and initial:
            assert (plyap._refinement == 8).sum() > 100
        for lyap in (jlyap, plyap):
            k = _fail_one_state(lyap)
        earlier = (plyap.safe_set, plyap._refinement)
        copies = [np.array(a) for a in earlier]
        for lyap in (jlyap, plyap):
            lyap.update_safe_set(can_shrink=can_shrink, max_refinement=8)
        _assert_same_certificate(plyap, jlyap)
        assert plyap.safe_set.sum() < 200 if can_shrink else not (
            plyap.safe_set[k] or plyap.safe_set.sum() < 500)
        if kind == "sorted" and initial and not can_shrink:
            # States past the cut kept at their refined level.
            assert (plyap._refinement == 8).sum() > 100
        if initial:
            for lyap in (jlyap, plyap):
                lyap.initial_safe_set[k] = True
                lyap.update_safe_set(can_shrink=can_shrink,
                                     max_refinement=8)
            _assert_same_certificate(plyap, jlyap)
            assert plyap.safe_set[k] and plyap.safe_set.sum() > 500
    for kept, copy in zip(earlier, copies):
        assert kept is not plyap.safe_set and kept is not plyap._refinement
        assert_array_equal(kept, copy)
    levels = plyap._refinement.copy()
    plyap.safe_set[:] = ~plyap.safe_set
    assert_array_equal(plyap._refinement, levels)


@pytest.mark.parametrize("r,dtype", [(255, np.uint8), (300, np.int16)])
def test_levels_widen_past_one_byte(r, dtype):
    """A 1-D sorted sweep that rescues states at ``R``: one byte a state up
    to ``R = 255``, a dtype that holds ``R`` past it; the levels are the
    JAX package's."""
    with working_dtype("float64"):
        pair = []
        for pkg, xp in ((sl, jnp), (st, torch)):
            grid = pkg.GridWorld([[-1, 1]], 64)
            pair.append(pkg.Lyapunov(
                grid, pkg.QuadraticFunction(np.eye(1)),
                pkg.LambdaFunction(
                    lambda z: z[:, :1] * (0.25 + 0.9 * z[:, :1] ** 2),
                    input_dim=2, output_dim=1), 2.05,
                pkg.LambdaFunction(lambda x, xp=xp: 2.0 * xp.abs(x)),
                float(grid.unit_maxes[0]),
                pkg.LambdaFunction(lambda x: 0.0 * x),
                initial_set=np.flatnonzero(np.abs(grid.all_points[:, 0])
                                           <= 0.25), adaptive=True))
            pair[-1].update_safe_set(max_refinement=r)
        jlyap, plyap = pair
    assert plyap._refinement.dtype == dtype
    assert (plyap._refinement == r).sum() > 1
    assert_array_equal(plyap._refinement, jlyap._refinement)
    assert_array_equal(plyap.safe_set, plyap._refinement != 0)
    assert_array_equal(plyap.safe_set, jlyap.safe_set)
