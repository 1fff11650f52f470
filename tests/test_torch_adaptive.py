"""The port's adaptive verification against the JAX package's.

- A ``Triangulation`` candidate on the verification grid gives its vertex
  values directly (``tests/test_lyapunov.py:483``), and in float32 on a
  101x76 grid with random vertex values the port's ``values``, safe set
  and ``c_max`` equal the JAX package's.
- The sorted sweep with adaptive refinement on the instances of
  ``tests/test_lyapunov.py`` (``:134``, ``:257``, ``:308``, ``:399``,
  ``:468``) and on a symmetric instance whose first failure falls inside
  a group of exactly tied values: the same safe set and ``_refinement``,
  ``c_max`` to 1e-12 relative, in float64; the result does not depend on
  the coarse batch or the refinement chunk.
- ``calibrate_certificate_margin(refinement=4)``: the same margins from
  the same draws, to 1e-8 relative.
- The slice as a whole: ``examples/adaptive_safety_verification.py``'s
  loop at 41x41 with a GP of capacity 64, 3 updates of 4 measurements and
  ``R = 4`` in both packages: chosen pairs to 1e-8, the same safe sets,
  ``_refinement`` and history, ``c_max`` to 1e-10 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import lyapunov as port_lyapunov

from _torch_parity import adaptive_pair, to_numpy, working_dtype


# ---------------------------------------------------------------------------
# 12a: a Triangulation candidate on the verification grid
# ---------------------------------------------------------------------------
def test_pwl_candidate_direct_grid_values():
    """``tests/test_lyapunov.py:483`` in the port: the sweep through the
    direct values equals the sweep through the locate, and
    ``update_values`` gives the parameters themselves (atol 0)."""
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1], [-1, 1]], 17)
        vals = (grid.all_points ** 2).sum(axis=1, keepdims=True)
        tri = st.Triangulation(grid, vals)
        policy = st.LambdaFunction(lambda x: 0.0 * x[:, :1])
        dyn = st.LinearSystem([np.array([[0.8, 0.0], [0.0, 0.7]]),
                               np.zeros((2, 1))])
        mid = grid.nindex // 2
        direct = st.Lyapunov(grid, tri, dyn, 0.8, 1.0, 1e-3, policy,
                             initial_set=[mid])
        assert direct._direct_grid_values() is not None
        assert_array_equal(to_numpy(direct.values), vals.ravel())
        direct.update_safe_set()
        wrapped = st.Lyapunov(grid, st.LambdaFunction(lambda x: tri(x)),
                              dyn, 0.8, 1.0, 1e-3, policy,
                              initial_set=[mid])
        assert wrapped._direct_grid_values() is None
        wrapped.update_safe_set()
        direct.update_values()
    assert_array_equal(direct.safe_set, wrapped.safe_set)
    assert_allclose(direct.c_max, wrapped.c_max, rtol=1e-6)
    assert direct.safe_set.sum() > 1
    assert_allclose(to_numpy(direct.values), vals.ravel(), rtol=0, atol=0)
    # Another grid, or a vector-valued candidate, takes the locate.
    with working_dtype("float64"):
        other = st.Lyapunov(st.GridWorld([[-1, 1], [-1, 1]], 9), tri, dyn,
                            0.8, 1.0, 1e-3, policy)
    assert other._direct_grid_values() is None


def _random_vertex_pair():
    """A float32 Triangulation candidate with random vertex values on a
    101x76 grid, in both packages: ``|x|^2`` plus noise of 1e-5,
    dynamics ``x (0.75 + 0.6 |x|^2)`` that contract inside
    ``|x|^2 < 5/12`` only, the states within 0.25 of the origin exempt."""
    rng = np.random.default_rng(3)
    limits = [[-1.0, 1.0], [-0.75, 0.75]]
    shape = (101, 76)

    def dynamics(pkg):
        tensor = pkg is st

        def f(xu):
            x = xu[:, :2]
            sq = ((x ** 2).sum(dim=1, keepdim=True) if tensor
                  else jnp.sum(x ** 2, axis=1, keepdims=True))
            return x * (0.75 + 0.6 * sq)

        return pkg.LambdaFunction(f, input_dim=3, output_dim=2)

    with working_dtype("float32"):
        grid = st.GridWorld(limits, shape)
        jgrid = sl.GridWorld(limits, shape)
        pts = grid.all_points.astype(np.float64)
        vals = ((pts ** 2).sum(axis=1, keepdims=True)
                + 1e-5 * rng.uniform(size=(grid.nindex, 1))).astype(
                    np.float32)
        initial = np.flatnonzero(np.linalg.norm(pts, axis=1) <= 0.25)
        pair = [pkg.Lyapunov(grid_, pkg.Triangulation(grid_, vals),
                             dynamics(pkg), 1.5, 2.0, 1e-4,
                             pkg.LambdaFunction(lambda x: 0.0 * x[:, :1]),
                             initial_set=initial)
                for pkg, grid_ in ((st, grid), (sl, jgrid))]
    return pair[0], pair[1], vals


def test_float32_random_vertices_match_jax():
    """ROADMAP queue 3's instance: before the fix the port's float32
    ``values`` came from the locate and differed from the parameters at
    most vertices; now ``values``, the safe set and ``c_max`` are JAX's."""
    lyap, jlyap, vals = _random_vertex_pair()
    with working_dtype("float32"):
        lyap.update_safe_set()
        jlyap.update_safe_set()
        located = to_numpy(lyap.lyapunov_function(
            lyap.discretization.all_points)).ravel()
    assert to_numpy(lyap.values).dtype == np.float32
    assert_array_equal(to_numpy(lyap.values), np.asarray(jlyap.values))
    assert_array_equal(to_numpy(lyap.values), vals.ravel())
    # The locate rounds differently at many vertices: the fix matters.
    assert (located != vals.ravel()).sum() > 100
    assert 1 < lyap.safe_set.sum() < lyap.discretization.nindex
    assert_array_equal(lyap.safe_set, jlyap.safe_set)
    assert lyap.c_max == float(jlyap.c_max)


# ---------------------------------------------------------------------------
# The sorted sweep with adaptive refinement
# ---------------------------------------------------------------------------
def _quad(pkg):
    if pkg is st:
        return st.LambdaFunction(lambda x: (x ** 2).sum(dim=1, keepdim=True))
    return sl.LambdaFunction(lambda x: (x ** 2).sum(axis=1, keepdims=True))


def _abs(pkg):
    return torch.abs if pkg is st else jnp.abs


def instance_expands(pkg):
    """``tests/test_lyapunov.py:134``: f(x) = 0.9 x on 21 points."""
    grid = pkg.GridWorld([[-1, 1]], 21)
    return pkg.Lyapunov(grid, _quad(pkg), pkg.LinearSystem(
        np.array([[0.9, 0.0]])), 0.9, 1.0, 0.02,
        pkg.LambdaFunction(lambda x: 0.0 * x),
        initial_set=list(range(7, 14)), adaptive=True)


def instance_single_pass(pkg):
    """``tests/test_lyapunov.py:257``: a 15x15 quadratic instance."""
    grid = pkg.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 15)
    p = np.array([[1.0, 0.1], [0.1, 1.5]])
    pts = grid.all_points
    init = np.where(np.einsum("ni,ij,nj->n", pts, p, pts) <= 0.6)[0]
    return pkg.Lyapunov(grid, pkg.QuadraticFunction(p),
                        pkg.LinearSystem(0.9 * np.eye(2)), 0.9, 1.0, 0.05,
                        pkg.LambdaFunction(lambda x: x[:, :0]),
                        initial_set=init, adaptive=True)


def instance_nonlinear(pkg):
    """``tests/test_lyapunov.py:281-308``: unstable outside |x| ~ 0.73,
    the coarse check failing near the origin, at refinement 8."""
    grid = pkg.GridWorld([[-1, 1], [-1, 1]], 41)
    tensor = pkg is st

    def f(xu):
        x = xu[:, :2]
        sq = ((x ** 2).sum(dim=1, keepdim=True) if tensor
              else jnp.sum(x ** 2, axis=1, keepdims=True))
        return x * (0.25 + 0.9 * sq)

    initial = np.where(np.linalg.norm(grid.all_points, axis=1) <= 0.1)[0]
    abs_ = _abs(pkg)
    return pkg.Lyapunov(
        grid, pkg.QuadraticFunction(np.eye(2)),
        pkg.LambdaFunction(f, input_dim=3, output_dim=2), 2.05,
        pkg.LambdaFunction(lambda x: 2.0 * abs_(x)),
        float(np.min(grid.unit_maxes)),
        pkg.LambdaFunction(lambda x: 0.0 * x[:, :1]), initial_set=initial,
        adaptive=True)


def instance_coarse_suffix(pkg):
    """``tests/test_lyapunov.py:399``: coarse passes inside the
    refinement suffix."""
    grid = pkg.GridWorld([[-1, 1], [-1, 1]], [33, 33])
    abs_ = _abs(pkg)
    return pkg.Lyapunov(
        grid, pkg.QuadraticFunction(np.eye(2)),
        pkg.LinearSystem([np.array([[0.92, 0.0], [0.0, 0.9]]),
                          np.zeros((2, 1))]), 0.95,
        pkg.LambdaFunction(lambda x: 2.0 * abs_(x)), 4e-3,
        pkg.LambdaFunction(lambda x: 0.0 * x[:, :1]),
        initial_set=[grid.nindex // 2], adaptive=True)


def instance_knobs(pkg):
    """``tests/test_lyapunov.py:468``: the 3-point instance."""
    return pkg.Lyapunov(pkg.GridWorld([[-1, 1]], 3), _quad(pkg),
                        pkg.LinearSystem(np.array([[1.0, 1.0]])), 0.4, 0.3,
                        0.5, pkg.LambdaFunction(lambda x: -0.1 * x),
                        initial_set=[1], adaptive=True)


def instance_tie_group(pkg):
    """``v = x^2`` on a 1-D grid of quarters, so ``v(x) = v(-x)`` exactly;
    the dynamics contract left of the origin and expand right of it, so
    the first failure in value order, ``x = +0.25``, sorts after its tied
    twin ``-0.25``, which the sorted sweep keeps (a stable sort) and the
    fused sweep would drop."""
    grid = pkg.GridWorld([[-1, 1]], 9)
    tensor = pkg is st

    def f(xu):
        x = xu[:, :1]
        slope = (torch.where(x > 0, 1.5, 0.5) if tensor
                 else jnp.where(x > 0, 1.5, 0.5))
        return slope * x

    return pkg.Lyapunov(grid, _quad(pkg),
                        pkg.LambdaFunction(f, input_dim=2, output_dim=1),
                        1.5, 2.0, 1e-3,
                        pkg.LambdaFunction(lambda x: 0.0 * x),
                        initial_set=[4], adaptive=True)


#: (builder, update_safe_set keyword arguments, sweeps, whether the last
#: sweep rescues states by refinement).
CASES = {
    "expands": (instance_expands, dict(max_refinement=4), 1, True),
    "single_pass": (instance_single_pass, dict(max_refinement=4), 1, False),
    "small_batches": (instance_single_pass,
                      dict(max_refinement=4, batch_size=64), 1, False),
    "nonlinear": (instance_nonlinear, dict(max_refinement=8), 1, True),
    "coarse_suffix": (instance_coarse_suffix, dict(max_refinement=4), 1,
                      True),
    "knobs": (instance_knobs, dict(max_refinement=2), 1, False),
    "no_refinement": (instance_nonlinear, dict(max_refinement=1), 1, False),
    "tie_group": (instance_tie_group, dict(max_refinement=4), 1, False),
    "cannot_shrink": (instance_nonlinear,
                      dict(max_refinement=8, can_shrink=False), 2, False),
}


def both_sweeps(build, kwargs, calls=1):
    """The instance swept ``calls`` times in both packages, float64."""
    with working_dtype("float64"):
        lyap, jlyap = build(st), build(sl)
        for _ in range(calls):
            lyap.update_safe_set(**kwargs)
            jlyap.update_safe_set(**kwargs)
    return lyap, jlyap


@pytest.mark.parametrize("case", sorted(CASES))
def test_refined_sweep_matches_jax(case):
    build, kwargs, calls, rescues = CASES[case]
    lyap, jlyap = both_sweeps(build, kwargs, calls)
    assert_array_equal(lyap.safe_set, jlyap.safe_set)
    assert_array_equal(lyap._refinement, jlyap._refinement)
    assert_allclose(lyap.c_max, jlyap.c_max, rtol=1e-12)
    counts = lyap.last_sweep_counts
    if rescues:
        assert lyap._refinement.max() == kwargs["max_refinement"]
        assert counts["refinement_chunks"] >= 1
        assert counts["rescued_states"] >= 1
    if case == "small_batches":
        assert counts["coarse_batches"] == 4
    if case == "coarse_suffix":
        ref = lyap._refinement[np.array(lyap.safe_set)]
        assert (ref == 1).any() and (ref == 4).any()


def test_tie_group_is_kept_by_the_sorted_sweep():
    """The twin of the first failure is certified by the sorted sweep
    and not by the fused one (``safe_learning_tpu/lyapunov.py:247-249``)."""
    lyap, jlyap = both_sweeps(instance_tie_group, dict(max_refinement=4))
    with working_dtype("float64"):
        fused = instance_tie_group(st)
        fused.adaptive = False
        fused.update_safe_set()
    x = lyap.discretization.all_points[:, 0]
    twin, first_failure = np.flatnonzero(x == -0.25)[0], np.flatnonzero(
        x == 0.25)[0]
    assert lyap.values[twin] == lyap.values[first_failure]
    assert lyap.safe_set[twin] and not lyap.safe_set[first_failure]
    assert not fused.safe_set[twin]
    assert_array_equal(lyap.safe_set, jlyap.safe_set)


def test_result_does_not_depend_on_the_chunk(monkeypatch):
    """Refinement chunks of 16 points (one state at R = 4) give the same
    sweep as one chunk, after more chunks."""
    one = both_sweeps(instance_nonlinear, dict(max_refinement=8))[0]
    monkeypatch.setattr(port_lyapunov, "REFINED_POINTS_PER_CHUNK", 64)
    with working_dtype("float64"):
        small = instance_nonlinear(st)
        small.update_safe_set(max_refinement=8)
    assert small.last_sweep_counts["refinement_chunks"] > \
        one.last_sweep_counts["refinement_chunks"]
    assert_array_equal(small.safe_set, one.safe_set)
    assert_array_equal(small._refinement, one._refinement)
    assert small.c_max == one.c_max


def test_level_margin_and_per_point_margin_match_jax():
    """A level margin trims the sorted prefix with ``searchsorted``, and a
    per-point certificate margin rides along in value order, as in the
    JAX package."""
    with working_dtype("float64"):
        lyap, jlyap = instance_nonlinear(st), instance_nonlinear(sl)
        margin = np.linspace(0.0, 2e-3, lyap.discretization.nindex)
        for target in (lyap, jlyap):
            target.level_margin = 0.02
            target.certificate_margin = margin
            target.update_safe_set(max_refinement=8)
    assert_array_equal(lyap.safe_set, jlyap.safe_set)
    assert_array_equal(lyap._refinement, jlyap._refinement)
    assert_allclose(lyap.c_max, jlyap.c_max, rtol=1e-12)


def test_ignored_knobs_warn():
    with working_dtype("float64"):
        lyap = instance_knobs(st)
        with pytest.warns(RuntimeWarning, match="no effect"):
            lyap.update_safe_set(max_refinement=2, safety_factor=2.0)
        with pytest.warns(RuntimeWarning, match="no effect"):
            lyap.update_safe_set(max_refinement=2, parallel_iterations=8)


# ---------------------------------------------------------------------------
# The refined margin calibration
# ---------------------------------------------------------------------------
def instance_calibration(pkg):
    """A float32 instance whose pipeline rounds the same way in both
    packages, compiled or not (no product that a compiler could fuse
    into an FMA; the matmul meets exact zeros), so that the measured
    error is the same number: ``f(x) = (x_0 / 2, 3 x_1 / 4)``,
    ``v = |x|_1``, ``L_v = 2 |x|``."""
    grid = pkg.GridWorld([[-1, 1], [-1, 1]], 41)
    tensor = pkg is st
    abs_ = _abs(pkg)

    def v(x):
        return (abs_(x).sum(dim=1, keepdim=True) if tensor
                else abs_(x).sum(axis=1, keepdims=True))

    return pkg.Lyapunov(
        grid, pkg.LambdaFunction(v),
        pkg.LinearSystem([np.diag([0.5, 0.75]), np.zeros((2, 1))]), 0.75,
        pkg.LambdaFunction(lambda x: 2.0 * abs_(x)),
        float(np.min(grid.unit_maxes)),
        pkg.LambdaFunction(lambda x: 0.0 * x[:, :1]),
        initial_set=[grid.nindex // 2], adaptive=True)


@pytest.mark.parametrize("refinement", [1, 4])
def test_refined_calibration_matches_jax(refinement):
    """``calibrate_certificate_margin(refinement=R)`` from the same rng:
    with ``R = 4`` half the subsample moves onto refined sub-grid points,
    measured at ``tau / 4``. The margins to 1e-8 relative."""
    with working_dtype("float32"):
        lyap, jlyap = instance_calibration(st), instance_calibration(sl)
        margin = st.oracle.calibrate_certificate_margin(
            lyap, num_samples=256, rng=np.random.default_rng(5),
            refinement=refinement)
        jmargin = sl.oracle.calibrate_certificate_margin(
            jlyap, num_samples=256, rng=np.random.default_rng(5),
            refinement=refinement)
    assert margin > 0.0
    assert_allclose(margin, jmargin, rtol=1e-8)
    assert_allclose(lyap.level_margin, jlyap.level_margin, rtol=1e-8)
    assert lyap.certificate_margin == margin


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------
def test_the_adaptive_instance_needs_the_card_by_default():
    """At the default device the example's instance is built on the
    card; on a PyTorch without CUDA that raises, with no fallback."""
    from chip_smoke import build_adaptive_instance
    from safe_learning_tpu_torch.config import Configuration

    old = st.config.device
    st.config.device = Configuration().device
    try:
        if torch.cuda.is_available():
            lyap, _ = build_adaptive_instance(11, 8)
            assert lyap.dynamics.chol_inv.is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                build_adaptive_instance(11, 8)
    finally:
        st.config.device = old



def test_adaptive_example_loop_matches_jax():
    """The example's loop at 41x41, capacity 64, 3 updates of 4
    measurements, ``R = 4``: certify, then per update
    ``get_safe_sample_batch`` (positive, 1000 samples, the example's
    perturbation and limits, one ``default_rng(0)`` per package) and a
    certify, each with ``can_shrink=False``.

    The instance is symmetric: with a symmetric data set ``x`` and ``-x``
    have the same predictive error in exact arithmetic, and each package
    breaks that tie by its own rounding. One measurement of the true
    pendulum at an asymmetric pair, appended in both packages first,
    removes the symmetry.
    """
    with working_dtype("float64"):
        lyap, jlyap, inst = adaptive_pair(41, 64, "stacked")
        xu = np.array([[0.3, -0.1, 0.05]])
        y = to_numpy(inst["true"](xu[:, :2], xu[:, 2:]))
        assert_allclose(y, np.asarray(inst["jax_true"](xu[:, :2],
                                                       xu[:, 2:])),
                        rtol=1e-12)
        lyap.dynamics = lyap.dynamics.add_data_point(xu, y)
        jlyap.dynamics = jlyap.dynamics.add_data_point(xu, y)
        jmeasure = sl.LambdaFunction(
            lambda sa: inst["jax_true"](sa[:, :2], sa[:, 2:]), input_dim=3,
            output_dim=2)
        rngs = np.random.default_rng(0), np.random.default_rng(0)
        history, jhistory, chunks = [], [], 0
        for update in range(4):
            if update:
                got = st.get_safe_sample_batch(
                    lyap, inst["measure"], 4, np.array([[0.0]]),
                    np.array([[-1.0, 1.0]]), positive=True,
                    num_samples=1000, rng=rngs[0])
                want = sl.get_safe_sample_batch(
                    jlyap, jmeasure, 4, np.array([[0.0]]),
                    np.array([[-1.0, 1.0]]), positive=True,
                    num_samples=1000, rng=rngs[1])
                for a, b in zip(got[:3], want[:3]):
                    assert_allclose(a, np.asarray(b), rtol=0, atol=1e-8)
                assert_array_equal(got[3], np.asarray(want[3]))
            lyap.update_safe_set(can_shrink=False, max_refinement=4)
            jlyap.update_safe_set(can_shrink=False, max_refinement=4)
            chunks += lyap.last_sweep_counts["refinement_chunks"]
            assert_array_equal(lyap.safe_set, jlyap.safe_set)
            assert_array_equal(lyap._refinement, jlyap._refinement)
            assert_allclose(lyap.c_max, jlyap.c_max, rtol=1e-10)
            history.append(lyap.safe_set.mean())
            jhistory.append(jlyap.safe_set.mean())
    assert history == jhistory
    assert lyap.dynamics.count == int(jlyap.dynamics.count) == 14
    assert history[-1] >= history[0] > 0
    assert chunks > 0
