"""The port's streamed sweep against the JAX package's batched sweep.

Both packages' ``fused_sweep_limit`` and ``gp_batch_size`` are lowered for
each test, so a 101x101 grid streams in batches of 1,000 states: the JAX
package through its value-sorted batched prefix
(``safe_learning_tpu/lyapunov.py:1035-1275``), the port through one
streamed pass that keeps the smallest ``(value, flat index)`` over
failing states. In float64 the safe sets and the refinement levels are
equal and ``c_max`` agrees to 1e-6 relative, ties at ``v_bad`` included,
with ``level_margin`` 0 and above it, ``can_shrink=False``, an initial set,
no safe state and every state safe. The states made on the device
(``GridWorld.states_in_range``) are ``all_points`` bit for bit, past flat
index 2^24 too.
"""

import json

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st

from _torch_parity import (jax_bench_lyapunov, port_gp, to_numpy,
                           working_dtype)

LIMIT = 1000
C_MAX_RTOL = 1e-6


@pytest.fixture(autouse=True)
def streamed(monkeypatch):
    """Both packages stream any grid above ``LIMIT`` points, in batches of
    ``LIMIT``; float64 working dtype."""
    for cfg in (sl.config, st.config):
        monkeypatch.setattr(cfg, "fused_sweep_limit", LIMIT)
        monkeypatch.setattr(cfg, "gp_batch_size", LIMIT)
    with working_dtype("float64"):
        yield


def bench_pair(num_points=101, initial=True):
    """``bench.py``'s instance in both packages (the port's GP from the
    JAX package's data).

    The JAX package's ``x^T x`` (XLA on the CPU) is one ulp from the
    exactly rounded ``x^2 + y^2`` at about 14 % of the states, and that
    reorders states tied in value (``(x, y)`` and ``(y, x)``). The port
    rounds exactly, as numpy does. So the JAX sweep orders the port's
    values (its ``update_values`` sets them); each package still runs its
    own decrease check.
    """
    jlyap, _ = jax_bench_lyapunov(num_points)
    initial_set = (np.flatnonzero(jlyap.initial_safe_set) if initial
                   else None)
    if not initial:
        jlyap = sl.Lyapunov(jlyap.discretization, jlyap.lyapunov_function,
                            jlyap.dynamics, jlyap._lipschitz_dynamics,
                            jlyap._lipschitz_lyapunov, jlyap.tau,
                            jlyap.policy)
    plyap = st.Lyapunov(
        st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], num_points),
        st.QuadraticFunction(np.eye(2)), port_gp(jlyap.dynamics),
        jlyap._lipschitz_dynamics,
        st.LambdaFunction(lambda x: 2.0 * torch.abs(x)), jlyap.tau,
        st.LinearSystem(np.zeros((1, 2))), initial_set=initial_set)
    points = plyap.discretization.all_points
    exact = np.sum(points * points, axis=1)
    assert_array_equal(to_numpy(plyap.values), exact)

    def update_values(batch_size=None):
        jlyap.values = exact

    jlyap.update_values = update_values
    return jlyap, plyap


def tie_pair(monkeypatch):
    """A 1-D instance with exact ties at ``v_bad`` on both sides of
    ``i_bad``: a piecewise-constant-by-plateau candidate on the grid
    (``Triangulation`` vertex values ``round(10 |x|) / 10``, read
    directly), ``x+ = x / 4``, ``tau = 0``, the plateau ``|x| < 0.05``
    exempt, and a per-point margin that fails the state at x = 0.3 (flat
    index 65). Its plateau ``v = 0.3`` holds states at lower indices (x
    near -0.3, and 0.26, 0.28) and at higher ones (0.32, 0.34). Both
    packages stream it in batches of 25."""
    for cfg in (sl.config, st.config):
        monkeypatch.setattr(cfg, "fused_sweep_limit", 25)
        monkeypatch.setattr(cfg, "gp_batch_size", 25)
    n = 101
    x = np.linspace(-1.0, 1.0, n)
    params = np.round(10.0 * np.abs(x)) / 10.0
    initial = np.flatnonzero(np.abs(x) < 0.05)
    margin = np.zeros(n)
    margin[65] = 10.0
    pair = []
    for pkg in (sl, st):
        grid = pkg.GridWorld([[-1.0, 1.0]], n)
        lyap = pkg.Lyapunov(
            grid, pkg.Triangulation(grid, params.copy()),
            pkg.LinearSystem(np.array([[0.25, 0.0]])), 0.25, 1.0, 0.0,
            pkg.LinearSystem(np.array([[0.0]])), initial_set=initial)
        lyap.certificate_margin = margin
        pair.append(lyap)
    return pair


def assert_same_sweep(jlyap, plyap):
    assert_array_equal(plyap.safe_set, jlyap.safe_set)
    assert_array_equal(plyap._refinement, jlyap._refinement)
    if np.isfinite(jlyap.c_max):
        assert_allclose(plyap.c_max, jlyap.c_max, rtol=C_MAX_RTOL)
    else:
        assert plyap.c_max == jlyap.c_max == -np.inf


def sorted_prefix(values, passed, level_margin=0.0):
    """The JAX package's rule on host arrays: the stable value sort's
    prefix before the first state that does not pass, trimmed by
    ``level_margin``. Returns ``(safe, c_max)``."""
    order = np.argsort(values, kind="stable")
    ok = passed[order]
    stop = len(values) if ok.all() else int(np.argmin(ok))
    max_index = stop - 1
    if level_margin > 0.0 and 0 <= max_index < len(values) - 1:
        max_index = min(max_index, int(np.searchsorted(
            values[order], values[order[stop]] - level_margin,
            side="left")) - 1)
    safe = np.zeros(len(values), dtype=bool)
    safe[order[:max_index + 1]] = True
    return safe, (values[order[max_index]] if max_index >= 0 else -np.inf)


def test_bench_instance_matches_jax():
    jlyap, plyap = bench_pair()
    jlyap.update_safe_set()
    plyap.update_safe_set()
    assert 0.05 < plyap.safe_set.mean() < 0.95
    assert plyap.last_sweep_counts["coarse_batches"] == 11
    assert_same_sweep(jlyap, plyap)


def test_level_margin_and_can_shrink_match_jax():
    jlyap, plyap = bench_pair()
    for lyap in (jlyap, plyap):
        lyap.certificate_margin = 1e-4
        lyap.level_margin = 2e-3
        lyap.update_safe_set()
    assert_same_sweep(jlyap, plyap)
    # can_shrink=False keeps (and exempts) a previous safe set.
    previous = np.zeros(plyap.discretization.nindex, dtype=bool)
    previous[::7] = True
    for lyap in (jlyap, plyap):
        lyap.safe_set = previous | lyap.safe_set
        lyap.level_margin = 0.0
        lyap.update_safe_set(can_shrink=False)
    assert_same_sweep(jlyap, plyap)
    assert plyap.safe_set[previous].all()


def test_no_initial_set_and_explicit_batch_match_jax():
    jlyap, plyap = bench_pair(initial=False)
    jlyap.update_safe_set(batch_size=300)
    plyap.update_safe_set(batch_size=300)
    assert plyap.last_sweep_counts["coarse_batches"] == 35
    assert_same_sweep(jlyap, plyap)


@pytest.mark.parametrize("margin,fraction", [(1e6, 0.0), (-1e6, 1.0)])
def test_no_safe_state_and_every_state_safe_match_jax(margin, fraction):
    jlyap, plyap = bench_pair(initial=False)
    for lyap in (jlyap, plyap):
        lyap.certificate_margin = margin
        lyap.update_safe_set()
    assert plyap.safe_set.mean() == fraction
    assert_same_sweep(jlyap, plyap)
    if fraction == 1.0:
        assert plyap.c_max == float(plyap.values.max())


@pytest.mark.parametrize("level_margin", [0.0, 0.05])
def test_ties_at_v_bad_match_jax(level_margin, monkeypatch):
    """States tied with ``v_bad`` are safe below ``i_bad`` and not above
    it: a sweep that dropped the ties (``v < v_bad``) would miss states 62
    and 64 and those near -0.3, and fail here."""
    jlyap, plyap = tie_pair(monkeypatch)
    for lyap in (jlyap, plyap):
        lyap.level_margin = level_margin
        lyap.update_safe_set()
    assert_same_sweep(jlyap, plyap)
    values = to_numpy(plyap.values)
    tied = np.flatnonzero(values == 0.3)
    if level_margin == 0.0:
        assert plyap.c_max == 0.3
        assert plyap.last_sweep_counts["coarse_batches"] == 5
        assert_array_equal(plyap.safe_set[tied], tied < 65)
        assert (tied < 65).sum() >= 4 and (tied > 65).sum() >= 2
    else:
        assert not plyap.safe_set[tied].any()
        assert plyap.c_max == 0.2


def test_streamed_equals_the_fused_sweep_but_for_ties(monkeypatch):
    """On one port instance the streamed and the fused sweeps differ only
    at states tied with ``v_bad`` (the fused sweep excludes them), and the
    streamed one equals the sorted-prefix rule over the fused sweep's
    verdicts."""
    _, plyap = tie_pair(monkeypatch)
    plyap.update_safe_set()
    assert plyap.last_sweep_counts["coarse_batches"] == 5
    streamed = np.array(plyap.safe_set)
    monkeypatch.setattr(st.config, "fused_sweep_limit", 10 ** 6)
    monkeypatch.setattr(st.config, "gp_batch_size", 10 ** 6)
    plyap.safe_set = np.zeros(plyap.discretization.nindex, dtype=bool)
    plyap.update_safe_set()
    fused = np.array(plyap.safe_set)
    values = to_numpy(plyap.values)
    differ = np.flatnonzero(streamed != fused)
    assert len(differ) > 0 and (values[differ] == 0.3).all()
    assert not fused[values == 0.3].any()
    negative = plyap.safety_constraint(plyap.policy, include_initial=True)
    margin_ok = np.ones_like(negative)
    margin_ok[65] = False
    rule, c_max = sorted_prefix(values, negative & margin_ok)
    assert_array_equal(streamed, rule | plyap.initial_safe_set)
    assert c_max == 0.3


def test_streamed_values_equal_one_pass():
    _, plyap = bench_pair()
    one_pass = to_numpy(st.lyapunov._values_batch(
        plyap.lyapunov_function, plyap._device_points()))
    plyap.update_values(batch_size=257)
    assert_array_equal(to_numpy(plyap.values), one_pass)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_states_in_range_are_all_points(dtype):
    with working_dtype(dtype):
        grid = st.GridWorld([[-1.0, 2.0], [-0.5, 0.5], [0.0, 3.0]],
                            [7, 11, 13])
        states = grid.states_in_range(0, grid.nindex)
        assert states.dtype == st.config.dtype
        assert_array_equal(to_numpy(states), grid.all_points)
        assert_array_equal(to_numpy(grid.states_in_range(100, 537)),
                           grid.all_points[100:537])
        idx = np.array([0, 5, 999, grid.nindex - 1])
        assert_array_equal(grid.points_at(idx), grid.all_points[idx])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_states_in_range_exact_past_2_to_the_24(dtype):
    """Flat indices above 2^24 (where float32 stops holding integers)
    give the states of ``all_points``'s construction: the per-axis
    ``linspace`` values."""
    with working_dtype(dtype):
        grid = st.GridWorld([[-1.0, 1.0], [-2.0, 3.0]], [5003, 4001])
        start = 2 ** 24 + 3
        states = to_numpy(grid.states_in_range(start, start + 4000))
        flat = np.arange(start, start + 4000)
        i, j = np.unravel_index(flat, grid.shape)
        axes = [np.linspace(lo, hi, n).astype(st.config.np_dtype)
                for (lo, hi), n in zip([(-1.0, 1.0), (-2.0, 3.0)],
                                       grid.shape)]
        assert_array_equal(states, np.column_stack([axes[0][i],
                                                    axes[1][j]]))
        assert_array_equal(states, grid.points_at(flat))


def test_giant_sweep_module_at_a_small_size():
    """``benchmarks/giant_sweep_1e8.run``'s flow at 201^2 points in
    batches of 4,096 (float32, the limit lowered to 1,000): two equal
    sweeps, no certified sampled state outside the float64 oracle's, the
    level at or below the oracle's, and the initial set as ``bench.py``
    finds it on the whole grid."""
    from safe_learning_tpu_torch.benchmarks import giant_sweep_1e8

    with working_dtype("float32"):
        lines = []
        out = giant_sweep_1e8.run(points=201, batch=4096,
                                  oracle_samples=5000, emit=lines.append)
        grid = out["lyap"].discretization
        values = st.QuadraticFunction(np.eye(2))(grid.all_points)
        want = np.flatnonzero(to_numpy(values).reshape(-1) <= 0.01)
    assert [json.loads(line)["section"] for line in lines] == [
        "backend", "build", "margin", "sweep_first", "sweep_steady",
        "oracle_subsample", "summary"]
    assert out["violations"] == 0 and out["level_ok"]
    assert out["lyap"].last_sweep_counts["coarse_batches"] == 10
    assert_array_equal(np.flatnonzero(out["lyap"].initial_safe_set), want)
    assert 0.05 < out["safe_fraction"] < 0.95
