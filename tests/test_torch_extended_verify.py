"""The port's rigor mode (``ops.extended_verify``) against the JAX package's.

The port checks the decrease in float64 on the card where the JAX package
uses double-word float32; both derive their margins with one rounding
analysis at their own unit (``U_EFF``: ``6 * 2^-53`` in the port,
``2^-40`` in the JAX package). Instances, each built in both packages from
the same numpy data in float32: the 41x41 ill-conditioned stacked GP of
``tests_f32/test_extended_verify.py:40`` (noise 1e-6 and 1e-7, ``L_v =
2|x|`` with its matrix ``2 I``), the 41x41 well-conditioned GP of
``tests_f32/test_hybrid_sweep.py:33`` and the 1-D piecewise-linear
instance of ``tests_f32/test_extended_verify.py:246``. Held here:

- (a) at every grid state the float64 check's margin lies within the
  port's derived extended margin of the float64 oracle's;
- (b) with the port's ``U_EFF`` set to the JAX package's, the three margin
  entry points agree with the JAX package's to 1e-10 relative and the
  level margin to 1e-12 (in the float64 lane, where both analyses compute
  in float64, with the port's float32 factor set to the JAX package's);
- (e) the guard errors of the JAX package's
  ``test_extended_margins_refused_by_f32_pipelines``,
  ``test_hybrid_refuses_unmodeled_lv`` and ``test_hybrid_rejects_bad_mode``
  (no GP count is refused, on the CPU or the card:
  ``tests/test_torch_cuda_extended.py``);
- (f) ``get_safe_sample(extended=True)`` picks the JAX package's row on the
  instance of ``test_extended_exploration_certificate_is_exact``;
- (g) ``calibrate_extended_margin`` is one-sided, tagged with ``U_EFF`` and
  no larger than the derived margin;
- (h) the spectral and the inflated piecewise-linear ``L_v`` programs
  against the JAX package's compiled ones (``hi + lo`` in float64), to
  1e-12 relative, on and off the grid.
"""

import os
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import safe_learning_tpu as sl  # noqa: E402
import safe_learning_tpu_torch as st  # noqa: E402
from safe_learning_tpu.ops import extended_verify as jev  # noqa: E402
from safe_learning_tpu_torch import convert  # noqa: E402
from safe_learning_tpu_torch.ops import extended_verify as ev  # noqa: E402
from safe_learning_tpu_torch.oracle import (  # noqa: E402
    calibrate_extended_margin, oracle_margins, oracle_safe_set)
from _torch_parity import (port_gp, port_stacked_gp, to_numpy,  # noqa
                           working_dtype)

LV_MAT = 2.0 * np.eye(2)
RTOL = 1e-10


def _abs_lv(pkg):
    """``L_v = 2 |x|`` in ``pkg``."""
    if pkg is sl:
        return sl.LambdaFunction(lambda x: 2.0 * jnp.abs(x))
    return st.LambdaFunction(lambda x: 2.0 * torch.abs(x))


def ill_instance(pkg, seed=3, noise=(1e-6, 1e-7)):
    """``tests_f32/test_extended_verify.py:40-65`` in ``pkg``: a stacked GP
    with tiny noise, where the float32 derived margin exceeds the
    threshold."""
    rng = np.random.default_rng(seed)
    grid = pkg.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 41)
    raw = rng.normal(size=(2, 2))
    a = raw * (0.5 / np.linalg.norm(raw, 2))
    nt = 70
    xt = np.column_stack([rng.uniform(-0.4, 0.4, nt),
                          rng.uniform(-0.4, 0.4, nt), np.zeros(nt)])
    yt = xt[:, :2] @ a.T + 0.02 * np.sin(3 * xt[:, :2])
    gp = pkg.StackedGaussianProcess(
        [pkg.RBF(1.0, [0.3] * 3, input_dim=3),
         pkg.Matern32(0.9, [0.35] * 3, input_dim=3)],
        xt, yt, list(noise), betas=2.0,
        mean_functions=[pkg.LinearSystem([a[0:1], np.zeros((1, 1))]),
                        pkg.LinearSystem([a[1:2], np.zeros((1, 1))])])
    tau = float(np.min(grid.unit_maxes))
    vals = np.sum(grid.all_points ** 2, axis=1)
    initial = np.where(vals <= np.quantile(vals, 0.04))[0]
    return pkg.Lyapunov(grid, pkg.QuadraticFunction(np.eye(2)), gp,
                        float(np.linalg.norm(a, 2)), _abs_lv(pkg), tau,
                        pkg.LinearSystem(np.zeros((1, 2))),
                        initial_set=initial)


def well_instance(pkg, seed=0, noise=1e-4, n=41):
    """``tests_f32/test_hybrid_sweep.py:33-58`` in ``pkg``: the bench's
    shape at 41x41 (noise 1e-4)."""
    rng = np.random.default_rng(seed)
    grid = pkg.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], n)
    a = np.array([[0.25, 0.05], [0.0, 0.3]])
    nt = 64
    xt = np.column_stack([rng.uniform(-0.4, 0.4, nt),
                          rng.uniform(-0.4, 0.4, nt), np.zeros(nt)])
    yt = xt[:, :2] @ a.T + 0.02 * np.sin(3 * xt[:, :2])
    gp = pkg.GaussianProcess(
        pkg.RBF(1.0, [0.3] * 3, input_dim=3), xt, yt,
        noise_variance=noise, beta=2.0,
        mean_function=pkg.LinearSystem([a, np.zeros((2, 1))]))
    tau = 0.2 * float(np.min(grid.unit_maxes))
    vals = np.sum(grid.all_points ** 2, axis=1)
    initial = np.where(vals <= 0.01)[0]
    return pkg.Lyapunov(grid, pkg.QuadraticFunction(np.eye(2)), gp,
                        float(np.linalg.norm(a, 2)), _abs_lv(pkg), tau,
                        pkg.LinearSystem(np.zeros((1, 2))),
                        initial_set=initial)


def pwl_instance(pkg, n_grid=51):
    """``tests_f32/test_extended_verify.py:246-275`` in ``pkg``: a 1-D
    piecewise-linear candidate on the sweep's grid, a composite kernel, a
    saturated policy and noise 1e-7."""
    rng = np.random.default_rng(5)
    grid = pkg.GridWorld([[-1.0, 1.0]], n_grid)
    kernel = (pkg.ActiveDims(pkg.Matern32(variance=0.4 ** 2,
                                          lengthscales=1.0, input_dim=1),
                             [0])
              * pkg.ActiveDims(pkg.LinearKernel(0.2, input_dim=1), [1])
              + pkg.ActiveDims(pkg.Matern32(variance=0.1, lengthscales=0.8,
                                            input_dim=1), [0]))
    nt = 30
    xt = np.column_stack([rng.uniform(-0.8, 0.8, nt),
                          rng.uniform(-0.5, 0.5, nt)])
    yt = 0.1 * xt[:, :1] + 0.1 * xt[:, 1:2] + 0.02 * np.sin(2 * xt[:, :1])
    gp = pkg.GaussianProcess(kernel, xt, yt, noise_variance=1e-7, beta=2.0,
                             mean_function=pkg.LinearSystem([[0.1, 0.1]]))
    theta = np.abs(grid.all_points[:, 0])[:, None].astype(np.float32)
    policy = pkg.Saturation(pkg.LinearSystem([[-0.3]]), -0.5, 0.5)
    tau = float(np.min(grid.unit_maxes))
    init = np.where(np.abs(grid.all_points[:, 0]) <= 0.1)[0]
    return pkg.Lyapunov(grid, pkg.Triangulation(grid, theta), gp, 0.3, 1.0,
                        tau, policy, initial_set=init)


#: Each instance's constructor and the lv_matrix its margins are derived with.
INSTANCES = {"ill": (ill_instance, LV_MAT), "well": (well_instance, LV_MAT),
             "pwl": (pwl_instance, None)}


@pytest.fixture
def float32_lane():
    with working_dtype("float32"):
        yield


@pytest.fixture(scope="module")
def jax_ill():
    """The JAX package's ill-conditioned instance, certified by its
    extended sweep with its derived margin (the double-word pipeline is
    compiled once here)."""
    with working_dtype("float32"):
        jlyap = ill_instance(sl)
        jev.extended_certificate_margin(jlyap, lv_matrix=LV_MAT)
        jlyap.update_safe_set(extended=True)
    return jlyap


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_extended_margin_dominates_the_oracle_gap(name, float32_lane):
    """(a): ``|ExtendedSweep.margins - oracle| <= m_ext`` at every grid
    state, for the scalar and the per-state derived margin."""
    build, lv_matrix = INSTANCES[name]
    lyap = build(st)
    margin = ev.extended_certificate_margin(lyap, lv_matrix=lv_matrix,
                                            set_margin=False)
    per_point = ev.extended_certificate_margin(
        lyap, lv_matrix=lv_matrix, set_margin=False, per_point=True)
    pts = lyap.discretization.all_points
    gap = np.abs(ev.ExtendedSweep(lyap, lv_matrix=lv_matrix).margins(pts)
                 - oracle_margins(lyap, pts))
    assert (gap <= margin).all()
    assert (gap <= per_point).all()
    assert_allclose(np.max(per_point), margin, rtol=1e-12)
    # The float64 unit's margin is far below the threshold's scale.
    threshold = to_numpy(lyap.threshold(lyap._device_points()))
    assert margin < 0.05 * np.abs(threshold).max()


@pytest.fixture
def jax_unit(monkeypatch):
    """Both packages in float64 with the port's extended unit at the JAX
    package's 2^-40 and its float32 factor at the JAX package's (it enters
    the bound sweep's own-rounding factor and the level margin)."""
    monkeypatch.setattr(ev, "U_EFF", jev.U_EFF)
    monkeypatch.setattr(st.config, "fp_error_factor",
                        float(sl.config.fp_error_factor))
    with working_dtype("float64"):
        yield


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_margins_match_jax_at_its_unit(name, jax_unit):
    """(b): the certificate, exploration and band margins and the level
    margin, port against JAX at one unit."""
    build, lv_matrix = INSTANCES[name]
    jlyap, lyap = build(sl), build(st)
    # The port's GP adopts the JAX package's factors: at noise 1e-7 the
    # two host factorizations differ by about 1e-9 relative, which the
    # comparison of two analyses at 1e-10 must not see.
    gp = jlyap.dynamics
    lyap.dynamics = (port_stacked_gp(gp, adopt=True)
                     if isinstance(gp, sl.StackedGaussianProcess)
                     else port_gp(gp, adopt=True))
    jm = jev.extended_certificate_margin(jlyap, lv_matrix=lv_matrix)
    m = ev.extended_certificate_margin(lyap, lv_matrix=lv_matrix)
    assert_allclose(m, jm, rtol=RTOL)
    assert_allclose(lyap.level_margin, jlyap.level_margin, rtol=1e-12)
    assert lyap._certificate_margin_unit == jev.U_EFF

    perturb = np.linspace(-0.3, 0.3, 5)[:, None]
    limits = np.array([[-0.5, 0.5]])
    jme = jev.extended_exploration_margin(jlyap, perturbations=perturb,
                                          limits=limits, lv_matrix=lv_matrix)
    me = ev.extended_exploration_margin(lyap, perturbations=perturb,
                                        limits=limits, lv_matrix=lv_matrix)
    assert_allclose(me, jme, rtol=RTOL)
    assert lyap._exploration_margin_unit == jev.U_EFF

    jband = jev.hybrid_band_margin(jlyap, lv_matrix=lv_matrix)
    band = ev.hybrid_band_margin(lyap, lv_matrix=lv_matrix)
    assert_allclose(band, np.asarray(jband), rtol=RTOL)


def test_f32_pipelines_refuse_extended_margins(float32_lane):
    """(e), ``test_extended_margins_refused_by_f32_pipelines``: a margin
    derived at ``U_EFF`` is refused by the float32 sweep and scorer, in
    both packages, consumed by the extended sweep, and lifted by a manual
    assignment."""
    from safe_learning_tpu.explore import _margin_of as jmargin_of
    from safe_learning_tpu_torch.explore import _margin_of

    perturb = np.linspace(-0.3, 0.3, 5)[:, None].astype(np.float32)
    limits = np.array([[-0.5, 0.5]])
    for pkg, mod, margin_of in ((sl, jev, jmargin_of), (st, ev, _margin_of)):
        lyap = ill_instance(pkg)
        mod.extended_certificate_margin(lyap, lv_matrix=LV_MAT)
        with pytest.raises(RuntimeError, match="extended"):
            lyap.update_safe_set()
        with pytest.raises(RuntimeError, match="extended"):
            margin_of(lyap)
        lyap.update_safe_set(extended=True)
        assert np.asarray(lyap.safe_set).any()
        mod.extended_exploration_margin(lyap, perturbations=perturb,
                                        limits=limits)
        with pytest.raises(RuntimeError, match="extended"):
            margin_of(lyap)
        lyap.exploration_margin = 1e-3
        assert margin_of(lyap) == 1e-3
        lyap.certificate_margin = 1e-3
        lyap.update_safe_set()


def test_hybrid_guards(float32_lane):
    """(e), ``test_hybrid_refuses_unmodeled_lv`` and
    ``test_hybrid_rejects_bad_mode``, in both packages."""
    for pkg, mod in ((sl, jev), (st, ev)):
        lyap = ill_instance(pkg)
        grid = lyap.discretization
        tri = pkg.Triangulation(
            grid, np.sum(grid.all_points ** 2, axis=1)[:, None])
        lyap._lipschitz_lyapunov = pkg.GradientNorm(tri)
        with pytest.raises(NotImplementedError, match="hybrid"):
            mod.hybrid_band_margin(lyap)
        lyap = well_instance(pkg)
        with pytest.raises(ValueError, match="extended"):
            lyap.update_safe_set(extended="turbo")


def panel_limit_instance(n):
    """A stacked Matern-3/2 GP holding ``n`` data points on a 5x5 grid."""
    rng = np.random.default_rng(0)
    x = np.column_stack([rng.uniform(-1, 1, (n, 2)), np.zeros(n)])
    y = 0.5 * x[:, :2]
    gp = st.StackedGaussianProcess(
        [st.Matern32(0.5, [0.4] * 3, input_dim=3)] * 2, x, y, [1e-3] * 2)
    grid = st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 5)
    return st.Lyapunov(grid, st.QuadraticFunction(np.eye(2)), gp, 0.5,
                       _abs_lv(st), 0.1, st.LinearSystem(np.zeros((1, 2))),
                       initial_set=[12])


def test_plain_twin_takes_any_count(float32_lane):
    """On the CPU the float64 predict is kernel 3's plain twin, which has
    no panel body: past the card's float64 panel limit (count 256, the
    strip body's first count there) the sweep runs, within its derived
    margin of the oracle."""
    lyap = panel_limit_instance(257)
    margin = ev.extended_certificate_margin(lyap, lv_matrix=LV_MAT,
                                            set_margin=False)
    pts = lyap.discretization.all_points
    gap = np.abs(ev.ExtendedSweep(lyap, lv_matrix=LV_MAT).margins(pts)
                 - oracle_margins(lyap, pts))
    assert (gap <= margin).all()


def test_extended_sample_picks_jax_row(jax_ill, float32_lane):
    """(f): on ``test_extended_exploration_certificate_is_exact``'s
    instance, fed the JAX package's certified set and level,
    ``get_safe_sample(extended=True)`` derives its margin over the
    candidates, scores them in float64 and picks the JAX package's row;
    the row's float64 future value is below ``c_max``."""
    lyap = ill_instance(st)
    ev.extended_certificate_margin(lyap, lv_matrix=LV_MAT)
    lyap.safe_set = np.array(jax_ill.safe_set)
    lyap.c_max = float(jax_ill.c_max)
    perturb = np.linspace(-0.3, 0.3, 5)[:, None].astype(np.float32)
    limits = np.array([[-0.5, 0.5]])
    kwargs = dict(perturbations=perturb, limits=limits, positive=True,
                  num_samples=200, extended=True)
    jsa, jvar = sl.get_safe_sample(jax_ill, rng=np.random.default_rng(0),
                                   **kwargs)
    sa, var = st.get_safe_sample(lyap, rng=np.random.default_rng(0),
                                 **kwargs)
    assert_array_equal(sa, np.asarray(jsa))
    assert_allclose(var, jvar, rtol=1e-6)
    _, inside, _ = lyap._get_extended_sweep().score_candidates(
        sa, lyap.c_max, 0.0)
    assert bool(inside[0])


def test_calibrated_extended_margin(float32_lane):
    """(g): the measured margin is ``2 max(oracle - extended, 0)`` over the
    calibration sample, tagged with ``U_EFF`` (the plain sweep refuses
    it), no larger than the derived margin, and its sweep lies inside the
    oracle's set."""
    from safe_learning_tpu_torch.oracle import _calibration_sample

    lyap = ill_instance(st, seed=6)
    lyap.extended_lv_matrix = LV_MAT
    m = calibrate_extended_margin(lyap, num_samples=512)
    assert m >= 0.0 and lyap.certificate_margin == m
    assert lyap._certificate_margin_unit == ev.U_EFF
    pts, _ = _calibration_sample(lyap, 512, np.random.default_rng(0), 1)
    gap = oracle_margins(lyap, pts) - lyap._get_extended_sweep().margins(pts)
    assert m == 2.0 * float(np.max(np.maximum(gap, 0.0)))
    assert m <= ev.extended_certificate_margin(lyap, set_margin=False)
    with pytest.raises(RuntimeError, match="extended"):
        lyap.update_safe_set()
    lyap.update_safe_set(extended=True)
    safe64, c64 = oracle_safe_set(lyap)
    assert not (np.asarray(lyap.safe_set) & ~safe64).any()
    # c_max is a float32 value, c64 its state's float64 value.
    assert lyap.c_max <= c64 + 1e-6 * max(abs(c64), 1.0)


def _jax_program(compiled, params, pts):
    """A compiled JAX ``L`` program at float32 points, ``hi + lo`` in
    float64."""
    fn = compiled[0]
    hi, lo = jax.jit(fn)(tuple(params), (jnp.asarray(pts),
                                         jnp.zeros_like(jnp.asarray(pts))))
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _relative(got, want):
    return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30))


@pytest.mark.parametrize("ord_", [None, 1, np.inf])
def test_gradnorm_programs_match_jax(ord_, float32_lane):
    """(h): the inflated piecewise-linear gradient norm (2-D and 1-D, on the
    grid's vertices, at random points and outside the domain) and the
    spectral bound of a network, against the JAX package's compiled
    programs."""
    rng = np.random.default_rng(9)
    for limits, shape in (([[-1.0, 1.0], [-0.5, 0.5]], [9, 7]),
                          ([[-1.0, 1.0]], [11])):
        jgrid, grid = sl.GridWorld(limits, shape), st.GridWorld(limits,
                                                                 shape)
        theta = rng.normal(size=(jgrid.nindex, 1)).astype(np.float32)
        jtri, tri = sl.Triangulation(jgrid, theta), st.Triangulation(grid,
                                                                      theta)
        d = len(shape)
        lo = np.asarray(limits)[:, 0] - 0.2
        hi = np.asarray(limits)[:, 1] + 0.2
        pts = np.vstack([np.asarray(grid.all_points, np.float32),
                         rng.uniform(lo, hi, (512, d)).astype(np.float32)])
        params = []
        want = _jax_program(jev._compile_gradnorm_pwl(
            sl.GradientNorm(jtri, ord=ord_), d, params), params, pts)
        fn, dv = ev._gradnorm_pwl(st.GradientNorm(tri, ord=ord_), d, "cpu")
        got = to_numpy(fn(torch.as_tensor(pts).double()))
        assert got.shape == want.shape == (len(pts), dv)
        assert _relative(got, want) <= 1e-12

    jnet = sl.NeuralNetwork([2, 8, 8, 1], ["tanh", "relu", None],
                            output_scale=0.5)
    weights = [(0.5 * rng.normal(size=w.shape)).astype(np.float32)
               for w in jnet.weights]
    biases = [None if b is None else
              (0.1 * rng.normal(size=b.shape)).astype(np.float32)
              for b in jnet.biases]
    jnet = jnet.with_parameters({
        "weights": tuple(map(jnp.asarray, weights)),
        "biases": tuple(None if b is None else jnp.asarray(b)
                        for b in biases)})
    net = convert.neural_network([2, 8, 8, 1], ["tanh", "relu", None], 0.5,
                                 weights, biases)
    params = []
    want = _jax_program(jev._compile_gradnorm_spectral(
        sl.GradientNorm(jnet, ord=ord_), params), params, pts[:16, :1]
        .repeat(2, axis=1))
    fn, dv = ev._gradnorm_spectral(st.GradientNorm(net, ord=ord_), "cpu")
    got = to_numpy(fn(torch.zeros((16, 2), dtype=torch.float64)))
    assert got.shape == want.shape == (16, dv)
    assert _relative(got, want) <= 1e-12


def test_extended_gp_evaluate_is_the_float64_posterior(float32_lane):
    """``extended_gp_evaluate``: the posterior of the sweep's float64 copy,
    bit for bit the oracle's lifted GP on the CPU, and within the JAX
    package's own bound of its double-word evaluation
    (``tests_f32/test_extended_verify.py:68-81``: 1e-9 and 1e-8 of the
    mean's scale)."""
    from safe_learning_tpu_torch.oracle import _oracle_env, lift64

    jlyap, lyap = ill_instance(sl), ill_instance(st)
    pts = np.asarray(lyap.discretization.all_points[::17], np.float32)
    q = np.column_stack([pts, np.zeros(len(pts), np.float32)])
    mean, err = ev.extended_gp_evaluate(lyap.dynamics, q)
    with _oracle_env():
        m64, e64 = lift64(lyap.dynamics).evaluate(
            torch.as_tensor(q, dtype=torch.float64))
    assert_array_equal(mean, to_numpy(m64))
    assert_array_equal(err, to_numpy(e64))
    jmean, jerr = jev.extended_gp_evaluate(jlyap.dynamics, q)
    scale = max(1.0, float(np.max(np.abs(jmean))))
    assert np.max(np.abs(mean - jmean)) < 1e-9 * scale
    assert np.max(np.abs(err - jerr)) < 1e-8 * scale
