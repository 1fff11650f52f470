"""The port's derived margins (``errorbounds``) against the JAX package's.

Each instance is built from numpy data in both packages, in the float64
lane, and both derive at the same explicit ``unit_roundoff``, so the two
analyses are compared term for term without the hardware factor; the
factor's own appearance (the bound sweep's own rounding in
``_finalize_margin``) is set to the JAX package's value for the
comparison. Scalar margins, per-point arrays, the installed
``level_margin`` and per-candidate exploration margins agree to 1e-10
relative.

Beside the parity: the port's float32 plain path stays within the derived
bound at every grid point (the pattern of
``tests_f32/test_analytic_margin.py:49-73``); the entry points refuse
TF32 and unsupported types; and ``get_safe_sample`` with a per-point
margin takes the per-candidate path and picks the JAX package's row.
"""

import os
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import safe_learning_tpu as sl  # noqa: E402
import safe_learning_tpu_torch as st  # noqa: E402
from safe_learning_tpu import errorbounds as jeb  # noqa: E402
from safe_learning_tpu_torch import convert  # noqa: E402
from safe_learning_tpu_torch import errorbounds as teb  # noqa: E402
from _torch_parity import (port_gp, port_stacked_gp, to_numpy,  # noqa
                           working_dtype)

#: The explicit unit both packages derive at (a float32-like unit: the
#: analysis is parametric in it).
U = 2.0 ** -22
RTOL = 1e-10


@pytest.fixture(autouse=True)
def float64_lane():
    """Both packages in float64, with the port's factor at the JAX
    package's value (it enters ``_finalize_margin`` whatever the unit)."""
    old = st.config.fp_error_factor
    st.config.fp_error_factor = float(sl.config.fp_error_factor)
    with working_dtype("float64"):
        yield
    st.config.fp_error_factor = old


def _port_lyapunov(jlyap, dynamics, policy, v=None, lv=None, lf=None,
                   adaptive=False):
    """The port's Lyapunov beside ``jlyap``: the same grid, tau and initial
    set; the given port pieces, and ``2 |x|`` as ``L_v`` by default."""
    grid = st.GridWorld(np.asarray(jlyap.discretization.limits,
                                   np.float64),
                        jlyap.discretization.shape)
    initial = (None if jlyap.initial_safe_set is None
               else np.where(np.asarray(jlyap.initial_safe_set))[0])
    return st.Lyapunov(
        grid, st.QuadraticFunction(np.eye(2)) if v is None else v, dynamics,
        jlyap._lipschitz_dynamics if lf is None else lf,
        st.LambdaFunction(lambda x: 2.0 * torch.abs(x)) if lv is None
        else lv, jlyap.tau, policy, initial_set=initial, adaptive=adaptive)


def gp_pair():
    """``tests/test_margin_units.py::_gp_instance`` in both packages: an
    RBF GP with a linear prior, the zero policy, ``L_v = 2|x|`` (the
    auto-derived linear form)."""
    from test_margin_units import _gp_instance

    jlyap = _gp_instance()
    return jlyap, _port_lyapunov(jlyap, port_gp(jlyap.dynamics),
                                 st.LinearSystem(np.zeros((1, 2))))


def composite_pair(policy_gain=None, grid_points=31, adaptive=False):
    """The stacked composite-kernel instance of
    ``tests_f32/test_analytic_margin.py:334-372`` (``Linear +
    ActiveDims(Matern32) * ActiveDims(Linear)`` per output); with
    ``policy_gain`` the saturated linear policy and the product on the
    action column of ``:375-405``."""
    a = np.array([[0.3, 0.05], [-0.04, 0.25]])
    b = np.array([[0.1], [0.08]])
    seed, n = (51, 30) if policy_gain is None else (61, 26)
    rng = np.random.default_rng(seed)
    x = np.column_stack([rng.uniform(-0.9, 0.9, n),
                         rng.uniform(-0.9, 0.9, n),
                         rng.uniform(-0.5, 0.5, n) if policy_gain is None
                         else rng.uniform(-0.4, 0.4, n)])
    y = x[:, :2] @ a.T + x[:, 2:] @ b.T + 0.01 * np.sin(2 * x[:, :2])
    second = 1 if policy_gain is None else 2
    gps = []
    for dim in range(2):
        kernel = (
            sl.LinearKernel(variances=[0.02, 0.02, 0.05], input_dim=3)
            + sl.ActiveDims(sl.Matern32(0.3, lengthscales=1.0,
                                        input_dim=1), dims=[0])
            * sl.ActiveDims(sl.LinearKernel(variances=0.05, input_dim=1),
                            dims=[second]))
        gps.append(sl.GaussianProcess(
            kernel, x, y[:, dim:dim + 1], noise_variance=5e-3, beta=2.0,
            mean_function=sl.LinearSystem([a[[dim]], b[[dim]]])))
    stacked = sl.StackedGaussianProcess.from_gps(gps)
    grid = sl.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], grid_points)
    if policy_gain is None:
        jpolicy = sl.LinearSystem(np.zeros((1, 2)))
        policy = st.LinearSystem(np.zeros((1, 2)))
    else:
        k = np.asarray(policy_gain)
        jpolicy = sl.Saturation(sl.LinearSystem(-k), -1.0, 1.0)
        policy = st.Saturation(st.LinearSystem(-k), -1.0, 1.0)
    jlyap = sl.Lyapunov(grid, sl.QuadraticFunction(np.eye(2)), stacked,
                        0.35, sl.LambdaFunction(lambda x: 2.0 * jnp.abs(x)),
                        float(np.min(grid.unit_maxes)), jpolicy,
                        initial_set=[0], adaptive=adaptive)
    return jlyap, _port_lyapunov(jlyap, port_stacked_gp(stacked), policy,
                                 adaptive=adaptive)


def nn_pair():
    """The GP instance with a ``[2, 8, 8, 1]`` tanh / relu / linear MLP
    policy (the flagship's policy form), weights scaled to stay gentle."""
    jlyap, lyap = gp_pair()
    net = sl.NeuralNetwork([2, 8, 8, 1], ["tanh", "relu", None],
                           output_scale=0.5)
    rng = np.random.default_rng(3)
    weights = [0.5 * rng.normal(size=w.shape) for w in net.weights]
    biases = [None if b_ is None else 0.1 * rng.normal(size=b_.shape)
              for b_ in net.biases]
    jnet = net.with_parameters({"weights": tuple(map(jnp.asarray, weights)),
                                "biases": tuple(None if b_ is None else
                                                jnp.asarray(b_)
                                                for b_ in biases)})
    jlyap.policy = jnet
    lyap.policy = convert.neural_network([2, 8, 8, 1],
                                         ["tanh", "relu", None], 0.5,
                                         weights, biases)
    return jlyap, lyap


def _triangulation_values(grid):
    pts = np.asarray(grid.all_points, np.float64)
    rng = np.random.default_rng(5)
    return ((pts ** 2).sum(axis=1) * (1.0 + 0.1 * rng.uniform(size=len(pts))))


_JAX_TRI_LV = jeb.ErrorModel(lambda x: 1e-6 * jnp.abs(x), 2.5)
_PORT_TRI_LV = teb.ErrorModel(lambda x: 1e-6 * torch.abs(x), 2.5)


def triangulation_pair(scale=None):
    """The GP instance with a ``Triangulation`` candidate on an 11x11 grid
    (``scale`` times it when given: the constant-factor rule), ``L_v =
    2|x|`` under an explicit :class:`ErrorModel`."""
    jlyap, lyap = gp_pair()
    jgrid = sl.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 11)
    grid = st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 11)
    vals = _triangulation_values(jgrid)[:, None]
    jtri = sl.Triangulation(jgrid, vals)
    tri = convert.triangulation(grid, vals)
    if scale is not None:
        jtri, tri = jtri * scale, tri * scale
    jlyap.lyapunov_function = jtri
    lyap.lyapunov_function = tri
    return jlyap, lyap


def dynamics_pair(name):
    """Deterministic ODE dynamics at ``tau = 0`` with a linear policy: no
    error term and an exactly zero threshold."""
    if name == "pendulum":
        jdyn = sl.InvertedPendulum(0.15, 0.5, 0.1, 0.01,
                                   normalization=((0.5, 4.4), (0.37,)))
        dyn = convert.inverted_pendulum(0.15, 0.5, 0.1, 0.01,
                                        tx=(0.5, 4.4), tu=(0.37,))
        k, limits, shape = np.array([[0.8, 0.3]]), [[-1.0, 1.0]] * 2, 21
    elif name == "vanderpol":
        jdyn = sl.VanDerPol(damping=0.6, dt=0.01,
                            normalization=np.array([2.0, 3.0]))
        dyn = convert.van_der_pol(0.6, 0.01, tx=np.array([2.0, 3.0]))
        k, limits, shape = np.zeros((0, 2)), [[-0.8, 0.8]] * 2, 21
    else:
        jdyn = sl.CartPole(0.1, 1.0, 0.5, 0.01, 0.01)
        dyn = convert.cart_pole(0.1, 1.0, 0.5, 0.01, 0.01)
        k = np.array([[0.3, 1.2, 0.4, 0.5]])
        limits, shape = [[-0.4, 0.4]] * 4, 5
    d = len(limits)
    jgrid = sl.GridWorld(limits, shape)
    grid = st.GridWorld(limits, shape)
    if k.shape[0]:
        jpolicy, policy = sl.LinearSystem(-k), st.LinearSystem(-k)
    else:
        jpolicy = sl.ConstantFunction(np.zeros((1, 0)))
        policy = st.ConstantFunction(np.zeros((1, 0)))
    jlyap = sl.Lyapunov(jgrid, sl.QuadraticFunction(np.eye(d)), jdyn, 0.9,
                        sl.LambdaFunction(lambda x: 2.0 * jnp.abs(x)), 0.0,
                        jpolicy, initial_set=[0])
    lyap = st.Lyapunov(grid, st.QuadraticFunction(np.eye(d)), dyn, 0.9,
                       st.LambdaFunction(lambda x: 2.0 * torch.abs(x)), 0.0,
                       policy, initial_set=[0])
    return jlyap, lyap


def _both(fn_j, fn_t, jlyap, lyap, **kwargs):
    """The same call in both packages; returns both margins."""
    return (fn_j(jlyap, unit_roundoff=U, **kwargs),
            fn_t(lyap, unit_roundoff=U, **kwargs))


def _assert_margins(jlyap, lyap, got_j, got_t):
    assert_allclose(np.asarray(got_t), np.asarray(got_j), rtol=RTOL, atol=0)
    assert_allclose(lyap.level_margin, jlyap.level_margin, rtol=RTOL)
    assert lyap._certificate_margin_unit == U


@pytest.mark.parametrize("per_point", [False, True])
@pytest.mark.parametrize("build", [gp_pair, composite_pair, nn_pair],
                         ids=["gp", "composite", "nn_policy"])
def test_certificate_margin_matches_jax(build, per_point):
    jlyap, lyap = build()
    got_j, got_t = _both(jeb.analytic_certificate_margin,
                         teb.analytic_certificate_margin, jlyap, lyap,
                         per_point=per_point)
    _assert_margins(jlyap, lyap, got_j, got_t)
    assert np.ndim(got_t) == (1 if per_point else 0)
    if per_point:
        assert_allclose(lyap.certificate_margin, got_t, rtol=0)


def test_refined_saturated_policy_matches_jax():
    """``Saturation(LinearSystem)`` with ``refinement=2`` and ``per_point``:
    the sub-points' coordinate rounding through the state dims, the
    policy's through the action column."""
    jlyap, lyap = composite_pair(policy_gain=[[0.2, -0.1]], grid_points=21,
                                 adaptive=True)
    got_j, got_t = _both(jeb.analytic_certificate_margin,
                         teb.analytic_certificate_margin, jlyap, lyap,
                         refinement=2, per_point=True)
    _assert_margins(jlyap, lyap, got_j, got_t)
    base = teb.analytic_certificate_margin(lyap, unit_roundoff=U,
                                           per_point=True, set_margin=False)
    assert np.all(got_t >= base)


@pytest.mark.parametrize("scale", [None, 2.0], ids=["plain", "scaled"])
def test_triangulation_candidate_matches_jax(scale):
    jlyap, lyap = triangulation_pair(scale)
    got_j = jeb.analytic_certificate_margin(
        jlyap, unit_roundoff=U, lipschitz_model=_JAX_TRI_LV, per_point=True)
    got_t = teb.analytic_certificate_margin(
        lyap, unit_roundoff=U, lipschitz_model=_PORT_TRI_LV, per_point=True)
    _assert_margins(jlyap, lyap, got_j, got_t)


@pytest.mark.parametrize("name", ["pendulum", "vanderpol", "cartpole"])
def test_deterministic_dynamics_at_zero_tau_match_jax(name):
    """The interval ODE programs through the inner Euler steps; at ``tau =
    0`` neither ``L_v`` nor ``L_f`` needs a model."""
    jlyap, lyap = dynamics_pair(name)
    got_j, got_t = _both(jeb.analytic_certificate_margin,
                         teb.analytic_certificate_margin, jlyap, lyap,
                         per_point=True)
    assert np.all(np.isfinite(got_t)) and got_t.max() > 0.0
    _assert_margins(jlyap, lyap, got_j, got_t)


def test_exploration_margins_match_jax():
    """``analytic_exploration_margin``: per candidate row, over the
    perturbed policy actions of every grid state, and over explicit
    actions (installed, with its unit)."""
    jlyap, lyap = gp_pair()
    rng = np.random.default_rng(7)
    rows = np.column_stack([rng.uniform(-1.0, 1.0, (300, 2)),
                            rng.uniform(-0.5, 0.5, 300)])
    got_j, got_t = _both(jeb.analytic_exploration_margin,
                         teb.analytic_exploration_margin, jlyap, lyap,
                         candidates=rows, per_candidate=True,
                         set_margin=False, batch_size=128)
    assert got_t.shape == (300,)
    assert_allclose(got_t, got_j, rtol=RTOL, atol=0)
    whole = teb.analytic_exploration_margin(
        lyap, unit_roundoff=U, candidates=rows, set_margin=False)
    assert whole == pytest.approx(float(np.max(got_t)), rel=1e-12)
    perturb = np.linspace(-0.2, 0.2, 3)[:, None]
    for kwargs in (dict(perturbations=perturb, limits=[[-0.5, 0.5]]),
                   dict(actions=perturb)):
        got_j, got_t = _both(jeb.analytic_exploration_margin,
                             teb.analytic_exploration_margin, jlyap, lyap,
                             **kwargs)
        assert_allclose(got_t, got_j, rtol=RTOL)
        assert lyap.exploration_margin == got_t
        assert lyap._exploration_margin_unit == U


def test_lv_probe_and_linear_form_model():
    """The ``2|Px|`` pattern is adopted as ``G = P + P^T``; a callable
    that differs from the form is not; ``GradientNorm`` of a quadratic is
    the form itself."""
    _, lyap = gp_pair()
    assert_allclose(teb._auto_lv_matrix(lyap), 2.0 * np.eye(2))
    lyap._lipschitz_lyapunov = st.LambdaFunction(
        lambda x: torch.abs(torch.sin(2.0 * x)))
    assert teb._auto_lv_matrix(lyap) is None
    lyap._lipschitz_lyapunov = st.GradientNorm(lyap.lyapunov_function)
    assert_allclose(teb._auto_lv_matrix(lyap), 2.0 * np.eye(2))
    model = teb._lv_error_model(lyap, None, U)
    x = torch.tensor([[0.5, -0.25]], dtype=torch.float64)
    gam = 4 * U / (1 - 4 * U) + 32 * U
    assert_allclose(to_numpy(model.eval_bound(x)), gam * 2.0 * np.array(
        [[0.5, 0.25]]), rtol=1e-14)
    assert model.input_lipschitz == 2.0


def _float32_instance(seed=0, points=25):
    """The well-conditioned GP instance of
    ``tests_f32/test_analytic_margin.py:76-104`` in the port, at
    ``points``^2."""
    rng = np.random.default_rng(11 + seed)
    a = np.array([[0.22, 0.03], [-0.02, 0.18]])
    n = 40
    x = np.column_stack([rng.uniform(-0.9, 0.9, n),
                         rng.uniform(-0.9, 0.9, n), np.zeros(n)])
    y = x[:, :2] @ a.T + 0.01 * np.sin(2 * x[:, :2])
    gp = st.GaussianProcess(st.RBF(0.5, [0.8, 0.8, 1.0], input_dim=3), x,
                            y, noise_variance=1e-2, beta=2.0,
                            mean_function=st.LinearSystem(
                                [a, np.zeros((2, 1))]))
    grid = st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], points)
    vals = np.sum(np.asarray(grid.all_points, np.float64) ** 2, axis=1)
    initial = np.where(vals <= np.quantile(vals, 0.04))[0]
    return st.Lyapunov(grid, st.QuadraticFunction(np.eye(2)), gp,
                       float(np.linalg.norm(a, 2)),
                       st.LambdaFunction(lambda x: 2.0 * torch.abs(x)),
                       float(np.min(grid.unit_maxes)),
                       st.Saturation(st.LinearSystem([[-0.3, 0.1]]), -0.5,
                                     0.5),
                       initial_set=initial)


def _errors_f32(lyap, points, tau):
    """``|margin_f32 - margin_f64|`` of the port's plain path at
    ``points`` (host float32 rows)."""
    from safe_learning_tpu_torch.lyapunov import _negative_batch

    _, dec, thr = _negative_batch(
        lyap.policy, lyap.dynamics, lyap.lyapunov_function,
        lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, tau,
        torch.as_tensor(points))
    got = to_numpy(dec).astype(np.float64) - to_numpy(thr).astype(np.float64)
    return np.abs(got - st.oracle.oracle_margins(lyap, points, tau=tau))


@pytest.mark.parametrize("points", [21, 31])
def test_float32_bound_dominates_every_grid_point(points):
    """At the default unit, the per-point bound dominates the float32 plain
    path's error against the float64 oracle at every grid point, and the
    refined bound at every refined sub-point of every cell."""
    with working_dtype("float32"):
        st.config.fp_error_factor = 6.0
        lyap = _float32_instance(points=points)
        bound = teb.analytic_certificate_margin(lyap, per_point=True,
                                                set_margin=False)
        pts = lyap.discretization.all_points
        err = _errors_f32(lyap, pts, lyap.tau)
        assert np.all(err <= bound), np.max(err / bound)
        assert lyap.discretization.all_points.dtype == np.float32

        r = 2
        refined = teb.analytic_certificate_margin(
            lyap, per_point=True, set_margin=False, refinement=r)
        unit = np.asarray(lyap.discretization.unit_maxes, np.float64)
        for j in np.ndindex(*(r,) * 2):
            off = (0.5 * (1 - 1 / r)) * unit * (-1.0 + 2.0 * np.array(j)
                                                / (r - 1.0))
            sub = pts + off.astype(np.float32)
            err = _errors_f32(lyap, sub, lyap.tau / r)
            assert np.all(err <= refined), np.max(err / refined)


def test_float32_margin_keeps_the_certificate_inside_the_oracle():
    """With the derived scalar margin installed, the float32 sweep's safe
    set lies inside the float64 oracle's and its level at or below it."""
    with working_dtype("float32"):
        st.config.fp_error_factor = 6.0
        lyap = _float32_instance(points=31)
        margin = teb.analytic_certificate_margin(lyap)
        assert margin == lyap.certificate_margin and margin > 0.0
        lyap.update_safe_set()
        safe64, c64 = st.oracle.oracle_safe_set(lyap)
        assert not (np.asarray(lyap.safe_set) & ~safe64).any()
        assert lyap.c_max <= c64 + 1e-6 * max(abs(c64), 1.0)
        assert 0.02 < lyap.safe_set.mean() < 0.98


@pytest.mark.parametrize("flag", ["matmul", "cudnn", "precision"])
def test_tf32_is_refused(flag):
    """The default unit requires full float32 matmuls."""
    _, lyap = gp_pair()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        if flag == "matmul":
            torch.backends.cuda.matmul.allow_tf32 = True
        elif flag == "cudnn":
            torch.backends.cudnn.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="TF32"):
            teb.analytic_certificate_margin(lyap)
        with pytest.raises(RuntimeError, match="TF32"):
            teb.analytic_exploration_margin(lyap, actions=[[0.0]])
        # An explicit unit is the caller's statement and is not checked.
        assert teb.analytic_certificate_margin(lyap, unit_roundoff=U) > 0.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
    assert teb.analytic_certificate_margin(lyap, set_margin=False) > 0.0


def test_unsupported_types_raise():
    """As ``tests_f32/test_analytic_margin.py:124-146``: a bare callable
    dynamics, a genuinely nonlinear ``L_v`` callable, a softplus policy, a
    non-scalar factor, and the ``GradientNorm`` of a ``Triangulation``
    (the extended pipeline's model, ROADMAP item 18)."""
    grid = st.GridWorld([[-1.0, 1.0]], 11)
    lyap = st.Lyapunov(
        grid, st.QuadraticFunction(np.eye(1)),
        st.LambdaFunction(lambda x: 0.5 * x[:, :1], input_dim=2,
                          output_dim=1),
        0.5, 2.0, 0.1, st.LinearSystem(np.zeros((1, 1))))
    with pytest.raises(NotImplementedError, match="dynamics"):
        teb.analytic_certificate_margin(lyap)

    _, lyap = gp_pair()
    lyap._lipschitz_lyapunov = st.LambdaFunction(
        lambda x: torch.abs(torch.sin(2.0 * x)))
    with pytest.raises(NotImplementedError, match="ErrorModel"):
        teb.analytic_certificate_margin(lyap)

    _, lyap = nn_pair()
    lyap.policy = convert.neural_network([2, 1], ["softplus"], 1.0,
                                         [np.ones((2, 1))], [None])
    with pytest.raises(NotImplementedError, match="activations"):
        teb.analytic_certificate_margin(lyap)

    _, lyap = triangulation_pair()
    lyap.lyapunov_function = (lyap.lyapunov_function
                              * st.LinearSystem(np.ones((1, 2))))
    with pytest.raises(NotImplementedError, match="scalar-constant"):
        teb.analytic_certificate_margin(lyap, lipschitz_model=_PORT_TRI_LV)

    _, lyap = triangulation_pair()
    lyap._lipschitz_lyapunov = st.GradientNorm(lyap.lyapunov_function)
    with pytest.raises(NotImplementedError, match="item 18"):
        teb.analytic_certificate_margin(lyap)


def test_device_appended_gp_is_refused():
    """A GP advanced by the working-dtype device append has no float64
    factors: no margin is derived on it, and its float64 refresh clears
    the refusal."""
    from safe_learning_tpu_torch.functions.gp import _device_border_append

    _, lyap = gp_pair()
    gp = lyap.dynamics
    xu = torch.tensor([[0.1, -0.2, 0.0]], dtype=torch.float64)
    lyap.dynamics = _device_border_append(gp, xu, gp(xu)[0])
    with pytest.raises(RuntimeError, match="device"):
        teb.analytic_certificate_margin(lyap, unit_roundoff=U)
    lyap.dynamics = lyap.dynamics.add_data_point(
        np.array([[0.3, 0.3, 0.0]]), np.array([[0.05, 0.05]]))
    assert teb.analytic_certificate_margin(lyap, unit_roundoff=U) > 0.0


def _sample_pair(monkeypatch):
    """The GP instance in both packages with the JAX package's per-point
    margin installed in both, certified, and a spy on each package's
    per-candidate derivation."""
    from safe_learning_tpu import explore as jexplore
    from safe_learning_tpu_torch import explore as texplore

    jlyap, lyap = gp_pair()
    margin = jeb.analytic_certificate_margin(jlyap, per_point=True)
    lyap.certificate_margin = margin
    lyap.level_margin = jlyap.level_margin
    lyap._certificate_margin_unit = jlyap._certificate_margin_unit
    jlyap.update_safe_set()
    lyap.update_safe_set()
    assert_array_equal(np.asarray(lyap.safe_set), np.asarray(jlyap.safe_set))
    assert lyap.c_max == pytest.approx(jlyap.c_max, rel=1e-12)
    calls = {"jax": [], "port": []}
    for name, mod in (("jax", jexplore), ("port", texplore)):
        real = mod._per_candidate_margin

        def spy(lyap_, candidates, _real=real, _log=calls[name]):
            out = _real(lyap_, candidates)
            _log.append(None if out is None else np.asarray(out))
            return out
        monkeypatch.setattr(mod, "_per_candidate_margin", spy)
    return jlyap, lyap, calls


@pytest.mark.parametrize("mode", ["perturbations", "actions"])
def test_get_safe_sample_picks_jax_row_with_per_candidate_margins(
        monkeypatch, mode):
    jlyap, lyap, calls = _sample_pair(monkeypatch)
    perturb = np.linspace(-0.2, 0.2, 5)[:, None]
    kwargs = (dict(perturbations=perturb, limits=np.array([[-0.5, 0.5]]))
              if mode == "perturbations" else dict(actions=perturb))
    sa_j, var_j = sl.get_safe_sample(jlyap, num_samples=64,
                                     rng=np.random.default_rng(0), **kwargs)
    sa_t, var_t = st.get_safe_sample(lyap, num_samples=64,
                                     rng=np.random.default_rng(0), **kwargs)
    assert len(calls["jax"]) == len(calls["port"]) == 1
    assert calls["port"][0] is not None and calls["jax"][0] is not None
    n = len(calls["port"][0])
    # JAX pads its rows to a power of two with copies of the last one.
    assert_allclose(calls["port"][0], calls["jax"][0][:n], rtol=1e-9)
    assert_allclose(sa_t, np.asarray(sa_j), rtol=0, atol=0)
    assert var_t == pytest.approx(var_j, rel=1e-10)


def test_get_safe_sample_keeps_jax_fallbacks(monkeypatch):
    """A dedicated exploration margin wins over the derivation; a sweep
    margin derived at a finer unit, or an instance with no rounding model,
    falls back to the grid-wide collapse."""
    from safe_learning_tpu_torch import explore as texplore

    _, lyap, calls = _sample_pair(monkeypatch)
    perturb = np.linspace(-0.2, 0.2, 5)[:, None]

    def sample():
        return st.get_safe_sample(lyap, perturbations=perturb,
                                  num_samples=16,
                                  rng=np.random.default_rng(0))

    lyap.exploration_margin = 0.0
    sample()
    assert calls["port"] == []
    lyap.exploration_margin = None
    lyap._lipschitz_lyapunov = st.LambdaFunction(
        lambda x: 2.0 * torch.abs(torch.sin(x)))
    sample()
    assert calls["port"] == [None]
    unit = lyap._certificate_margin_unit
    lyap._certificate_margin_unit = 1e-30
    assert texplore._per_candidate_margin(lyap, np.zeros((1, 3))) is None
    lyap._certificate_margin_unit = unit


def test_split_scalar_factor():
    tri = triangulation_pair()[1].lyapunov_function
    const, inner = (-tri).split_scalar_factor("x")
    assert inner is tri and const.constant == -1.0
    const, inner = (3.0 * tri).split_scalar_factor("x")
    assert inner is tri and const.constant == 3.0
    with pytest.raises(NotImplementedError, match="^y supports"):
        (tri * tri).split_scalar_factor("y")
