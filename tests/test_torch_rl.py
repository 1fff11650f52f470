"""The port's ``rl.py`` against the JAX package's, in float64.

- ``_pwl_fixed_point`` on a 9x7 ``Triangulation`` with linear dynamics and
  an LQ reward, at the default tolerance and at a loose one (1e-4, where
  the frozen iterate decides the result): values within 1e-12 relative
  and the same iteration count; ``OptimizationError`` on divergence;
- ``future_values`` and ``bellmann_error``, with and without the Lyapunov
  penalty, on the flagship's stacked composite-kernel GP (capacity 8, 5
  points), an MLP policy and a ``Triangulation`` value function: within
  1e-10 relative;
- the ascent loss's gradient with respect to every policy weight against
  ``jax.grad``: within 1e-8 relative;
- 5 ascent steps fed the JAX package's own minibatches (its key splits
  reproduced here): weights and losses within 1e-9 relative;
- ``Saturation`` bounds kept, the parameterless policy rejected, the
  trained policy's tensors detached;
- ``policy_iteration`` on the mountain car of
  ``basic_dynamic_programming.py`` (9x9 grid): values and policy within
  1e-9, iteration count and ``converged`` equal;
- ``discrete_policy_optimization`` with and without a constraint, and the
  DARE case of ``tests/test_rl.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu.rl import _pwl_fixed_point as jax_fixed_point
from safe_learning_tpu_torch import convert
from safe_learning_tpu_torch.rl import _pwl_fixed_point

from _torch_parity import port_stacked_gp, to_numpy, working_dtype

RTOL = 1e-10
LAYERS = (2, 8, 8, 1)
ACTS = ("relu", "relu", "tanh")
LIMITS = [[-2.0, 2.0], [-1.5, 1.5]]


def jax_minibatches(key, steps, batch_size, limits):
    """The minibatches JAX's ``_policy_ascent`` draws from ``key``
    (``safe_learning_tpu/rl.py:95-99``)."""
    limits = np.asarray(limits, dtype=np.float64)
    k, draws = key, []
    for _ in range(steps):
        k, k_batch = jax.random.split(k)
        draws.append(np.asarray(jax.random.uniform(
            k_batch, (batch_size, len(limits)), jnp.float64, limits[:, 0],
            limits[:, 1])))
    return draws


def feed(rl, draws):
    """Make the port's ``optimize_policy`` take ``draws`` in turn."""
    it = iter(draws)
    rl._draw_minibatch = lambda generator, batch_size, lo, hi: \
        torch.as_tensor(np.array(next(it)), dtype=lo.dtype,
                        device=lo.device)


def port_network(jnet):
    return convert.neural_network(
        jnet.layers, jnet.nonlinearities, jnet.output_scale,
        [np.asarray(w) for w in jnet.weights],
        [None if b is None else np.asarray(b) for b in jnet.biases])


def flat(tree):
    return np.concatenate([to_numpy(leaf).ravel()
                           for leaf in st.utils._tree_leaves(tree)])


# ---------------------------------------------------------------------------
# The exact value solve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tol", [None, 1e-4])
def test_pwl_fixed_point_matches_jax(tol):
    rng = np.random.default_rng(0)
    a = np.array([[0.9, 0.2], [-0.1, 0.85]])
    b = np.array([[0.1], [0.3]])
    k = np.array([[0.4, 0.6]])
    gamma = 0.95
    init = rng.normal(size=(63, 1))
    with working_dtype("float64"):
        grids = sl.GridWorld(LIMITS, [9, 7]), st.GridWorld(LIMITS, [9, 7])
        states = grids[0].all_points
        actions = -states @ k.T
        nxt = states @ a.T + actions @ b.T
        rewards = -(states ** 2).sum(1, keepdims=True) - actions ** 2
        jtri = sl.Triangulation(grids[0], init, project=True)
        tri = st.Triangulation(grids[1], init, project=True)
        jv, jw = jtri.interpolation_weights(nxt)
        v, w = tri.interpolation_weights(torch.as_tensor(nxt))
        assert_array_equal(to_numpy(v), np.asarray(jv))
        tol_ = 1e-9 if tol is None else tol
        want = jax_fixed_point(jv, jw, jnp.asarray(rewards), gamma,
                               jnp.asarray(init), tol_, 20000)
        got = _pwl_fixed_point(v, w, torch.as_tensor(rewards), gamma,
                               torch.as_tensor(init), tol_, 20000)
    assert int(got[2]) == int(want[2])
    # The solve stopped inside a block: the iterates after it were frozen.
    assert 0 < int(got[2]) < 20000 and int(got[2]) % 64
    assert_allclose(to_numpy(got[0]), np.asarray(want[0]), rtol=1e-12,
                    atol=1e-12 * np.abs(np.asarray(want[0])).max())
    assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    assert float(got[1]) <= tol_


def test_optimize_value_function_divergence_raises():
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1]], 5)
        rl = st.PolicyIteration(
            st.LambdaFunction(lambda x: 0.0 * x),
            st.LinearSystem([np.array([[1.0]]), np.array([[0.0]])]),
            st.LambdaFunction(lambda xu: torch.ones_like(xu[:, :1])),
            st.Triangulation(grid, np.zeros(grid.nindex), project=True),
            gamma=1.0)
        with pytest.raises(st.OptimizationError):
            rl.optimize_value_function(max_iter=50)
    assert rl._last_solve[0] == 50


def test_value_iteration_converges_to_dare():
    """The DARE case of ``tests/test_rl.py:26``, in both packages."""
    a, b = np.array([[1.2]]), np.array([[1.0]])
    q = r = np.array([[1.0]])
    k, _ = st.utils.dlqr(a, b, q, r)
    gamma = 0.98
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1]], 41)
        rl = st.PolicyIteration(
            st.LinearSystem(-k), st.LinearSystem([a, b]),
            st.LambdaFunction(lambda xu: -(xu[:, :1] ** 2 + xu[:, 1:] ** 2)),
            st.Triangulation(grid, np.zeros(grid.nindex), project=True),
            gamma=gamma)
        rl.optimize_value_function()
        jgrid = sl.GridWorld([[-1, 1]], 41)
        jrl = sl.PolicyIteration(
            sl.LinearSystem(-k), sl.LinearSystem([a, b]),
            sl.LambdaFunction(lambda xu: -(xu[:, :1] ** 2
                                           + xu[:, 1:] ** 2)),
            sl.Triangulation(jgrid, np.zeros(jgrid.nindex), project=True),
            gamma=gamma)
        jrl.optimize_value_function()
    acl = float((a - b @ k).item())
    c = float((q + k.T @ r @ k).item()) / (1 - gamma * acl ** 2)
    got = to_numpy(rl.value_function.parameters)[:, 0]
    assert_allclose(got, -c * grid.all_points[:, 0] ** 2, atol=0.1)
    assert_allclose(got, np.asarray(jrl.value_function.parameters)[:, 0],
                    rtol=1e-12, atol=1e-12)
    assert rl._last_solve[0] > 0


# ---------------------------------------------------------------------------
# Future values, Bellman error and the ascent on the flagship's pieces
# ---------------------------------------------------------------------------
def flagship_rl(penalty):
    """The flagship's pieces at a small size in both packages: the stacked
    composite-kernel GP (capacity 8, 5 points), a ``[2, 8, 8, 1]`` MLP,
    a 9x9 ``Triangulation`` value function and the Lyapunov candidate
    ``-v`` with ``L_v = GradientNorm(v)``. Returns ``(port, jax)``, each
    ``(PolicyIteration, Lyapunov or None)``."""
    rng = np.random.default_rng(4)
    variances = np.array([[0.02, 0.01, 0.05], [0.03, 0.04, 0.02]])
    kernels = [sl.LinearKernel(variances=variances[d], input_dim=3)
               + sl.ActiveDims(sl.Matern32(lengthscales=1.0, input_dim=1),
                               dims=[0])
               * sl.ActiveDims(sl.LinearKernel(variances=variances[d, 1],
                                               input_dim=1), dims=[0])
               for d in range(2)]
    a = np.array([[1.0, 0.0125], [0.2, 0.99]])
    b = np.array([[0.0], [0.05]])
    xu = rng.uniform(-0.8, 0.8, (5, 3))
    y = xu[:, :2] @ a.T + xu[:, 2:] @ b.T + 0.01 * np.sin(3 * xu[:, :2])
    jgp = sl.StackedGaussianProcess(
        kernels, xu, y, noise_variances=1e-6, betas=2.0,
        mean_functions=[sl.LinearSystem([a[[d]], b[[d]]]) for d in range(2)],
        capacity=8)
    jnet = sl.NeuralNetwork(LAYERS, ACTS, key=jax.random.PRNGKey(1))
    values = (-rng.uniform(0.0, 1.0, 81)
              - (sl.GridWorld(LIMITS, [9, 9]).all_points ** 2).sum(1))
    reward = np.diag([-1.0, -2.0, -1.2])
    out = []
    for pkg, gp, net in ((st, port_stacked_gp(jgp), port_network(jnet)),
                         (sl, jgp, jnet)):
        vf = pkg.Triangulation(pkg.GridWorld(LIMITS, [9, 9]), values,
                               project=True)
        rl = pkg.PolicyIteration(net, gp, pkg.QuadraticFunction(reward),
                                 vf, gamma=0.98)
        lyap = None
        if penalty:
            lyap = pkg.Lyapunov(pkg.GridWorld(LIMITS, [21, 17]), -vf, gp,
                                1.7, pkg.GradientNorm(vf, ord=np.inf), 0.05,
                                net)
        out.append((rl, lyap))
    return out


@pytest.mark.parametrize("penalty", [False, True])
def test_future_values_and_bellmann_error_match_jax(penalty):
    x = np.random.default_rng(5).uniform(-1.8, 1.8, (40, 2))
    with working_dtype("float64"):
        (rl, lyap), (jrl, jlyap) = flagship_rl(penalty)
        got = rl.future_values(x, lyapunov=lyap, lagrange_multiplier=0.7)
        want = jrl.future_values(x, lyapunov=jlyap, lagrange_multiplier=0.7)
        assert_allclose(to_numpy(got), np.asarray(want), rtol=RTOL,
                        atol=1e-12)
        acts = np.random.default_rng(6).uniform(-1, 1, (40, 1))
        assert_allclose(to_numpy(rl.future_values(x, actions=acts,
                                                  lyapunov=lyap)),
                        np.asarray(jrl.future_values(x, actions=acts,
                                                     lyapunov=jlyap)),
                        rtol=RTOL, atol=1e-12)
        assert_allclose(float(rl.bellmann_error(x)),
                        float(jrl.bellmann_error(x)), rtol=RTOL)


@pytest.mark.parametrize("penalty", [False, True])
def test_ascent_gradient_matches_jax_grad(penalty):
    from safe_learning_tpu.rl import _future_values_core as jcore
    from safe_learning_tpu.rl import _future_values_lyapunov as jlyapunov
    from safe_learning_tpu_torch.rl import (_future_values_core,
                                            _future_values_lyapunov)

    x = np.random.default_rng(7).uniform(-2.0, 2.0, (64, 2))
    with working_dtype("float64"):
        (rl, lyap), (jrl, jlyap) = flagship_rl(penalty)

        def pieces(pkg_rl, ly):
            extra = () if ly is None else (
                ly.lyapunov_function, ly._lipschitz_lyapunov,
                ly._lipschitz_dynamics, ly.tau, 0.5)
            return (pkg_rl.dynamics, pkg_rl.reward_function,
                    pkg_rl.value_function, pkg_rl.gamma), extra

        def jloss(pp):
            args, extra = pieces(jrl, jlyap)
            pol = jrl.policy.with_parameters(pp)
            fv = (jlyapunov(pol, *args, jnp.asarray(x), None, *extra)
                  if penalty else jcore(pol, *args, jnp.asarray(x), None))
            return -jnp.mean(fv)

        jgrads = jax.grad(jloss)(jrl.policy.parameters_dict)
        leaves = st.utils._tree_map(
            lambda w: w.detach().requires_grad_(True),
            rl.policy.parameters_dict)
        args, extra = pieces(rl, lyap)
        pol = rl.policy.with_parameters(leaves)
        states = torch.as_tensor(x)
        fv = (_future_values_lyapunov(pol, *args, states, None, *extra)
              if penalty else _future_values_core(pol, *args, states, None))
        flat_leaves = st.utils._tree_leaves(leaves)
        grads = torch.autograd.grad(-fv.mean(), flat_leaves)
    jflat = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    assert len(grads) == len(jflat) == 5
    for got, want in zip(grads, jflat):
        assert np.abs(want).max() > 0
        assert_allclose(to_numpy(got), want, rtol=1e-8,
                        atol=1e-8 * np.abs(want).max())


def test_ascent_steps_on_jax_minibatches_match_jax():
    key = jax.random.PRNGKey(11)
    with working_dtype("float64"):
        (rl, lyap), (jrl, jlyap) = flagship_rl(True)
        space = lyap.discretization
        feed(rl, jax_minibatches(key, 5, 50, space.limits))
        losses = rl.optimize_policy(steps=5, learning_rate=0.05,
                                    batch_size=50, lyapunov=lyap,
                                    lagrange_multiplier=1.0,
                                    sample_space=space)
        jlosses = jrl.optimize_policy(steps=5, learning_rate=0.05,
                                      batch_size=50, key=key,
                                      lyapunov=jlyap,
                                      lagrange_multiplier=1.0,
                                      sample_space=jlyap.discretization)
    assert losses.shape == (5,)
    assert_allclose(losses, np.asarray(jlosses), rtol=1e-9)
    want = np.concatenate([np.asarray(w).ravel() for w in
                           jax.tree_util.tree_leaves(
                               jrl.policy.parameters_dict)])
    assert_allclose(flat(rl.policy.parameters_dict), want, rtol=1e-9,
                    atol=1e-9 * np.abs(want).max())
    for leaf in st.utils._tree_leaves(rl.policy.parameters_dict):
        assert not leaf.requires_grad and leaf.grad_fn is None


def test_ascent_keeps_saturation_bounds_and_rejects_parameterless():
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1]], 21)
        rl = st.PolicyIteration(
            st.Saturation(st.LinearSystem([[-2.0]]), -0.1, 0.1),
            st.LinearSystem([np.array([[1.2]]), np.array([[1.0]])]),
            st.LambdaFunction(lambda xu: -(xu[:, :1] ** 2
                                           + xu[:, 1:] ** 2)),
            st.Triangulation(grid, -np.abs(grid.all_points[:, 0]),
                             project=True), gamma=0.98)
        losses = rl.optimize_policy(steps=50, learning_rate=0.1,
                                    batch_size=64)
        assert losses.shape == (50,) and np.isfinite(losses).all()
        assert rl.policy.lower == -0.1 and rl.policy.upper == 0.1
        assert not np.allclose(to_numpy(rl.policy.fun.matrix), -2.0)
        assert not rl.policy.fun.matrix.requires_grad
        # Repeated calls draw fresh minibatches from the carried generator.
        again = rl.optimize_policy(steps=5, learning_rate=0.0,
                                   batch_size=64)
        assert not np.allclose(again, losses[-1])
        rl.policy = st.LambdaFunction(lambda x: -0.5 * x)
        with pytest.raises(ValueError, match="trainable"):
            rl.optimize_policy(steps=5)
        with pytest.raises(ValueError, match="trainable"):
            rl.policy_iteration(outer_iters=1)


# ---------------------------------------------------------------------------
# Policy iteration and discrete policy optimization
# ---------------------------------------------------------------------------
def mountain_car(pkg, n=9):
    """The mountain car of ``examples/basic_dynamic_programming.py`` in one
    package."""
    grid = pkg.GridWorld([[-1.2, 0.7], [-0.07, 0.07]], [n, n])
    value_function = pkg.Triangulation(grid, np.zeros(grid.nindex),
                                       project=True)
    policy = pkg.Saturation(
        pkg.Triangulation(grid, np.zeros(grid.nindex), project=True),
        -1.0, 1.0)
    if pkg is st:
        def dynamics_fn(xu):
            return torch.stack((xu[:, 0] + xu[:, 1],
                                xu[:, 1] + 0.001 * xu[:, 2]
                                - 0.0025 * torch.cos(3 * xu[:, 0])), dim=1)

        def reward_fn(xu):
            return (xu[:, :1] > 0.6).to(xu.dtype) * 0.01
    else:
        def dynamics_fn(xu):
            return jnp.stack((xu[:, 0] + xu[:, 1],
                              xu[:, 1] + 0.001 * xu[:, 2]
                              - 0.0025 * jnp.cos(3 * xu[:, 0])), axis=1)

        def reward_fn(xu):
            return jnp.where(xu[:, :1] > 0.6, 0.01, 0.0)
    return pkg.PolicyIteration(
        policy, pkg.LambdaFunction(dynamics_fn, input_dim=3, output_dim=2),
        pkg.LambdaFunction(reward_fn, input_dim=3, output_dim=1),
        value_function, gamma=0.99)


@pytest.mark.parametrize("outer,tol", [(4, 0.0), (50, 0.1)])
def test_policy_iteration_matches_jax(outer, tol):
    with working_dtype("float64"):
        rl, jrl = mountain_car(st), mountain_car(sl)
        info = rl.policy_iteration(outer_iters=outer, ascent_steps=20,
                                   learning_rate=1.0, convergence_tol=tol)
        jinfo = jrl.policy_iteration(outer_iters=outer, ascent_steps=20,
                                     learning_rate=1.0,
                                     convergence_tol=tol)
    assert info["iterations"] == jinfo["iterations"]
    assert info["converged"] == jinfo["converged"]
    if tol:
        assert info["converged"] and info["iterations"] < outer
    assert_allclose(info["value_change"], jinfo["value_change"], rtol=1e-9,
                    atol=1e-12)
    assert_allclose(to_numpy(rl.value_function.parameters),
                    np.asarray(jrl.value_function.parameters), rtol=1e-9,
                    atol=1e-12)
    assert_allclose(to_numpy(rl.policy.fun.parameters),
                    np.asarray(jrl.policy.fun.parameters), rtol=1e-9,
                    atol=1e-12)
    assert not rl.policy.fun.parameters.requires_grad


@pytest.mark.parametrize("constrained", [False, True])
def test_discrete_policy_optimization_matches_jax(constrained):
    """``tests/test_rl.py:136-170`` in both packages."""
    results = []
    for pkg in (st, sl):
        with working_dtype("float64"):
            grid = pkg.GridWorld([[-1, 1]], 11)
            rl = pkg.PolicyIteration(
                pkg.Triangulation(grid, np.zeros(grid.nindex),
                                  project=True),
                pkg.LinearSystem([np.array([[1.0]]), np.array([[1.0]])]),
                pkg.LambdaFunction(lambda xu: -(xu[:, :1] + xu[:, 1:]) ** 2),
                pkg.Triangulation(grid, -grid.all_points[:, 0] ** 2,
                                  project=True), gamma=0.9)
            space = np.linspace(-1, 1, 21)[:, None]
            constraint = (lambda u: u[:, 0] + 0.25) if constrained else None
            best = rl.discrete_policy_optimization(space, constraint)
            results.append((to_numpy(best), to_numpy(rl.policy.parameters)))
    (best, params), (jbest, jparams) = results
    assert_array_equal(best, jbest)
    assert_array_equal(params, jparams)
    states = np.linspace(-1, 1, 11)
    if constrained:
        assert (best >= -0.25).all()
        assert_allclose(best[:, 0], np.maximum(-states, -0.2), atol=0.11)
    else:
        assert_allclose(best[:, 0], -states, atol=0.11)


def test_value_iteration_step():
    with working_dtype("float64"):
        grid = st.GridWorld([[-1, 1]], 5)
        rl = st.PolicyIteration(
            st.LambdaFunction(lambda x: 0.0 * x),
            st.LinearSystem([np.array([[0.5]]), np.array([[0.0]])]),
            st.LambdaFunction(lambda xu: torch.ones_like(xu[:, :1])),
            st.Triangulation(grid, np.zeros(grid.nindex), project=True),
            gamma=0.5)
        rl.value_iteration()
        assert_allclose(to_numpy(rl.value_function.parameters), 1.0)
        rl.value_iteration()
        assert_allclose(to_numpy(rl.value_function.parameters), 1.5)
