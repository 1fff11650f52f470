"""The safe-learning slice against the JAX package, and the base-function
pieces it rests on.

The slice is ``chip_smoke.build_safe_learning_instance`` shrunk to a
101x76 safety grid, an 11x11 policy grid and a ``[2, 8, 8, 1]`` network
(the inverted pendulum, the stacked GP at capacity 64 with no data, the
negated ``Triangulation`` value function with its ``GradientNorm`` as the
local ``L_v``). The JAX package's twin takes the port's numbers (weights,
vertex values, linearizations, initial set). Both run, in float64:
certify, three rounds of ``get_safe_sample`` / measurement /
``add_data_point``, re-certify. Safe sets must be equal, ``c_max`` and the
bounds equal to 1e-10 relative, the chosen pairs and measurements to
1e-12 (the networks' last bits differ). The pieces: ``GradientNorm`` for
every ``ord`` on the triangulation, the quadratic and a network; the
autodiff ``gradient``; ``parameters_dict``, ``with_parameters`` and
``copy_parameters``; ``compute_trajectory`` and ``batchify``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import convert

from _torch_parity import to_numpy, working_dtype

RTOL = 1e-10
POINTS, POLICY_POINTS, LAYERS = (101, 76), (11, 11), (2, 8, 8, 1)
ROUNDS = 3


def jax_twin(inst):
    """The JAX package's instance on the port's numbers
    (``examples/inverted_pendulum.py:77-148``)."""
    a, b, variances = inst["a"], inst["b"], inst["variances"]
    kernels = [sl.LinearKernel(variances=variances[d], input_dim=3)
               + sl.ActiveDims(sl.Matern32(lengthscales=1.0, input_dim=1),
                               dims=[0])
               * sl.ActiveDims(sl.LinearKernel(variances=variances[d, 1],
                                               input_dim=1), dims=[0])
               for d in range(2)]
    dynamics = sl.StackedGaussianProcess(
        kernels, np.empty((0, 3)), np.empty((0, 2)),
        noise_variances=inst["noise"], betas=2.0,
        mean_functions=[sl.LinearSystem([a[[d]], b[[d]]]) for d in range(2)],
        capacity=64)
    policy = sl.NeuralNetwork(LAYERS, inst["nonlinearities"]) \
        .with_parameters({
            "weights": tuple(jnp.asarray(w) for w in inst["weights"]),
            "biases": tuple(None if v is None else jnp.asarray(v)
                            for v in inst["biases"])})
    limits = inst["state_limits"]
    value_function = sl.Triangulation(sl.GridWorld(limits, POLICY_POINTS),
                                      inst["vertex_values"], project=True)
    lyap = sl.Lyapunov(sl.GridWorld(limits, POINTS), -value_function,
                       dynamics, inst["lf"],
                       sl.GradientNorm(value_function, ord=np.inf),
                       inst["tau"], policy)
    lyap.initial_safe_set = inst["initial"]
    lyap.safe_set |= lyap.initial_safe_set
    x_max = np.deg2rad(30)
    norms = ((x_max, np.sqrt(9.81 / 0.5)),
             (9.81 * 0.15 * 0.5 * np.sin(x_max),))
    true = sl.InvertedPendulum(0.15, 0.5, 0.1, 1 / 80, normalization=norms)
    return lyap, true


@pytest.fixture(scope="module")
def loop():
    """Both packages through certify, three rounds and re-certify."""
    from chip_smoke import (ACTION_VARIATION, EXPLORATION_SAMPLES,
                            build_safe_learning_instance,
                            measure_and_append, safe_sample)

    out = {"port": [], "jax": []}
    with working_dtype("float64"):
        lyap, inst = build_safe_learning_instance(0, POINTS, POLICY_POINTS,
                                                  LAYERS)
        jlyap, jtrue = jax_twin(inst)
        assert_allclose(float(jlyap.policy.lipschitz()),
                        float(lyap.policy.lipschitz()), rtol=RTOL)
        for target in (lyap, jlyap):
            target.update_safe_set()
        out["certify"] = [(np.array(t.safe_set), t.c_max,
                           to_numpy(t.values)) for t in (lyap, jlyap)]
        rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(ROUNDS):
            xu, bound, fallback = safe_sample(lyap, inst, rng)
            y = measure_and_append(lyap, inst, xu)
            out["port"].append((xu, bound, fallback, y))
            jxu, jbound = sl.get_safe_sample(
                jlyap, ACTION_VARIATION, inst["action_limits"],
                num_samples=EXPLORATION_SAMPLES, rng=jrng)
            jy = np.asarray(jtrue(jnp.asarray(jxu[:, :2]),
                                  jnp.asarray(jxu[:, 2:])))
            jlyap.dynamics = jlyap.dynamics.add_data_point(jxu, jy)
            out["jax"].append((jxu, jbound, jy))
        for target in (lyap, jlyap):
            target.update_values()
            target.update_safe_set()
        out["recertify"] = [(np.array(t.safe_set), t.c_max,
                             to_numpy(t.values)) for t in (lyap, jlyap)]
    out["lyap"], out["jlyap"] = lyap, jlyap
    return out


@pytest.mark.parametrize("stage", ["certify", "recertify"])
def test_safe_sets_match_jax(loop, stage):
    (safe, c_max, values), (jsafe, jc_max, jvalues) = loop[stage]
    assert_array_equal(safe, jsafe)
    assert_allclose(c_max, jc_max, rtol=RTOL)
    assert_allclose(values, jvalues, rtol=RTOL, atol=1e-12)
    assert safe[loop["lyap"].initial_safe_set].all()


def test_chosen_pairs_match_jax(loop):
    for (xu, bound, fallback, y), (jxu, jbound, jy) in zip(loop["port"],
                                                           loop["jax"]):
        assert not fallback
        assert_allclose(xu, jxu, rtol=1e-12, atol=1e-14)
        assert_allclose(bound, jbound, rtol=RTOL)
        assert_allclose(y, jy, rtol=1e-12, atol=1e-14)
    pairs = np.vstack([p[0] for p in loop["port"]])
    assert len(np.unique(pairs, axis=0)) == ROUNDS


def test_gp_after_the_loop_matches_jax(loop):
    lyap, jlyap = loop["lyap"], loop["jlyap"]
    assert lyap.dynamics.count == int(jlyap.dynamics.count) == ROUNDS
    q = np.random.default_rng(0).uniform(-1, 1, (50, 3))
    with working_dtype("float64"):
        for got, want in zip(lyap.dynamics(q), jlyap.dynamics(q)):
            assert_allclose(to_numpy(got), np.asarray(want), rtol=RTOL,
                            atol=1e-13)


def gradient_functions():
    """A triangulation, a quadratic and a scalar network in both
    packages, on the same numbers."""
    rng = np.random.default_rng(1)
    limits = [[-1.0, 1.0], [-0.5, 1.5]]
    values = rng.normal(size=(7 * 5, 1))
    p = np.array([[2.0, 0.5], [0.5, 1.0]])
    jnet = sl.NeuralNetwork([2, 8, 1], ["tanh", "softplus"],
                            key=jax.random.PRNGKey(3))
    net = convert.neural_network(
        [2, 8, 1], ["tanh", "softplus"], 1.0,
        [np.asarray(w) for w in jnet.weights],
        [None if b is None else np.asarray(b) for b in jnet.biases])
    return {
        "triangulation": (st.Triangulation(st.GridWorld(limits, [7, 5]),
                                           values),
                          sl.Triangulation(sl.GridWorld(limits, [7, 5]),
                                           values)),
        "quadratic": (st.QuadraticFunction(p), sl.QuadraticFunction(p)),
        "network": (net, jnet),
    }


@pytest.mark.parametrize("ord_", [None, 1, np.inf])
@pytest.mark.parametrize("name", ["triangulation", "quadratic", "network"])
def test_gradient_norm_matches_jax(name, ord_):
    x = np.random.default_rng(2).uniform(-1.2, 1.2, (40, 2))
    with working_dtype("float64"):
        fun, jfun = gradient_functions()[name]
        got = st.GradientNorm(fun, ord=ord_)
        want = sl.GradientNorm(jfun, ord=ord_)
        assert got.output_dim == want.output_dim
        assert_allclose(to_numpy(got(x)), np.asarray(want(x)), rtol=RTOL,
                        atol=1e-13)
        assert_allclose(to_numpy(fun.gradient(x)),
                        np.asarray(jfun.gradient(x)), rtol=RTOL, atol=1e-13)
    with pytest.raises(ValueError, match="unsupported ord"):
        st.GradientNorm(fun, ord=2)


def test_autodiff_gradient_of_a_composite():
    """``DeterministicFunction.gradient`` by ``torch.func`` on a sum of a
    network and a linear map, against ``jax.vmap(jax.grad)``."""
    x = np.random.default_rng(3).normal(size=(25, 2))
    with working_dtype("float64"):
        fns = gradient_functions()
        net, jnet = fns["network"]
        fun = net + st.LinearSystem([[0.3, -0.7]])
        jfun = jnet + sl.LinearSystem([[0.3, -0.7]])
        lifted = st.oracle.lift64(st.GradientNorm(fns["triangulation"][0]))
        assert_allclose(to_numpy(st.DeterministicFunction.gradient(fun, x)),
                        np.asarray(sl.DeterministicFunction.gradient(jfun,
                                                                     x)),
                        rtol=RTOL, atol=1e-13)
    tri = fns["triangulation"][0]
    assert lifted.fun.discretization is tri.discretization


def test_parameters_dict_and_with_parameters_match_jax():
    with working_dtype("float64"):
        fns = gradient_functions()
        tri, jtri = fns["triangulation"]
        assert set(tri.parameters_dict) == set(jtri.parameters_dict) == {
            "parameters"}
        doubled = tri.with_parameters({"parameters": 2 * tri.parameters})
        x = np.array([[0.1, 0.7], [-0.4, 0.0]])
        assert_allclose(to_numpy(doubled(x)), 2 * to_numpy(tri(x)))
        assert_allclose(to_numpy(doubled.copy_parameters(tri)(x)),
                        to_numpy(tri(x)))
        assert doubled.parameters is not tri.parameters

        lin = st.LinearSystem([[2.0]]) + st.LinearSystem([[3.0]])
        jlin = sl.LinearSystem([[2.0]]) + sl.LinearSystem([[3.0]])
        assert lin.parameters_dict.keys() == jlin.parameters_dict.keys()
        assert_allclose(to_numpy(lin.parameters_dict["fun2"]["matrix"]),
                        np.asarray(jlin.parameters_dict["fun2"]["matrix"]))
        new = lin.with_parameters({"fun2": {"matrix": torch.tensor(
            [[5.0]], dtype=torch.float64)}})
        assert_allclose(to_numpy(new(np.array([[1.0]]))), [[7.0]])
        assert_allclose(to_numpy(lin(np.array([[1.0]]))), [[5.0]])

        net, jnet = fns["network"]
        assert set(net.parameters_dict) == set(jnet.parameters_dict)
    with pytest.raises(ValueError, match="no parameter field"):
        st.LinearSystem([[1.0, 2.0]]).with_parameters({"wieghts": 0})


def test_compute_trajectory_and_batchify_match_jax():
    x_max = np.deg2rad(30)
    norms = ((x_max, np.sqrt(9.81 / 0.5)),
             (9.81 * 0.15 * 0.5 * np.sin(x_max),))
    k = np.array([[-2.5, -1.1]])
    with working_dtype("float64"):
        true = st.InvertedPendulum(0.15, 0.5, 0.1, 1 / 80,
                                   normalization=norms)
        jtrue = sl.InvertedPendulum(0.15, 0.5, 0.1, 1 / 80,
                                    normalization=norms)
        states, actions = st.utils.compute_trajectory(
            true, st.LinearSystem(k), np.array([[1.0, -0.5]]), 60)
        jstates, jactions = sl.utils.compute_trajectory(
            jtrue, sl.LinearSystem(k), np.array([[1.0, -0.5]]), 60)
        assert states.shape == (60, 2) and actions.shape == (59, 1)
        assert_allclose(to_numpy(states), np.asarray(jstates), rtol=RTOL,
                        atol=1e-13)
        assert_allclose(to_numpy(actions), np.asarray(jactions), rtol=RTOL,
                        atol=1e-13)
        one, none = st.utils.compute_trajectory(
            true, st.LinearSystem(k), np.array([[1.0, -0.5]]), 1)
        assert one.shape == (1, 2) and none.shape == (0, 1)
    arrays = (np.arange(10), np.arange(20).reshape(10, 2))
    got = list(st.utils.batchify(arrays, 4))
    want = list(sl.utils.batchify(arrays, 4))
    assert [i for i, _ in got] == [i for i, _ in want] == [0, 4, 8]
    for (_, g), (_, w) in zip(got, want):
        for a, b in zip(g, w):
            assert_array_equal(a, b)
