"""The cart-pole slice against the JAX package.

- The 51^4 verification instance (``chip_smoke.build_cartpole_instance``,
  ``benchmarks/cartpole_51x4_sweep.py:14-38``) at 7^4 in both packages:
  the host factorization of the near-singular GP (variance 1e-10, noise
  1e-12) to 1e-9 relative, then in float64 the values to 1e-12, the safe
  set equal and ``c_max`` to 1e-12 relative; in float32 every decrease
  verdict equals the float64 oracle's outside the calibrated band.
- The actor-critic harness (``examples/_common.py:71-148``) at ``[4, 8,
  8, 1]`` for 3 joint iterations of 5 + 2 steps, fed the JAX package's
  minibatches: both networks' parameters to 1e-10 relative in float64.
- ``compute_roa`` of a policy trained by the JAX package's harness,
  carried across by ``convert``, at 7^4 with horizon 100: the same ROA.
"""

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal
from scipy.linalg import block_diag

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import convert
from safe_learning_tpu_torch.examples import _common
from safe_learning_tpu_torch.examples import \
    reinforcement_learning_cartpole as cartpole_example

from _torch_parity import to_numpy, working_dtype

POINTS = 7


def jax_instance(inst, num_points):
    """The JAX package's twin of the port's instance on the port's numbers
    (linearization, LQR solution, training data, initial set)."""
    m, cart_mass, length, friction = 0.175, 1.732, 0.28, 0.01
    x_max, theta_max = 0.5, np.deg2rad(30)
    u_max = (m + cart_mass) * 4.0 / x_max
    norms = ((x_max, theta_max, 2.0, np.deg2rad(30)), (u_max,))
    system = sl.CartPole(m, cart_mass, length, friction, 0.01,
                         normalization=norms)
    a, b = map(np.asarray, system.linearize())
    assert_allclose(inst["a"], a, rtol=1e-9, atol=1e-12)
    assert_allclose(inst["b"], b, rtol=1e-9, atol=1e-12)
    gp = sl.GaussianProcess(sl.RBF(1e-10, [0.4] * 5, input_dim=5),
                            inst["x_train"], inst["y_train"],
                            noise_variance=1e-12,
                            mean_function=sl.LinearSystem([inst["a"],
                                                           inst["b"]]))
    grid = sl.GridWorld([[-1.0, 1.0]] * 4, num_points)
    return sl.Lyapunov(grid, sl.QuadraticFunction(inst["p"]), gp, inst["lf"],
                       inst["lv"], inst["tau"],
                       sl.Saturation(sl.LinearSystem(-inst["k"]), -1.0, 1.0),
                       initial_set=inst["initial_set"])


def test_instance_matches_jax_in_float64():
    from chip_smoke import build_cartpole_instance
    from safe_learning_tpu_torch.lyapunov import _negative_batch

    with working_dtype("float64"):
        lyap, inst = build_cartpole_instance(POINTS)
        jlyap = jax_instance(inst, POINTS)
        # The training targets are the JAX cart-pole's next states.
        want_y = np.asarray(jlyap.dynamics.Y)
        jsys = sl.CartPole(0.175, 1.732, 0.28, 0.01, 0.01, normalization=(
            (0.5, np.deg2rad(30), 2.0, np.deg2rad(30)),
            ((0.175 + 1.732) * 4.0 / 0.5,)))
        assert_allclose(inst["y_train"],
                        np.asarray(jsys(inst["x_train"][:, :4],
                                        inst["x_train"][:, 4:])),
                        rtol=1e-12, atol=1e-12)
        assert_array_equal(inst["y_train"], want_y)
        # The near-singular host factorization, before any sweep.
        assert_allclose(to_numpy(lyap.dynamics.chol_inv),
                        np.asarray(jlyap.dynamics.chol_inv), rtol=1e-9,
                        atol=1e-9 * np.abs(np.asarray(
                            jlyap.dynamics.chol_inv)).max())
        assert_allclose(to_numpy(lyap.dynamics.alpha),
                        np.asarray(jlyap.dynamics.alpha), rtol=1e-8,
                        atol=1e-8 * np.abs(np.asarray(
                            jlyap.dynamics.alpha)).max())
        lyap.update_safe_set()
        jlyap.update_safe_set()
        negative = _negative_batch(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            lyap._device_points())[0].numpy()
    assert lyap.discretization.nindex == POINTS ** 4
    assert_allclose(to_numpy(lyap.values), np.asarray(jlyap.values),
                    rtol=1e-12, atol=1e-15)
    assert_array_equal(np.asarray(lyap.safe_set), np.asarray(jlyap.safe_set))
    assert_allclose(lyap.c_max, jlyap.c_max, rtol=1e-12)
    # As at 51^4, the certified level set is the exempt initial set (the
    # threshold -L_v (1 + L_f) tau exceeds the decrease near the origin),
    # while points beyond it pass the decrease check.
    negative[inst["initial_set"]] = False
    assert negative.any()


def test_instance_within_the_oracle_band_in_float32():
    """The float32 sweep's decrease verdicts against the float64 oracle:
    equal outside the calibrated band, and the margin-guarded set inside
    the oracle's."""
    from chip_smoke import build_cartpole_instance
    from safe_learning_tpu_torch.lyapunov import _negative_batch

    with working_dtype("float32"):
        lyap, inst = build_cartpole_instance(POINTS)
        lyap.update_safe_set()
        negative = _negative_batch(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            lyap._device_points())[0].numpy()
        margin = st.oracle.calibrate_certificate_margin(lyap,
                                                        num_samples=512)
        margins64 = st.oracle.oracle_margins(
            lyap, lyap.discretization.all_points)
        oracle_safe, _ = st.oracle.oracle_safe_set(lyap, margins=margins64)
        lyap.update_safe_set()
    differ = negative != (margins64 < 0)
    assert not (differ & (np.abs(margins64) > margin)).any()
    assert negative.any()
    safe = np.asarray(lyap.safe_set)
    assert safe[inst["initial_set"]].all()
    assert not (safe & ~oracle_safe).any()


LAYERS, JOINT, VALUE, POLICY, BATCH = (4, 8, 8, 1), 3, 5, 2, 100


def jax_minibatches(key, joint, value_iters, policy_iters, batch,
                    state_dim):
    """The harness's minibatches in its order: one key split a step, value
    steps before policy steps in every joint iteration."""
    out = []
    for _ in range(joint * (value_iters + policy_iters)):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(
            sub, (batch, state_dim), minval=-1.0, maxval=1.0)))
    return out


def _pieces(layers):
    """The JAX example's cart-pole, reward and networks, and the port's
    copies carried across by ``convert``."""
    from examples._common import make_actor_critic_scan

    jsys = sl.CartPole(0.175, 1.732, 0.28, 0.01, 0.01, normalization=(
        (0.5, np.deg2rad(30), 2.0, np.deg2rad(30)),
        ((0.175 + 1.732) * 2.0 ** 2 / 0.5,)))
    reward = block_diag(-0.1 * np.eye(4), -0.1 * np.eye(1))
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    jpol = sl.NeuralNetwork(layers, ["relu", "relu", "tanh"], use_bias=False,
                            key=k1)
    jvf = sl.NeuralNetwork(layers, ["relu", "relu", None], use_bias=False,
                           key=k2)
    port = [convert.neural_network(
        layers, net.nonlinearities, 1.0,
        [np.asarray(w) for w in net.weights], (None,) * 3, use_bias=False)
        for net in (jpol, jvf)]
    return (jsys, sl.QuadraticFunction(reward), jpol, jvf,
            cartpole_example.cartpole(), st.QuadraticFunction(reward),
            port[0], port[1], make_actor_critic_scan)


def _flat(params):
    return np.concatenate([to_numpy(w).ravel()
                           for w in params["weights"]])


@pytest.fixture(scope="module")
def trained():
    """Both harnesses from the same weights on the same minibatches."""
    with working_dtype("float64"):
        (jsys, jreward, jpol, jvf, sys_, reward, pol, vf,
         make_scan) = _pieces(LAYERS)
        key = jax.random.PRNGKey(11)
        scan = make_scan(jpol, jvf, jsys, jreward, 0.995, 0.5, state_dim=4,
                         value_iters=VALUE, policy_iters=POLICY,
                         joint_iters=JOINT, batch=BATCH)
        jpol_p, jvf_p = scan(jpol.parameters_dict, jvf.parameters_dict, key)
        queue = jax_minibatches(key, JOINT, VALUE, POLICY, BATCH, 4)
        saved = _common._uniform_states
        _common._uniform_states = lambda generator, batch, state_dim: \
            torch.as_tensor(np.array(queue.pop(0)), dtype=torch.float64)
        try:
            train = _common.make_actor_critic(
                pol, vf, sys_, reward, 0.995, 0.5, state_dim=4,
                value_iters=VALUE, policy_iters=POLICY, joint_iters=JOINT,
                batch=BATCH)
            pol_p, vf_p = train(pol.parameters_dict, vf.parameters_dict,
                                torch.Generator())
        finally:
            _common._uniform_states = saved
    assert not queue
    return (pol_p, vf_p, jpol_p, jvf_p,
            dict(pol=pol.parameters_dict, vf=vf.parameters_dict))


@pytest.mark.parametrize("net", ["policy", "value"])
def test_actor_critic_matches_jax(trained, net):
    pol_p, vf_p, jpol_p, jvf_p, start = trained
    got, want, init = ((pol_p, jpol_p, start["pol"]) if net == "policy"
                       else (vf_p, jvf_p, start["vf"]))
    got, want = _flat(got), _flat(want)
    assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    # The steps moved the weights, and left no autograd state.
    assert not np.allclose(got, _flat(init))
    for w in (pol_p if net == "policy" else vf_p)["weights"]:
        assert not w.requires_grad and w.grad_fn is None


def test_roa_of_a_jax_trained_policy_matches_jax():
    """A policy trained by the JAX package's harness (20 joint iterations
    of 50 + 10 steps), carried across by ``convert``: ``compute_roa`` of
    its closed loop and of the LQR loop at 7^4 over 100 steps, equal."""
    with working_dtype("float64"):
        (jsys, jreward, jpol, jvf, sys_, reward, _, _,
         make_scan) = _pieces(LAYERS)
        scan = make_scan(jpol, jvf, jsys, jreward, 0.995, 0.5, state_dim=4,
                         value_iters=50, policy_iters=10, joint_iters=20)
        jpol_p, _ = scan(jpol.parameters_dict, jvf.parameters_dict,
                         jax.random.PRNGKey(5))
        jpolicy = jpol.with_parameters(jpol_p)
        policy = convert.neural_network(
            LAYERS, jpolicy.nonlinearities, 1.0,
            [np.asarray(w) for w in jpolicy.weights], (None,) * 3,
            use_bias=False)
        a, b = sys_.linearize()
        k, _ = st.utils.dlqr(a, b, 0.1 * np.eye(4), 0.1 * np.eye(1))
        lqr = st.Saturation(st.LinearSystem(-k), -1.0, 1.0)
        jlqr = sl.Saturation(sl.LinearSystem(-k), -1.0, 1.0)
        grid = st.GridWorld([[-1.0, 1.0]] * 4, POINTS)
        jgrid = sl.GridWorld([[-1.0, 1.0]] * 4, POINTS)
        got, want = [], []
        for pol, jp in ((policy, jpolicy), (lqr, jlqr)):
            got.append(st.compute_roa(grid, lambda x: sys_(x, pol(x)),
                                      horizon=100, tol=0.1))
            want.append(np.asarray(sl.compute_roa(
                jgrid, jax.jit(lambda x: jsys(x, jp(x))), horizon=100,
                tol=0.1)))
    for g, w in zip(got, want):
        assert_array_equal(g, w)
    assert want[1].any()
