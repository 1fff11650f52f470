"""The training slice as a whole against the JAX package, in float64.

``chip_smoke.SafeTraining`` (``examples/inverted_pendulum.py:62-275`` in
the port) at a small size: a 41x31 safety grid, a 9x9 policy grid, a
``[2, 8, 8, 1]`` network, batches of 100, 10 pretraining steps, two
rounds of 5 penalised steps, then one outer iteration of 2 exploration
steps, 5 penalised steps and a certify. The JAX package runs the example's
own code on the port's numbers. The port is fed the JAX package's
minibatches (its key splits reproduced here) and both take the same
exploration ``rng``. After every certify: the safe sets are equal,
``c_max`` within 1e-9 relative, the policy weights within 1e-8 relative,
the value function within 1e-9 relative, and the GP data equal (the
actions, network outputs, to 1e-12).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st

from _torch_parity import to_numpy, working_dtype

POINTS, POLICY_POINTS, LAYERS = (41, 31), (9, 9), (2, 8, 8, 1)
PRETRAIN, POLICY_STEPS, DATA, BATCH, SEED = 10, 5, 2, 100, 0


def jax_example(inst, policy_points):
    """The JAX package's pieces of the example on the port's numbers
    (``examples/inverted_pendulum.py:77-133``)."""
    from scipy.linalg import block_diag

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
    value_function = sl.Triangulation(
        sl.GridWorld(inst["state_limits"], policy_points),
        inst["vertex_values"], project=True)
    reward = sl.QuadraticFunction(block_diag(-np.diag([1.0, 2.0]),
                                             -1.2 * np.ones((1, 1))))
    x_max = np.deg2rad(30)
    norms = ((x_max, np.sqrt(9.81 / 0.5)),
             (9.81 * 0.15 * 0.5 * np.sin(x_max),))
    true = sl.InvertedPendulum(0.15, 0.5, 0.1, 1 / 80, normalization=norms)
    return sl.PolicyIteration(policy, dynamics, reward, value_function,
                              gamma=0.98), true


def snapshot(lyap, rl):
    """What is compared after a certify."""
    weights = np.concatenate([
        to_numpy(w).ravel()
        for w in (st.utils._tree_leaves(rl.policy.parameters_dict)
                  if isinstance(rl, st.PolicyIteration)
                  else jax.tree_util.tree_leaves(rl.policy.parameters_dict))])
    return dict(safe=np.array(lyap.safe_set), c_max=float(lyap.c_max),
                weights=weights,
                values=to_numpy(rl.value_function.parameters).copy(),
                x=np.asarray(lyap.dynamics.X), y=np.asarray(lyap.dynamics.Y))


@pytest.fixture(scope="module")
def runs():
    from chip_smoke import (ACTION_VARIATION, EXPLORATION_SAMPLES,
                            SafeTraining)
    from test_torch_rl import jax_minibatches

    port, jax_side = [], []
    with working_dtype("float64"):
        trainer = SafeTraining(SEED, POINTS, POLICY_POINTS, LAYERS,
                               batch_size=BATCH)
        inst, lyap = trainer.inst, trainer.lyap
        rl, true = jax_example(inst, POLICY_POINTS)
        jlyap = None
        queue = collections.deque()
        trainer.rl._draw_minibatch = lambda generator, batch_size, lo, hi: \
            torch.as_tensor(np.array(queue.popleft()), dtype=lo.dtype)
        key = jax.random.PRNGKey(SEED)

        def jax_optimize(steps, **kwargs):
            """A JAX ascent with the example's key split, and its
            minibatches queued for the port."""
            nonlocal key
            key, sub = jax.random.split(key)
            space = kwargs["sample_space"]
            queue.extend(jax_minibatches(sub, steps, BATCH, space.limits))
            rl.optimize_policy(steps=steps, batch_size=BATCH, key=sub,
                               **kwargs)

        def jax_lipschitz():
            lip = float(np.asarray(rl.policy.lipschitz()))
            return float(np.max(np.abs(inst["a_true"]))
                         + np.max(np.abs(inst["b_true"])) * lip)

        # Pretrain, then the Lyapunov instance and the first certify.
        jax_optimize(PRETRAIN, learning_rate=0.1,
                     sample_space=rl.value_function.discretization)
        trainer.pretrain(PRETRAIN)
        safety = sl.GridWorld(inst["state_limits"], POINTS)
        jlyap = sl.Lyapunov(safety, -rl.value_function, rl.dynamics,
                            jax_lipschitz(),
                            sl.GradientNorm(rl.value_function, ord=np.inf),
                            inst["tau"], rl.policy)
        jlyap.initial_safe_set = inst["initial"]
        jlyap.safe_set |= jlyap.initial_safe_set
        jlyap.update_safe_set()
        trainer.certify()
        port.append(snapshot(lyap, trainer.rl))
        jax_side.append(snapshot(jlyap, rl))

        def jax_rl_optimize():
            rl.optimize_value_function()
            jlyap.lyapunov_function = -rl.value_function
            jlyap._lipschitz_lyapunov = sl.GradientNorm(rl.value_function,
                                                        ord=np.inf)
            jlyap._lipschitz_dynamics = jax_lipschitz()
            jax_optimize(POLICY_STEPS, learning_rate=0.01, lyapunov=jlyap,
                         lagrange_multiplier=1.0,
                         sample_space=jlyap.discretization)
            jlyap.policy = rl.policy

        def jax_certify():
            jlyap.update_values()
            jlyap.update_safe_set()

        for _ in range(2):
            jax_rl_optimize()
            trainer.optimize(POLICY_STEPS)
        jax_certify()
        trainer.certify()
        port.append(snapshot(lyap, trainer.rl))
        jax_side.append(snapshot(jlyap, rl))

        jrng = np.random.default_rng(SEED)
        for _ in range(DATA):
            xu, fallback = trainer.update_gp()
            jxu, _ = sl.get_safe_sample(
                jlyap, ACTION_VARIATION, inst["action_limits"],
                num_samples=EXPLORATION_SAMPLES, rng=jrng)
            measurement = np.asarray(true(jnp.asarray(jxu[:, :2]),
                                          jnp.asarray(jxu[:, 2:])))
            jlyap.dynamics = jlyap.dynamics.add_data_point(jxu, measurement)
            rl.dynamics = jlyap.dynamics
            assert not fallback
        jax_rl_optimize()
        trainer.optimize(POLICY_STEPS)
        jax_certify()
        trainer.certify()
        port.append(snapshot(lyap, trainer.rl))
        jax_side.append(snapshot(jlyap, rl))
    assert not queue
    return port, jax_side, trainer


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_certified_sets_match_jax(runs, stage):
    got, want = runs[0][stage], runs[1][stage]
    assert_array_equal(got["safe"], want["safe"])
    assert_allclose(got["c_max"], want["c_max"], rtol=1e-9)
    assert got["safe"][runs[2].inst["initial"]].all()


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_policy_and_value_function_match_jax(runs, stage):
    got, want = runs[0][stage], runs[1][stage]
    assert_allclose(got["weights"], want["weights"], rtol=1e-8,
                    atol=1e-8 * np.abs(want["weights"]).max())
    assert_allclose(got["values"], want["values"], rtol=1e-9,
                    atol=1e-9 * np.abs(want["values"]).max())


def test_gp_data_and_trained_policy(runs):
    port, jax_side, trainer = runs
    # The measured states are grid points, equal; the actions are the
    # networks' outputs plus a perturbation, equal to their last bits.
    assert_array_equal(port[-1]["x"][:, :2], jax_side[-1]["x"][:, :2])
    assert_allclose(port[-1]["x"], jax_side[-1]["x"], rtol=1e-12,
                    atol=1e-15)
    assert_allclose(port[-1]["y"], jax_side[-1]["y"], rtol=1e-12)
    assert trainer.lyap.dynamics.count == DATA
    assert trainer.rl.dynamics is trainer.lyap.dynamics
    assert trainer.lyap.policy is trainer.rl.policy
    # Training moved the weights, and left no autograd graph behind.
    # (biases first: the leaves' sorted-key order)
    start = np.concatenate(
        [np.ravel(b) for b in trainer.inst["biases"] if b is not None]
        + [np.ravel(w) for w in trainer.inst["weights"]])
    assert start.shape == port[0]["weights"].shape
    assert not np.allclose(port[0]["weights"], start)
    for leaf in st.utils._tree_leaves(trainer.rl.policy.parameters_dict):
        assert not leaf.requires_grad and leaf.grad_fn is None
    assert not trainer.rl.value_function.parameters.requires_grad
