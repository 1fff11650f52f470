"""Approximate policy iteration on the swing-limited inverted pendulum.

Counterpart of ``examples/reinforcement_learning_pendulum.py:26-156``: a
neural-network policy (no biases, tanh-saturated) and value function
trained by actor-critic, after a temporal-difference evaluation of the
LQR policy's value; the regions of attraction of the LQR and the learned
closed loops on a grid, and the learned closed loop from ``(0.15, 0)``.
``--full`` runs the reference's sizes: 500 evaluation steps, 400 joint
iterations of 100 value and 10 policy steps (44,500 SGD steps), a 101^2
grid and 600-step rollouts; the quick mode 300 evaluation steps, 150
joint iterations of 50 and 10, a 51^2 grid and 400-step rollouts with a
looser endpoint tolerance. The training runs eager on the device, one
minibatch of 100 uniform states a step from a ``torch.Generator``.

Run:

    python -m safe_learning_tpu_torch.examples.reinforcement_learning_pendulum \
        [--full]

``--plot`` needs the unported ``plotting`` module (ROADMAP item 22).
"""

from __future__ import annotations

import types

import numpy as np
import torch
from scipy.linalg import block_diag

from .. import convert
from ..analysis import compute_roa, reward_rollout
from ..config import config
from ..dynamics import InvertedPendulum
from ..functions.base import Saturation
from ..functions.linear import LinearSystem, QuadraticFunction
from ..grids import GridWorld
from ..utils import compute_trajectory, dlqr
from ._common import (Timer, _sgd, _uniform_states, example_args,
                      make_actor_critic, no_plot)
from .reinforcement_learning_cartpole import xavier_weights

LAYERS = (2, 64, 64, 1)


def sizes(full):
    """``(num_states, eval_iters, joint_iters, value_iters, policy_iters,
    roa_horizon, roa_tol)`` of a run."""
    if full:
        return 101, 500, 400, 100, 10, 600, 0.01
    # Quick mode trains far less; a looser (but equal for both policies)
    # endpoint tolerance keeps the comparison meaningful.
    return 51, 300, 150, 50, 10, 400, 0.1


def pendulum():
    """The notebook's swing-limited pendulum, normalized to
    ``(180 deg, 360 deg/s)`` and ``u_max = g m l sin(60 deg)``."""
    dt, g = 0.01, 9.81
    m, length, friction = 0.15, 0.5, 0.1
    theta_max, omega_max = np.deg2rad(180), np.deg2rad(360)
    u_max = g * m * length * np.sin(np.deg2rad(60))
    norms = ((theta_max, omega_max), (u_max,))
    return InvertedPendulum(m, length, friction, dt, normalization=norms)


def networks(seed):
    """The policy (``[2, 64, 64, 1]``, relu, relu, tanh, no biases) and the
    value network (relu, relu, linear, zero hidden biases, no output bias)
    at Xavier-uniform weights from ``numpy.random.default_rng(seed)``, the
    policy's drawn first (the JAX package's ``PRNGKey`` draw cannot be
    reproduced)."""
    rng = np.random.default_rng(seed)
    policy = convert.neural_network(LAYERS, ("relu", "relu", "tanh"), 1.0,
                                    xavier_weights(rng, LAYERS),
                                    (None,) * 3, use_bias=False)
    biases = [np.zeros(n) for n in LAYERS[1:-1]] + [None]
    value_function = convert.neural_network(
        LAYERS, ("relu", "relu", None), 1.0, xavier_weights(rng, LAYERS),
        biases)
    return policy, value_function


def run(full=False, seed=0, joint_iters=None):
    """The example at the reference's sizes (``full``) or the quick ones;
    ``joint_iters`` overrides the joint actor-critic iterations.

    Checks the example's assertions (the learned ROA is above 0.5 % of the
    grid, the learned closed loop ends below a state norm of 0.1 from
    ``(0.15, 0)`` after 600 steps) and returns a namespace: both ROAs and
    their fractions, the TD value fit's error against the LQR rollout, the
    final state norm, the SGD steps, the wall times of the evaluation, the
    joint training and each ROA, and the milliseconds of an SGD step.
    """
    (num_states, eval_iters, joints, value_iters, policy_iters, horizon,
     tol) = sizes(full)
    joint_iters = joints if joint_iters is None else int(joint_iters)
    system = pendulum()
    a, b = system.linearize()
    q, r = 0.1 * np.eye(2), 0.1 * np.eye(1)
    # The JAX example's gamma (0.995; the notebook's 0.965 is a 0.2 s
    # horizon at dt = 0.01, for which letting go is optimal).
    gamma = 0.995
    reward_function = QuadraticFunction(block_diag(-q, -r))
    r_max = float((np.ones((1, 2)) @ q @ np.ones((2, 1))
                   + np.ones((1, 1)) @ r @ np.ones((1, 1))).item())
    k, _ = dlqr(a, b, q, r)
    policy_lqr = Saturation(LinearSystem(-k), -1.0, 1.0)
    policy, value_function = networks(seed)
    generator = torch.Generator(device=config.device).manual_seed(seed)

    # Stage 1: TD(0) evaluation of the LQR policy (notebook cells 16-20),
    # plain SGD at 0.005 without clipping.
    def eval_step(vf, states):
        with torch.no_grad():
            actions = policy_lqr(states)
            rewards = reward_function(states, actions)
            target = rewards + gamma * value_function.with_parameters(vf)(
                system(states, actions))

        def loss(p):
            v = value_function.with_parameters(p)
            return torch.mean(torch.abs(v(states) - target)) / r_max

        return _sgd(loss, vf, 0.005, clip=False)

    with Timer("policy evaluation (LQR policy)") as eval_timer:
        vf = value_function.parameters_dict
        for _ in range(eval_iters):
            vf = eval_step(vf, _uniform_states(generator, 100, 2))
        value_function = value_function.with_parameters(vf)

    grid = GridWorld([[-1.0, 1.0]] * 2, num_states)

    def closed_loop_lqr(x):
        return system(x, policy_lqr(x))

    with Timer("ROA + reward rollout (LQR policy)") as lqr_timer:
        roa = compute_roa(grid, closed_loop_lqr, horizon=horizon, tol=tol)
        true_values = reward_rollout(
            grid, closed_loop_lqr,
            lambda x: reward_function(x, policy_lqr(x)), gamma,
            horizon=horizon)
    print("LQR ROA fraction: {:.3f}".format(roa.mean()))
    with torch.no_grad():
        fitted = value_function(grid.all_points).reshape(-1)
    value_err = float(torch.mean(torch.abs(
        fitted - torch.as_tensor(true_values).reshape(-1).to(fitted))))
    value_err /= r_max
    print("TD value fit error vs rollout: {:.3f}".format(value_err))

    # Stage 2: joint actor-critic (notebook cells 48-52), the shared
    # harness.
    train = make_actor_critic(
        policy, value_function, system, reward_function, gamma, r_max,
        state_dim=2, value_iters=value_iters, policy_iters=policy_iters,
        joint_iters=joint_iters)
    with Timer("joint actor-critic ({} iterations)".format(
            joint_iters)) as train_timer:
        pol_params, vf_params = train(policy.parameters_dict,
                                      value_function.parameters_dict,
                                      generator)
    policy = policy.with_parameters(pol_params)
    value_function = value_function.with_parameters(vf_params)
    steps = eval_iters + joint_iters * (value_iters + policy_iters)

    def closed_loop_new(x):
        return system(x, policy(x))

    with Timer("ROA (learned policy)") as new_timer:
        new_roa = compute_roa(grid, closed_loop_new, horizon=horizon,
                              tol=tol)
    fractions = {"learned": float(new_roa.mean()), "lqr": float(roa.mean())}
    print("learned-policy ROA fraction: {:.3f} (LQR: {:.3f})".format(
        fractions["learned"], fractions["lqr"]))
    assert fractions["learned"] > 0.005, \
        "learned policy should have a non-trivial region of attraction"

    states_new, _ = compute_trajectory(system, policy,
                                       np.array([[0.15, 0.0]]), 600)
    final_norm = float(torch.linalg.norm(states_new[-1]))
    print("final state norm (learned policy): {:.4f}".format(final_norm))
    assert final_norm < 0.1
    sgd_s = eval_timer.seconds + train_timer.seconds
    return types.SimpleNamespace(
        roa={"learned": new_roa, "lqr": roa}, fractions=fractions,
        value_err=value_err, final_norm=final_norm, steps=steps,
        joint_iters=joint_iters, eval_s=eval_timer.seconds,
        train_s=train_timer.seconds,
        roa_s={"lqr": lqr_timer.seconds, "learned": new_timer.seconds},
        step_ms=sgd_s / max(steps, 1) * 1e3)


def main(argv=None):
    args = example_args(__doc__, argv=argv)
    if args.plot:
        no_plot("reinforcement_learning_pendulum")
    return run(full=args.full, seed=args.seed)


if __name__ == "__main__":
    main()
