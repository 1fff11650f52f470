"""Approximate policy iteration on the 4-D cart-pole, on the card.

Counterpart of ``examples/reinforcement_learning_cartpole.py:29-114``: the
notebook's cart-pole, its LQR controller, a ``[4, 64, 64, 1]`` policy and
value network trained jointly by the actor-critic harness
(``_common.make_actor_critic``), the closed loops from ``(0.2, 0.2, 0,
0)``, and the region of attraction of both closed loops on a 4-D grid.
``--full`` runs the reference's sizes: 400 joint iterations of 50 value and
10 policy steps, and a 51^4 = 6,765,201-state grid rolled out over 2000
steps; the quick mode uses 300 iterations, a 13^4 grid and 400 steps.

Run:

    python -m safe_learning_tpu_torch.examples.reinforcement_learning_cartpole \
        [--full --plot]
"""

from __future__ import annotations

import types

import numpy as np
import torch
from scipy.linalg import block_diag

from .. import convert
from ..analysis import compute_roa
from ..config import config
from ..dynamics import CartPole
from ..functions.base import Saturation
from ..functions.linear import LinearSystem, QuadraticFunction
from ..grids import GridWorld
from ..utils import compute_trajectory, dlqr
from ._common import (Timer, example_args, make_actor_critic,
                      maybe_save_plot, pyplot)

#: ``[4, 64, 64, 1]`` networks without biases (notebook cells 9-10).
LAYERS = (4, 64, 64, 1)
POLICY_ACTIVATIONS = ("relu", "relu", "tanh")
VALUE_ACTIVATIONS = ("relu", "relu", None)


def sizes(full):
    """``(grid_points, joint_iters, value_iters, policy_iters,
    roa_horizon, roa_segment)`` of a run."""
    if full:
        return 51, 400, 50, 10, 2000, 500
    return 13, 300, 50, 10, 400, None


def cartpole():
    """The notebook's cart-pole (cell 7), normalized, with ``u_max =
    (m + M) x_dot_max^2 / x_max``."""
    m, cart_mass, length, rot_friction = 0.175, 1.732, 0.28, 0.01
    x_max, theta_max = 0.5, np.deg2rad(30)
    x_dot_max, theta_dot_max = 2.0, np.deg2rad(30)
    u_max = (m + cart_mass) * x_dot_max ** 2 / x_max
    norms = ((x_max, theta_max, x_dot_max, theta_dot_max), (u_max,))
    return CartPole(m, cart_mass, length, rot_friction, 0.01,
                    normalization=norms)


def xavier_weights(rng, layers):
    """Xavier-uniform ``(fan_in, fan_out)`` weights of a bias-free MLP from
    the numpy generator ``rng`` (the JAX package's initialisation from a
    ``PRNGKey`` cannot be reproduced)."""
    weights = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = np.sqrt(6.0 / (n_in + n_out))
        weights.append(rng.uniform(-bound, bound, (n_in, n_out)))
    return weights


def networks(seed):
    """The policy and the value network at their initialisation from
    ``numpy.random.default_rng(seed)``, the policy's weights drawn
    first."""
    rng = np.random.default_rng(seed)
    no_bias = (None,) * (len(LAYERS) - 1)
    policy = convert.neural_network(LAYERS, POLICY_ACTIVATIONS, 1.0,
                                    xavier_weights(rng, LAYERS), no_bias,
                                    use_bias=False)
    value_function = convert.neural_network(LAYERS, VALUE_ACTIVATIONS, 1.0,
                                            xavier_weights(rng, LAYERS),
                                            no_bias, use_bias=False)
    return policy, value_function


def _peak_bytes():
    if config.device.type == "cuda":
        return torch.cuda.max_memory_allocated(config.device)
    return None


def run(full=False, seed=0, joint_iters=None):
    """The example at the reference's sizes (``full``) or the quick ones;
    ``joint_iters`` overrides the joint actor-critic iterations.

    Checks the example's two assertions and returns a namespace: the
    system, the LQR and the trained policy, the value function, the grid,
    both ROAs and their fractions, the closed loops' final state norms,
    the wall times (``train_s``, ``roa_s`` of each policy), the
    milliseconds of an SGD step, each ROA's state-steps per second and the
    peak device memory.
    """
    (points, full_iters, value_iters, policy_iters, horizon,
     segment) = sizes(full)
    joint_iters = full_iters if joint_iters is None else int(joint_iters)

    system = cartpole()
    a, b = system.linearize()
    q, r = 0.1 * np.eye(4), 0.1 * np.eye(1)
    # The JAX example's gamma (longer horizon than the notebook's 0.965).
    gamma, r_max = 0.995, 0.5
    reward_function = QuadraticFunction(block_diag(-q, -r))
    k, _ = dlqr(a, b, q, r)
    policy_lqr = Saturation(LinearSystem(-k), -1.0, 1.0)
    policy, value_function = networks(seed)

    train = make_actor_critic(
        policy, value_function, system, reward_function, gamma, r_max,
        state_dim=4, value_iters=value_iters, policy_iters=policy_iters,
        joint_iters=joint_iters)
    generator = torch.Generator(device=config.device).manual_seed(seed)
    if config.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(config.device)
    with Timer("joint actor-critic ({} iterations)".format(
            joint_iters)) as train_timer:
        pol_params, vf_params = train(policy.parameters_dict,
                                      value_function.parameters_dict,
                                      generator)
    policy = policy.with_parameters(pol_params)
    value_function = value_function.with_parameters(vf_params)
    steps = joint_iters * (value_iters + policy_iters)

    x0 = np.array([[0.2, 0.2, 0.0, 0.0]])
    states_new, _ = compute_trajectory(system, policy, x0, 800)
    states_lqr, _ = compute_trajectory(system, policy_lqr, x0, 800)
    final_new = float(torch.linalg.norm(states_new[-1]))
    final_lqr = float(torch.linalg.norm(states_lqr[-1]))
    print("final state norm from (0.2, 0.2, 0, 0): learned {:.4f}  "
          "LQR {:.4f}".format(final_new, final_lqr))
    assert final_new < 0.1, "learned policy should balance the cart-pole"

    grid = GridWorld([[-1.0, 1.0]] * 4, points)
    print("ROA grid size: {}".format(grid.nindex))

    def closed_loop_new(x):
        return system(x, policy(x))

    def closed_loop_lqr(x):
        return system(x, policy_lqr(x))

    roa, roa_s = {}, {}
    for name, loop in (("learned", closed_loop_new), ("lqr", closed_loop_lqr)):
        with Timer("4-D ROA sweep, {} policy".format(name)) as timer:
            roa[name] = compute_roa(grid, loop, horizon=horizon, tol=0.1,
                                    segment_steps=segment)
        roa_s[name] = timer.seconds
    fractions = {name: float(mask.mean()) for name, mask in roa.items()}
    print("learned-policy ROA fraction: {:.3f} (LQR: {:.3f})".format(
        fractions["learned"], fractions["lqr"]))
    assert fractions["learned"] > 0.005

    state_steps = grid.nindex * (horizon - 1)
    return types.SimpleNamespace(
        system=system, policy=policy, value_function=value_function,
        policy_lqr=policy_lqr, grid=grid, roa=roa, fractions=fractions,
        final_new=final_new, final_lqr=final_lqr, horizon=horizon, tol=0.1,
        states_new=states_new.cpu().numpy(),
        states_lqr=states_lqr.cpu().numpy(), train_s=train_timer.seconds,
        step_ms=train_timer.seconds / max(steps, 1) * 1e3, steps=steps,
        roa_s=roa_s,
        state_steps_per_s={name: state_steps / s
                           for name, s in roa_s.items()},
        peak_bytes=_peak_bytes())


def plot(result):
    """The closed loops' cart positions and pole angles, and the learned
    ROA's (theta, omega) slice at ``x = x_dot = 0``."""
    plt = pyplot()
    t = np.arange(len(result.states_new)) * result.system.dt
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for dim, label in [(0, "cart position"), (1, "pole angle")]:
        axes[0].plot(t, result.states_new[:, dim], label="new " + label)
        axes[0].plot(t, result.states_lqr[:, dim], "--",
                     label="LQR " + label)
    axes[0].legend()
    axes[0].set_xlabel("time [s]")
    mid = result.grid.num_points[0] // 2
    z = result.roa["learned"].reshape(result.grid.shape)[mid, :, mid, :]
    axes[1].imshow(z.T, origin="lower", extent=[-1, 1, -1, 1])
    axes[1].set_xlabel(r"$\theta$")
    axes[1].set_ylabel(r"$\dot\theta$")


def main(argv=None):
    args = example_args(__doc__, argv=argv)
    result = run(full=args.full, seed=args.seed)
    maybe_save_plot(args, "reinforcement_learning_cartpole",
                    lambda: plot(result))
    return result


if __name__ == "__main__":
    main()
