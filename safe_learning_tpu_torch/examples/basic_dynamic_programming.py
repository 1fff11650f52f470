"""Dynamic programming with a piecewise-linear value function and policy.

Counterpart of ``examples/basic_dynamic_programming.py:22-85``: the mountain
car with a PWL value function solved exactly (the fixed point of the
value update, on the device) and a saturated PWL policy improved by
gradient ascent on the one-step lookahead values, by
``PolicyIteration.policy_iteration``; then a closed-loop rollout from
``(-0.5, 0)`` that must reach the goal ``x >= 0.6``. ``--full`` runs the
reference's 30x30 grid, the quick mode 20x20.

Run:

    python -m safe_learning_tpu_torch.examples.basic_dynamic_programming \
        [--full]

``--plot`` needs the unported ``plotting`` module (ROADMAP item 22).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from ..functions.base import LambdaFunction, Saturation, as_tensor
from ..functions.simplex import Triangulation
from ..grids import GridWorld
from ..rl import PolicyIteration
from ._common import Timer, example_args, no_plot

DOMAIN = [[-1.2, 0.7], [-0.07, 0.07]]
GOAL = 0.6


def mountain_car(xu):
    """Mountain-car update (notebook cell 2)."""
    x0 = xu[:, 0] + xu[:, 1]
    x1 = xu[:, 1] + 0.001 * xu[:, 2] - 0.0025 * torch.cos(3 * xu[:, 0])
    return torch.stack((x0, x1), dim=1)


def run(full=False, seed=0):
    """The example at the reference's size (``full``) or the quick one.

    Deterministic (``seed`` is accepted for the common command line).
    Checks the example's assertion (the car reaches the goal within 1000
    steps) and returns a namespace: the policy iteration, its ``info``,
    the trajectory, whether it reached the goal, and the wall time of the
    policy iteration.
    """
    del seed
    n_points = [30, 30] if full else [20, 20]
    gamma = 0.99
    terminal_reward = 1 - gamma

    discretization = GridWorld(DOMAIN, n_points)
    value_function = Triangulation(discretization,
                                   np.zeros(discretization.nindex),
                                   project=True)
    policy = Saturation(Triangulation(discretization,
                                      np.zeros(discretization.nindex),
                                      project=True), -1.0, 1.0)

    def reward_fn(xu):
        """Terminal reward beyond the goal position."""
        return (xu[:, :1] > GOAL).to(xu.dtype) * terminal_reward

    dynamics = LambdaFunction(mountain_car, input_dim=3, output_dim=2)
    reward = LambdaFunction(reward_fn, input_dim=3, output_dim=1)
    rl = PolicyIteration(policy, dynamics, reward, value_function,
                         gamma=gamma)

    with Timer("policy iteration") as timer:
        info = rl.policy_iteration(outer_iters=30, ascent_steps=200,
                                   learning_rate=1.0, convergence_tol=1e-1)
    print("{} after {} iterations (value change {:.3g}, policy change "
          "{:.3g})".format(
              "converged" if info["converged"] else "didn't converge",
              info["iterations"], info["value_change"],
              info["policy_change"]))

    # Closed-loop rollout from x0 = (-0.5, 0): must reach the goal.
    state = as_tensor(np.array([[-0.5, 0.0]]))
    traj = [state]
    with torch.no_grad():
        for _ in range(999):
            state = dynamics(state, rl.policy(state))
            traj.append(state)
            if float(state[0, 0]) >= GOAL:
                break
    traj = torch.cat(traj).cpu().numpy()
    reached = bool(traj[-1, 0] >= GOAL)
    print("trajectory: {} steps, final x = {:.3f}, reached goal: {}".format(
        len(traj), traj[-1, 0], reached))
    assert reached, "learned policy should drive the car up the mountain"
    return types.SimpleNamespace(rl=rl, info=info, trajectory=traj,
                                 reached=reached, policy_s=timer.seconds)


def main(argv=None):
    args = example_args(__doc__, argv=argv)
    if args.plot:
        no_plot("basic_dynamic_programming")
    return run(full=args.full, seed=args.seed)


if __name__ == "__main__":
    main()
