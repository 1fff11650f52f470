"""Safe policy optimization for an uncertain 1-D linear system, on the card.

Counterpart of ``examples/one_d_example.py:26-125``: GP dynamics over
state-action space (a ``Matern32 x Linear`` kernel over ``(x, u)``) with a
stable prior mean, a piecewise-linear policy improved by the exact PWL
value solve and discrete policy improvement over an action grid, and safe
exploration that keeps the certified safe set from shrinking while the GP
learns the true dynamics ``x+ = 1.2 x + u``. Every GP predict on the card
(the certify's sweep, the value solve's and the policy improvement's
evaluations of the mean, ``get_safe_sample``'s scores) runs the CUDA
kernel of composite-kernel GPs (``ops/gp_kernel.py::
gp_predict_general_cuda``). ``--full`` runs the reference's sizes: 1000
states, 101 actions and 20 updates; the quick mode 251 states, 51 actions
and 10 updates.

Run:

    python -m safe_learning_tpu_torch.examples.one_d_example [--full]

``--plot`` needs the unported ``plotting`` module (ROADMAP item 22).
"""

from __future__ import annotations

import types

import numpy as np
import torch
from scipy import linalg

from ..explore import get_safe_sample
from ..functions.gp import GaussianProcess, LinearKernel, Matern32
from ..functions.linear import LinearSystem, QuadraticFunction
from ..functions.simplex import Triangulation
from ..grids import GridWorld
from ..lyapunov import Lyapunov
from ..rl import PolicyIteration
from ..utils import compute_trajectory
from ._common import Timer, example_args, no_plot


def kernel():
    """The notebook's prior (cell 5): ``Matern32 x Linear`` over ``(x, u)``,
    the linear variances 0.2 and 1."""
    return (Matern32(lengthscales=1.0, input_dim=2)
            * LinearKernel(variances=[0.2, 1.0], input_dim=2))


def sizes(full):
    """``(num_states, num_actions, n_updates)`` of a run."""
    return (1000, 101, 20) if full else (251, 51, 10)


def run(full=False, seed=0):
    """The example at the reference's sizes (``full``) or the quick ones.

    ``seed`` seeds the numpy generator passed to ``get_safe_sample`` (as
    the JAX example's ``--seed``). Checks the example's assertions (the
    safe set does not shrink, the GP holds one point an update, the
    optimized policy brings the true system from the largest safe state
    to ``|x| < 0.1`` in 50 steps) and returns a namespace: the Lyapunov
    instance, the policy iteration, the initial and per-update safe
    fractions, ``c_max``, the GP's count, the closed loop's start and
    final ``|x|``, and the wall times of the initial optimization and of
    the updates.
    """
    num_states, num_actions, n_updates = sizes(full)
    state_limits = np.array([[-1.0, 1.0]])
    action_limits = np.array([[-0.5, 0.5]])
    safety_disc = GridWorld(state_limits, num_states)
    action_disc = GridWorld(action_limits, num_actions)
    tau = float(np.max(safety_disc.unit_maxes))
    print("Grid size: {}".format(safety_disc.nindex))

    # PWL policy on a coarser grid (notebook cell 3).
    policy_disc = GridWorld(state_limits, 51)
    policy = Triangulation(policy_disc, np.zeros(policy_disc.nindex),
                           project=True)

    # GP dynamics: Matern32 x Linear over (x, u), stable prior mean
    # x+ = x + 0.1 u; true dynamics x+ = 1.2 x + u (notebook cell 5).
    true_dynamics = LinearSystem([[1.2, 1.0]])
    gp = GaussianProcess(kernel(), np.empty((0, 2)), np.empty((0, 1)),
                         noise_variance=0.01 ** 2, beta=2.0,
                         mean_function=LinearSystem([[1.0, 0.1]]),
                         capacity=max(32, n_updates))
    lipschitz_dynamics = 0.8 + 0.5

    # PWL Lyapunov candidate |x| (notebook cell 7).
    lyapunov_function = Triangulation(GridWorld(state_limits, 3),
                                      [1.0, 0.0, 1.0])
    lyap = Lyapunov(safety_disc, lyapunov_function, gp, lipschitz_dynamics,
                    1.0, tau, policy)
    lyap.initial_safe_set = np.abs(safety_disc.all_points.squeeze()) < 0.05
    lyap.safe_set |= lyap.initial_safe_set
    lyap.update_safe_set()
    initial_fraction = float(lyap.safe_set.mean())
    print("initial safe fraction: {:.3f}".format(initial_fraction))

    # RL problem: quadratic reward, PWL value function (notebook cell 11).
    reward = QuadraticFunction(linalg.block_diag(-1.0, -1.0))
    value_function = Triangulation(policy_disc,
                                   np.zeros(policy_disc.nindex),
                                   project=True)
    rl = PolicyIteration(policy, gp.to_mean_function(), reward,
                         value_function)

    action_space = action_disc.all_points
    action_variation = GridWorld(action_limits / 20, 11).all_points
    rng = np.random.default_rng(seed)

    with Timer("initial policy optimization") as policy_timer:
        for _ in range(3):
            rl.optimize_value_function()
            rl.discrete_policy_optimization(action_space)
        lyap.policy = rl.policy
        lyap.update_safe_set()

    def update_gp():
        """One safe active-learning step (notebook cell 15)."""
        rl.optimize_value_function()
        rl.discrete_policy_optimization(action_space)
        lyap.policy = rl.policy
        lyap.update_safe_set(can_shrink=False)
        xu, _ = get_safe_sample(lyap, action_variation, action_limits,
                                rng=rng)
        measurement = true_dynamics(xu).cpu().numpy()
        new_gp = lyap.dynamics.add_data_point(xu, measurement)
        lyap.dynamics = new_gp
        rl.dynamics = new_gp.to_mean_function()

    history = []
    with Timer("online learning ({} updates)".format(n_updates)) as timer:
        for _ in range(n_updates):
            update_gp()
            history.append(float(lyap.safe_set.mean()))

    lyap.update_safe_set(can_shrink=False)
    print("safe fraction history:",
          " ".join("{:.3f}".format(h) for h in history))
    print("c_max: {:.4f}  GP data points: {}".format(
        lyap.c_max, int(lyap.dynamics.count)))
    assert history[-1] >= history[0], "safe set must not shrink"
    assert int(lyap.dynamics.count) == n_updates

    # The optimized policy must stabilize the true system from inside the
    # safe set: x+ = 1.2 x + pi(x) with |pi| <= 0.5.
    safe_states = safety_disc.all_points[np.asarray(lyap.safe_set)]
    x0 = np.array([[float(safe_states.max())]])
    states, _ = compute_trajectory(true_dynamics, rl.policy, x0, 50)
    final = float(torch.abs(states[-1]).max())
    print("closed-loop from x0={:.3f}: final |x| = {:.4f}".format(
        float(x0[0, 0]), final))
    assert final < 0.1
    return types.SimpleNamespace(
        lyap=lyap, rl=rl, initial_fraction=initial_fraction,
        fractions=history, c_max=float(lyap.c_max),
        count=int(lyap.dynamics.count), x0=float(x0[0, 0]), final=final,
        policy_s=policy_timer.seconds, loop_s=timer.seconds,
        n_updates=n_updates)


def main(argv=None):
    args = example_args(__doc__, argv=argv)
    if args.plot:
        no_plot("one_d_example")
    return run(full=args.full, seed=args.seed)


if __name__ == "__main__":
    main()
