"""Closed-loop analysis tools: ROA estimation, reward rollouts, responses.

Counterpart of ``safe_learning_tpu/analysis.py``. The JAX package rolls
whole grids out inside one ``lax.scan``; here the rollout is a loop of
eager steps on the device of the grid's tensor (``config.device``), with
no host wait inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import config
from .functions.base import as_tensor
from .grids import GridWorld

__all__ = ["compute_roa", "reward_rollout", "compute_closedloop_response",
           "gridify"]

#: Rollout steps between two host checks of ``reward_rollout``'s stopping
#: flag.
ROLLOUT_BLOCK = 64


def _grid_points(grid):
    if isinstance(grid, GridWorld):
        return as_tensor(grid.all_points)
    return torch.atleast_2d(as_tensor(grid))


def _step(closed_loop_dynamics, states):
    nxt = closed_loop_dynamics(states)
    if isinstance(nxt, tuple):
        nxt = nxt[0]
    return nxt


def _simulate(closed_loop_dynamics, points, horizon,
              return_trajectories=False, clip=1e6):
    """Roll every point forward ``horizon - 1`` steps.

    Divergent trajectories are clamped to ``[-clip, clip]`` so that they
    stay finite; an overflowing point is outside the ROA either way.
    Returns ``(end_states, trajectory)``, the trajectory ``(horizon - 1, N,
    d)`` or ``None``.
    """
    states, traj = points, []
    for _ in range(horizon - 1):
        states = torch.clamp(_step(closed_loop_dynamics, states), -clip,
                             clip)
        if return_trajectories:
            traj.append(states)
    if not return_trajectories:
        return states, None
    if not traj:
        return states, points.new_empty((0,) + tuple(points.shape))
    return states, torch.stack(traj)


def compute_roa(grid, closed_loop_dynamics, horizon=100, tol=1e-3,
                equilibrium=None, no_traj=True, segment_steps=None):
    """Brute-force region of attraction by forward simulation.

    Simulates every grid point for ``horizon - 1`` steps and keeps those
    ending within ``tol`` of the equilibrium (the origin by default).
    ``segment_steps`` runs the rollout in segments of at most that many
    steps (the end states feed the next segment, the same composition);
    it is valid only with ``no_traj=True``.

    Returns the ROA as a host boolean array, and with ``no_traj=False``
    also the trajectories ``(nindex, ndim, horizon)``, initial states
    first.
    """
    points = _grid_points(grid)
    if segment_steps is not None:
        if not no_traj:
            raise ValueError("segment_steps requires no_traj=True "
                             "(segmented trajectories are not stacked)")
        segment_steps = int(segment_steps)
        if segment_steps < 1:
            raise ValueError("segment_steps must be >= 1 (got {}); a "
                             "non-positive chunk would never consume the "
                             "horizon".format(segment_steps))
    if segment_steps is not None and horizon - 1 > segment_steps:
        remaining = horizon - 1
        end_states = points
        while remaining > 0:
            chunk = min(segment_steps, remaining)
            end_states, _ = _simulate(closed_loop_dynamics, end_states,
                                      chunk + 1)
            remaining -= chunk
        traj = None
    else:
        end_states, traj = _simulate(closed_loop_dynamics, points, horizon,
                                     return_trajectories=not no_traj)
    if equilibrium is None:
        equilibrium = torch.zeros((1, points.shape[1]), dtype=points.dtype,
                                  device=points.device)
    else:
        equilibrium = as_tensor(equilibrium).to(points)
    dists = torch.linalg.norm(end_states - equilibrium, dim=1)
    roa = (dists <= tol).cpu().numpy()
    if no_traj:
        return roa
    trajectories = torch.cat([points[:, :, None], traj.permute(1, 2, 0)],
                             dim=2)
    return roa, trajectories.cpu().numpy()


def reward_rollout(grid, closed_loop_dynamics, reward_function, discount,
                   horizon=250, tol=1e-3):
    """Discounted finite-horizon reward sums over a discretization.

    Step ``t`` adds ``discount**t * reward(x_t)``. The sums freeze after
    the first step whose largest contribution falls below ``tol`` (that
    contribution included), as the reference breaks there. The host checks
    the flag every ``ROLLOUT_BLOCK`` steps and stops once it is set; the
    frozen sums make that the same result as running the whole horizon.
    """
    points = _grid_points(grid)
    states = points
    rollout = torch.zeros(points.shape[0], dtype=points.dtype,
                          device=points.device)
    done = torch.zeros((), dtype=torch.bool, device=points.device)
    inf = torch.full((), float("inf"), dtype=points.dtype,
                     device=points.device)
    max_contribs = []
    for t in range(horizon):
        contrib = (discount ** t) * reward_function(states).reshape(-1)
        rollout = rollout + torch.where(done, 0.0, contrib)
        max_contrib = contrib.abs().max()
        max_contribs.append(torch.where(done, inf, max_contrib))
        done = done | (max_contrib < tol)
        states = _step(closed_loop_dynamics, states)
        if (t + 1) % ROLLOUT_BLOCK == 0 and bool(done):
            break
    below = torch.stack(max_contribs).cpu().numpy() < tol
    if below.any():
        print("Reward sums converged after {} steps!".format(
            int(np.argmax(below)) + 1))
    else:
        print("Reward sums did not converge!")
    return rollout.cpu().numpy()


def compute_closedloop_response(dynamics, policy, state_dim, steps, dt,
                                reference="zero", const=1.0, ic=None):
    """Closed-loop response to an impulse, step or zero reference signal.

    Returns host arrays ``(states, actions, times, reference)``, each with
    ``steps + 1`` rows, the initial state first.
    """
    action_dim = policy.output_dim

    if reference == "impulse":
        r = np.zeros((steps + 1, action_dim))
        r[0, :] = 1.0 / dt
    elif reference == "step":
        r = const * np.ones((steps + 1, action_dim))
    elif reference == "zero":
        r = np.zeros((steps + 1, action_dim))
    else:
        raise ValueError("unknown reference {!r}".format(reference))
    r = as_tensor(r)

    state = torch.zeros((1, state_dim), dtype=config.dtype,
                        device=config.device)
    if ic is not None:
        state = as_tensor(np.asarray(ic)).reshape(1, state_dim)
    states, actions = [], []
    for ref in r:
        action = policy(state)
        states.append(state[0])
        actions.append(action[0])
        state = dynamics(state, action + ref[None, :])
        if isinstance(state, tuple):
            state = state[0]
    times = dt * np.arange(steps + 1, dtype=config.np_dtype).reshape(-1, 1)
    return (torch.stack(states).cpu().numpy(),
            torch.stack(actions).cpu().numpy(), times, r.cpu().numpy())


def gridify(norms, maxes=None, num_points=25):
    """A normalized ``GridWorld`` from per-dimension scales: each dimension
    spans ``[-maxes / norms, maxes / norms]`` (``maxes`` defaults to
    ``norms``)."""
    norms = np.asarray(norms).ravel()
    maxes = norms if maxes is None else np.asarray(maxes).ravel()
    limits = np.column_stack((-maxes / norms, maxes / norms))
    if isinstance(num_points, int):
        num_points = [num_points] * len(norms)
    return GridWorld(limits, num_points)
