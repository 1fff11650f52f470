"""Utilities: the mutation-tracked boolean mask, the LQR solvers,
``batchify`` and closed-loop rollouts.

Counterpart of ``safe_learning_tpu/utils.py:34-121``, ``:142-160`` and
``:182-208``; the training helpers are not ported yet (ROADMAP queue 1
item 11).
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.linalg
import torch

from .functions.base import as_tensor

__all__ = ["TrackedMask", "tracked_mask", "lqr", "dlqr", "batchify",
           "compute_trajectory"]


def batchify(arrays, batch_size):
    """Yield ``(start_index, batches)``: consecutive slices of
    ``batch_size`` rows of each array, in order."""
    if not isinstance(arrays, (list, tuple)):
        arrays = (arrays,)
    for i in itertools.count(start=0, step=batch_size):
        batches = [array[i:i + batch_size] for array in arrays]
        if not len(batches[0]):
            break
        yield i, batches


def compute_trajectory(dynamics, policy, initial_state, num_steps):
    """Roll out a closed-loop system for ``num_steps`` states.

    A plain loop of policy and dynamics calls on the device of the
    working tensors (the JAX package compiles it as one ``lax.scan``); an
    uncertain model contributes its mean.

    Returns
    -------
    states : (num_steps, state_dim) tensor, the initial state first
    actions : (num_steps - 1, action_dim) tensor
    """
    state = torch.atleast_2d(as_tensor(initial_state))
    states, actions = [state], []
    for _ in range(num_steps - 1):
        action = policy(state)
        state = dynamics(state, action)
        if isinstance(state, tuple):
            state = state[0]
        states.append(state)
        actions.append(action)
    if not actions:
        actions = [policy(state)[:0]]
    return torch.cat(states), torch.cat(actions)


def lqr(a, b, q, r):
    """Continuous-time LQR gain and Riccati solution: ``u = -k @ x``.

    Host-side setup code (scipy), as ``safe_learning_tpu.utils.lqr``.
    """
    a, b, q, r = map(np.atleast_2d, (a, b, q, r))
    p = scipy.linalg.solve_continuous_are(a, b, q, r)
    k = np.linalg.solve(r, b.T.dot(p))
    return k, p


def dlqr(a, b, q, r):
    """Discrete-time LQR gain and Riccati solution: ``u = -k @ x``.

    Host-side setup code (scipy), as ``safe_learning_tpu.utils.dlqr``.
    """
    a, b, q, r = map(np.atleast_2d, (a, b, q, r))
    p = scipy.linalg.solve_discrete_are(a, b, q, r)
    bp = b.T.dot(p)
    k = np.linalg.solve(bp.dot(b) + r, bp.dot(a))
    return k, p


class TrackedMask(np.ndarray):
    """Count in-place mutations of an ndarray view of a boolean mask.

    :class:`~safe_learning_tpu_torch.lyapunov.Lyapunov` stores its safe and
    initial masks as this view so device-resident copies can key on
    ``(id, version, mutations)`` and never serve a stale mask after item or
    slice assignment or an in-place logical op through an alias. The
    counter cell is shared with every view, so mutation through a view
    still invalidates the parent's caches.

    Escape hatches that bypass tracking: ``np.asarray(mask)`` strips the
    subclass but views the same buffer, and raw-buffer mutators
    (``mask.fill``, ``np.put``) do not go through ``__setitem__``.
    """

    def __array_finalize__(self, obj):
        """Share the mutation-counter cell with the source view."""
        cell = getattr(obj, "_mut_cell", None)
        self._mut_cell = cell if cell is not None else [0]

    @property
    def mutations(self):
        """Count of tracked in-place mutations (shared across views)."""
        return self._mut_cell[0]

    def _bump(self):
        self._mut_cell[0] += 1

    def __setitem__(self, key, value):
        """Assign items/slices, counting the mutation."""
        super().__setitem__(key, value)
        self._bump()

    def __ior__(self, other):
        """In-place OR, counting the mutation."""
        out = super().__ior__(other)
        self._bump()
        return out

    def __iand__(self, other):
        """In-place AND, counting the mutation."""
        out = super().__iand__(other)
        self._bump()
        return out

    def __ixor__(self, other):
        """In-place XOR, counting the mutation."""
        out = super().__ixor__(other)
        self._bump()
        return out


def tracked_mask(value):
    """Return ``value`` as a :class:`TrackedMask`.

    Other inputs are copied, so the caller's own reference is never an
    untracked alias; an existing :class:`TrackedMask` passes through.
    """
    if isinstance(value, TrackedMask):
        return value
    return np.array(value, copy=True).view(TrackedMask)
