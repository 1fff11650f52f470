"""Utilities: parameter grids, LQR solvers, batching, rollouts, the
mutation-tracked boolean mask and the training helpers.

Counterpart of ``safe_learning_tpu/utils.py``, all of it. The JAX
package's pytrees of parameters are here the nested dictionaries of
``Function.parameters_dict``: dictionaries, tuples and lists of tensors,
with ``None`` for an absent leaf (a network's output bias).
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.linalg
import torch

from .config import config
from .functions.base import as_tensor

__all__ = [
    "batchify", "combinations", "linearly_spaced_combinations", "lqr",
    "dlqr", "ellipse_bounds", "unique_rows", "compute_trajectory",
    "get_parameter_change", "find_nearest", "balanced_class_weights",
    "balanced_confusion_weights", "constrained_batch_sampler",
    "add_weight_constraint", "gradient_clipping", "monomials",
    "derivative_monomials", "TrackedMask", "tracked_mask",
]


def _tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of a parameter tree (and the
    matching leaves of ``rest``), keeping its structure; ``None`` leaves
    stay ``None``, as in ``jax.tree_util.tree_map``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def _tree_leaves(tree):
    """The leaves of a parameter tree, ``None`` skipped and dictionaries in
    sorted key order (the order of ``jax.tree_util.tree_leaves``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


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


def combinations(arrays):
    """All combinations of the input arrays, one per row."""
    return np.array(np.meshgrid(*arrays)).T.reshape(-1, len(arrays))


def linearly_spaced_combinations(bounds, num_samples):
    """2-D array of all linearly spaced combinations within the bounds."""
    bounds = np.atleast_2d(bounds)
    num_samples = np.broadcast_to(num_samples, len(bounds))
    inputs = [np.linspace(b[0], b[1], n) for b, n in zip(bounds,
                                                         num_samples)]
    return combinations(inputs)


def ellipse_bounds(p, level, n=100):
    """Upper and lower bounds of the 2-D ellipse ``x' P x = level``:
    ``(x, y_upper, y_lower)``, host numpy."""
    n += n % 2
    eigval, eigvec = np.linalg.eig(p)
    eigvec = eigvec * np.sqrt(level / eigval)
    angle = np.linspace(0, 2 * np.pi, n)[:, None]
    angle += np.arctan(eigvec[0, 1] / eigvec[0, 0])
    pos = np.cos(angle) * eigvec[:, 0] + np.sin(angle) * eigvec[:, 1]
    n = n // 2
    return pos[:n, 0], pos[:n, 1], pos[:n - 1:-1, 1]


def unique_rows(array):
    """Unique rows of a 2-D array."""
    return np.unique(np.ascontiguousarray(array), axis=0)


def _host_array(value):
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def get_parameter_change(old_params, new_params, ord="inf"):
    """Norm of the flattened difference of two parameter trees."""
    if ord == "inf":
        ord = np.inf
    elif ord == "-inf":
        ord = -np.inf
    old_flat = np.concatenate([_host_array(p).ravel()
                               for p in _tree_leaves(old_params)])
    new_flat = np.concatenate([_host_array(p).ravel()
                               for p in _tree_leaves(new_params)])
    return np.linalg.norm(new_flat - old_flat, ord=ord)


def find_nearest(array, value, sorted_1d=True):
    """Index and value of the entry of a sorted 1-D array nearest to
    ``value``."""
    if not sorted_1d:
        array = np.sort(array)
    idx = np.searchsorted(array, value, side="left")
    if idx > 0 and (idx == len(array)
                    or np.abs(value - array[idx - 1])
                    < np.abs(value - array[idx])):
        idx -= 1
    return idx, array[idx]


def balanced_class_weights(y_true, scale_by_total=True):
    """Per-sample weights balancing the counts of two class labels;
    returns ``(weights, [n_negative, n_positive])``."""
    y = np.asarray(y_true).astype(bool)
    n_pos = y.sum()
    n_neg = y.size - n_pos
    class_counts = np.array([n_neg, n_pos])
    weights = np.ones_like(y, dtype=float)
    weights[y] /= n_pos
    weights[~y] /= n_neg
    if scale_by_total:
        weights *= y.size
    return weights, class_counts


def balanced_confusion_weights(y, y_true, scale_by_total=True):
    """Per-sample weights from the confusion matrix of predictions ``y``
    against labels ``y_true``; returns ``(weights, [[tn, fn], [fp,
    tp]])``."""
    y = np.asarray(y).astype(bool)
    y_true = np.asarray(y_true).astype(bool)
    tp = (y & y_true).sum()
    tn = (~y & ~y_true).sum()
    fp = (y & ~y_true).sum()
    fn = (~y & y_true).sum()
    confusion_counts = np.array([[tn, fn], [fp, tp]])
    weights = np.ones_like(y, dtype=float)
    weights[y & y_true] /= tp
    weights[~y & ~y_true] /= tn
    weights[y & ~y_true] /= fp
    weights[~y & y_true] /= fn
    if scale_by_total:
        weights *= y.size
    return weights, confusion_counts


def add_weight_constraint(params, lower, upper):
    """Clip a parameter tree to box constraints.

    Apply it after an optimizer update to keep parameters inside their
    bounds. ``lower`` and ``upper`` are numbers applied to every leaf, or
    trees of the parameters' structure.
    """
    if np.isscalar(lower) and np.isscalar(upper):
        return _tree_map(lambda w: torch.clamp(w, lower, upper), params)
    return _tree_map(lambda w, lo, hi: torch.clamp(w, as_tensor(lo).to(w),
                                                  as_tensor(hi).to(w)),
                    params, lower, upper)


def gradient_clipping(grads, lower, upper):
    """Clip a gradient tree elementwise before an update; ``lower`` and
    ``upper`` as in :func:`add_weight_constraint`."""
    return add_weight_constraint(grads, lower, upper)


def constrained_batch_sampler(generator, dynamics, policy, state_dim,
                              batch_size, action_limit=None):
    """Sample training states that stay in the unit box and unsaturated.

    Draws a ``(batch_size, state_dim)`` uniform sample on ``[-1, 1]`` from
    ``generator`` (a ``torch.Generator`` on ``config.device``) and returns
    it with a validity mask, as the JAX package does under ``jit``:

    Returns
    -------
    batch : (batch_size, state_dim) tensor, invalid rows zeroed
    mask : (batch_size,) bool tensor, True where the next state lies inside
        the unit box (and, with ``action_limit``, the policy's action
        strictly within ``[-|action_limit|, |action_limit|]``).
    """
    batch = 2.0 * torch.rand((int(batch_size), int(state_dim)),
                             generator=generator, dtype=config.dtype,
                             device=config.device) - 1.0
    actions = policy(batch)
    future = dynamics(batch, actions)
    if isinstance(future, (tuple, list)):
        future = future[0]
    mask = ((future >= -1.0) & (future <= 1.0)).all(dim=1)
    if action_limit is not None:
        c = abs(action_limit)
        mask &= ((actions >= -c) & (actions <= c)).all(dim=1)
    return batch * mask[:, None].to(batch.dtype), mask


def monomials(x, deg):
    """2-D monomial features up to degree ``deg``: ``x``, then for each
    degree ``d`` the terms ``x_0^(d-k) x_1^k``, ``k = 0..d``."""
    x = torch.atleast_2d(as_tensor(x))
    feats = [x]
    for d in range(2, deg + 1):
        feats.append(torch.stack(
            [x[:, 0] ** (d - k) * x[:, 1] ** k for k in range(d + 1)],
            dim=1))
    return torch.cat(feats, dim=1)


def derivative_monomials(x, deg):
    """Derivatives of :func:`monomials` by autodiff, shape ``(N,
    n_features, 2)``."""
    x = torch.atleast_2d(as_tensor(x))
    jac = torch.func.vmap(torch.func.jacrev(
        lambda p: monomials(p[None, :], deg)[0]))
    return jac(x)


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
