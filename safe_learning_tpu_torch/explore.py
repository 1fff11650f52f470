"""Safe exploration: the most informative state-action pair that provably
maps back into the certified level set.

Counterpart of ``safe_learning_tpu/explore.py``: the single step
``get_safe_sample``, the k-step ``get_safe_sample_batch`` and
``perturb_actions``. One step runs on ``config.device`` from the sampled
safe states to the chosen pair: the policy's actions, the candidate rows
(perturbed and clipped, or the cross product with given actions), the GP
predict, the level-set test, the membership of the mean next state in the
safe set and the argmax of the predictive uncertainty. Only the
subsampling of safe states (host RNG) and the single step's backup-policy
fallback run on the host. ``get_safe_sample_batch`` runs k such steps,
each measuring the chosen pair and appending it to the GP on the device,
with no host wait between them.

Departures from the JAX package, on purpose:

- no power-of-two padding of the safe states or the candidates: it
  exists there so that XLA does not retrace, and a padded row (a copy of
  the last one) cannot win the argmax before its original;
- a batch step scores its candidates and its backup rows in one GP
  predict (the JAX package predicts twice), and its noise key is a
  ``torch.Generator``;
- ``extended=True`` is not ported yet.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .config import config
from .errorbounds import analytic_exploration_margin
from .functions.base import as_tensor
from .functions.gp import _device_border_append
from .lyapunov import _as_column_batch, _eval_lipschitz

__all__ = ["perturb_actions", "get_safe_sample", "get_safe_sample_batch"]


def perturb_actions(states, actions, perturbations, limits=None):
    """The ``(N * X, n + m)`` host matrix of perturbed state-actions.

    Each state repeats once per perturbation; with ``limits`` the actions
    are clipped and duplicate rows removed (``np.unique``, so the rows come
    out sorted), as ``safe_learning_tpu.perturb_actions``.
    """
    states = np.atleast_2d(states)
    actions = np.atleast_2d(actions)
    perturbations = np.atleast_2d(perturbations)
    num_states, state_dim = states.shape

    states_new = np.repeat(states, len(perturbations), axis=0)
    actions_new = (np.repeat(actions, len(perturbations), axis=0)
                   + np.tile(perturbations, (num_states, 1)))
    state_actions = np.column_stack((states_new, actions_new))

    if limits is not None:
        limits = np.atleast_2d(limits)
        np.clip(state_actions[:, state_dim:], limits[:, 0], limits[:, 1],
                out=state_actions[:, state_dim:])
        state_actions = np.unique(np.ascontiguousarray(state_actions),
                                  axis=0)
    return state_actions


def _future_values(dynamics, lyapunov_function, lipschitz_lyapunov,
                   state_actions):
    """GP predict and confidence-weighted future value.

    Returns ``(mean, bound, future)``: the mean next states, the summed
    predictive error (the informativeness) and ``v(mean) + sum_j |L_v_j|
    sigma_j``, the error taken per dimension, as in the decrease bound.
    """
    mean, std = dynamics(state_actions)
    bound = std.sum(dim=1)
    lv = _as_column_batch(_eval_lipschitz(lipschitz_lyapunov, mean))
    lv = abs(lv) if isinstance(lv, float) else lv.abs()
    future = lyapunov_function(mean).reshape(-1) + (lv * std).sum(dim=1)
    return mean, bound, future


def _score_candidates(dynamics, lyapunov_function, lipschitz_lyapunov,
                      c_max, state_actions, margin=0.0):
    """:func:`_future_values` and the level test: ``(mean, bound, safe)``
    with ``safe`` whether ``future < c_max - margin``."""
    mean, bound, future = _future_values(dynamics, lyapunov_function,
                                         lipschitz_lyapunov, state_actions)
    return mean, bound, future < c_max - margin


def _perturb_candidates(policy, safe_states, perturbations, limits):
    """Candidate rows on the device: the policy's actions at the states,
    each plus every perturbation and clipped to ``limits`` (or not, when
    it is ``None``), in :func:`perturb_actions`' order before its
    ``np.unique``."""
    n, d = safe_states.shape
    p, m = perturbations.shape
    actions = _as_column_batch(policy(safe_states))
    acts = actions[:, None, :] + perturbations[None, :, :]
    if limits is not None:
        acts = torch.clamp(acts, limits[:, 0], limits[:, 1])
    states = safe_states[:, None, :].expand(n, p, d)
    return torch.cat([states, acts], dim=-1).reshape(n * p, d + m)


def _action_candidates(safe_states, actions):
    """Candidate rows: every safe state with every given action."""
    n, d = safe_states.shape
    na, m = actions.shape
    states = safe_states[:, None, :].expand(n, na, d)
    acts = actions[None, :, :].expand(n, na, m)
    return torch.cat([states, acts], dim=-1).reshape(n * na, d + m)


def _select_best(lyapunov, state_actions, safe_set_dev, margin):
    """Score every candidate and pick the safe one with the largest
    predictive error. Returns ``(row, bound, safe)`` as device tensors;
    ``safe`` is False only when no candidate is safe."""
    mean, bound, safe = _score_candidates(
        lyapunov.dynamics, lyapunov.lyapunov_function,
        lyapunov._lipschitz_lyapunov, lyapunov.c_max, state_actions, margin)
    if safe_set_dev is not None:
        # The mean next state must lie in the current safe set.
        grid = lyapunov.discretization
        safe = safe & safe_set_dev[grid.state_to_index(mean)]
    score = torch.where(safe, bound, torch.full_like(bound, -np.inf))
    best = torch.argmax(score)
    return state_actions[best], bound[best], safe[best]


def get_safe_sample(lyapunov, perturbations=None, limits=None,
                    positive=False, num_samples=None, actions=None,
                    rng=None, extended=False):
    """Return the most informative provably safe state-action pair.

    Parameters
    ----------
    lyapunov : Lyapunov
    perturbations : (X, m) array, optional
        Perturbations of the policy's actions at the safe states.
    limits : (m, 2) array, optional
        Action limits; the perturbed actions are clipped to them.
    positive : bool, optional
        Skip the check that the mean next state lies in the safe set.
    num_samples : int, optional
        Subsample this many safe states (with replacement, from ``rng``).
    actions : (A, m) array, optional
        Explicit candidate actions, used with every safe state, when
        ``perturbations`` is None.
    rng : numpy Generator, optional
    extended : bool, optional
        Must be False: the extended scorer is ROADMAP queue 1 item 18.

    Returns
    -------
    state_action : (1, n + m) ndarray
    bound : float
        The summed predictive error at the chosen pair.

    Beside a per-grid-point ``certificate_margin``, and with no dedicated
    ``exploration_margin``, each candidate is held to its own derived
    margin (:func:`_per_candidate_margin`) on the host-built rows
    (:func:`_host_candidates`); when that derivation refuses, the margin
    collapses to the grid-wide largest one (:func:`_margin_of`), as in
    the JAX package (``safe_learning_tpu/explore.py:265-299``).

    When no candidate is safe, the step warns (``RuntimeWarning``) and
    falls back to the backup policy: the unperturbed policy actions at
    the sampled states, the one with the largest predictive error.
    """
    if extended:
        raise NotImplementedError(
            "get_safe_sample(extended=True) is ROADMAP queue 1 item 18 "
            "(the rigor ladder)")
    if perturbations is None and actions is None:
        raise ValueError("provide either perturbations or actions")
    rng = np.random.default_rng() if rng is None else rng
    grid = lyapunov.discretization

    safe_idx = np.where(lyapunov.safe_set)[0]
    if len(safe_idx) == 0:
        raise RuntimeError(
            "the safe set is empty — no state to explore from (provide "
            "an initial_set or verify with a smaller tau first)")
    safe_states = np.asarray(grid.all_points)[safe_idx]
    if num_samples is not None and len(safe_states) > num_samples:
        pick = rng.choice(len(safe_states), num_samples, replace=True)
        safe_states = safe_states[pick]
    safe_states_dev = as_tensor(safe_states)
    action_dim = np.atleast_2d(
        actions if perturbations is None else perturbations).shape[1]

    margin_vec = None
    if (getattr(lyapunov, "exploration_margin", None) is None
            and np.ndim(getattr(lyapunov, "certificate_margin", None))):
        host_rows = _host_candidates(lyapunov, safe_states, safe_states_dev,
                                     perturbations, actions, limits)
        margin_vec = _per_candidate_margin(lyapunov, host_rows)
    if margin_vec is not None:
        candidates, margin = as_tensor(host_rows), as_tensor(margin_vec)
    elif perturbations is None:
        candidates = _action_candidates(
            safe_states_dev, as_tensor(np.atleast_2d(actions)))
        margin = _margin_of(lyapunov)
    else:
        candidates = _perturb_candidates(
            lyapunov.policy, safe_states_dev,
            as_tensor(np.atleast_2d(perturbations)),
            None if limits is None else as_tensor(np.atleast_2d(limits)))
        margin = _margin_of(lyapunov)
    safe_set_dev = None if positive else _device_safe_set(lyapunov)
    row, bound, safe = _select_best(lyapunov, candidates, safe_set_dev,
                                    margin)
    if bool(safe):
        return (row.cpu().numpy().astype(config.np_dtype)[None],
                float(bound))

    # Nothing is safe: fall back to the backup policy (zero perturbation
    # around the current policy).
    warnings.warn("No safe state-action pairs found! "
                  "Using backup policy ...", RuntimeWarning)
    safe_actions = lyapunov.policy(safe_states_dev).cpu().numpy()
    zero = np.zeros((1, action_dim), dtype=config.np_dtype)
    state_actions = perturb_actions(safe_states, safe_actions, zero,
                                    limits=limits)
    _, bounds, _ = _evaluate_candidates(lyapunov, state_actions, positive,
                                        margin=_fallback_margin(lyapunov))
    best = int(np.argmax(bounds))
    return state_actions[[best]], float(bounds[best])


def get_safe_sample_batch(lyapunov, true_dynamics, num_steps,
                          perturbations, limits=None, positive=False,
                          num_samples=None, rng=None, noise_key=None,
                          apply=True):
    """Run ``num_steps`` sample, measure and append rounds on the device.

    The k-step form of :func:`get_safe_sample` for learning loops that
    certify only after a round of measurements
    (``safe_learning_tpu/explore.py:600-720``). A host loop of k steps in
    which nothing waits for the device: each step scores its candidates
    (the policy's actions at that step's safe-state subsample, perturbed)
    and their backup rows (zero perturbation) against the GP carried from
    the step before, in one predict; picks the most informative safe
    candidate, or the most informative backup row when none is safe, on
    the device; measures ``true_dynamics`` there; and appends the
    measurement with the working-dtype device append
    (:func:`~safe_learning_tpu_torch.functions.gp._device_border_append`).
    After the loop one copy brings the results to the host, and with
    ``apply`` one float64 ``add_data_point`` refreshes
    ``lyapunov.dynamics``.

    Parameters
    ----------
    lyapunov : Lyapunov
        Its dynamics must be a :class:`~safe_learning_tpu_torch.
        GaussianProcess` or :class:`~safe_learning_tpu_torch.
        StackedGaussianProcess` with room for ``num_steps`` rows.
    true_dynamics : Function
        The measured system, called with the chosen ``(1, n + m)`` pair
        on the device (and ``noise_key=`` when one is given).
    num_steps : int
    perturbations : (p, m) array
        Action perturbations; the backup rows use none, so a zero row is
        not required.
    limits, positive, num_samples, rng
        As in :func:`get_safe_sample`; the subsample is drawn once for all
        steps, ``rng.choice(len(safe), size=(k, num_samples))``, as the
        JAX package draws it.
    noise_key : torch.Generator, optional
        Passed to every measurement as ``noise_key=``; a JAX PRNG key is
        not accepted.
    apply : bool, optional
        Append all measurements to ``lyapunov.dynamics`` before returning.

    Returns
    -------
    state_actions : (k, n + m) ndarray
    measurements : (k, p) ndarray
    bounds : (k,) ndarray
        The summed predictive error at each chosen pair.
    safe_flags : (k,) ndarray of bool
        False where the step used the backup rows (a ``RuntimeWarning``
        says how many).

    A per-grid-point ``certificate_margin`` collapses to its largest value
    (:func:`_margin_of`), as in the JAX package.
    """
    if noise_key is not None and not isinstance(noise_key, torch.Generator):
        raise TypeError("noise_key must be a torch.Generator (JAX PRNG keys "
                        "are not accepted)")
    rng = np.random.default_rng() if rng is None else rng
    grid = lyapunov.discretization
    k = int(num_steps)
    gp = lyapunov.dynamics
    if gp.count + k > gp.capacity:
        raise ValueError(
            "GP capacity {} cannot hold {} more measurements (count {}); "
            "construct the GP with a larger capacity=".format(
                gp.capacity, k, gp.count))
    safe_idx = np.where(lyapunov.safe_set)[0]
    if len(safe_idx) == 0:
        raise RuntimeError(
            "the safe set is empty — no state to explore from (provide "
            "an initial_set or verify with a smaller tau first)")
    all_safe = np.asarray(grid.all_points)[safe_idx]
    if num_samples is not None and len(all_safe) > num_samples:
        picks = rng.choice(len(all_safe), size=(k, int(num_samples)),
                           replace=True)
        states = as_tensor(all_safe[picks])
    else:
        states = as_tensor(all_safe)[None].expand(k, -1, -1)

    # Everything the loop reads is on the device before it starts.
    perturbations = as_tensor(np.atleast_2d(perturbations))
    rows = _sample_steps(
        lyapunov, gp, true_dynamics, states, perturbations,
        None if limits is None else as_tensor(np.atleast_2d(limits)),
        _margin_of(lyapunov),
        None if positive else _device_safe_set(lyapunov), noise_key)

    # One copy to the host for the whole batch.
    out = rows.cpu().numpy()
    width = states.shape[-1] + perturbations.shape[1]
    sas = out[:, :width].astype(config.np_dtype)
    ys = out[:, width:-2].astype(config.np_dtype)
    bounds = out[:, -2]
    safes = out[:, -1] > 0
    if not safes.all():
        warnings.warn("No safe state-action pairs found at {} of {} "
                      "steps! Using backup policy ...".format(
                          int((~safes).sum()), k), RuntimeWarning)
    if apply:
        lyapunov.dynamics = lyapunov.dynamics.add_data_point(sas, ys)
    return sas, ys, bounds, safes


def _sample_steps(lyapunov, gp, true_dynamics, states, perturbations,
                  limits, margin, safe_set_dev, noise_key):
    """The k device steps of :func:`get_safe_sample_batch`, from the
    ``(k, N, d)`` state subsamples on the device to one ``(k, n + m + p +
    2)`` tensor of rows ``(pair, measurement, bound, safe)``.

    Nothing in here waits for the device: every input is on it before
    the first step, the choice between a safe candidate and a backup row
    is a ``torch.where``, and the carried GP advances by
    :func:`_device_border_append`, whose count is a host integer.
    """
    grid = lyapunov.discretization
    policy = lyapunov.policy
    zero = torch.zeros_like(perturbations[:1])
    rows = []
    for states_j in states:
        candidates = _perturb_candidates(policy, states_j, perturbations,
                                         limits)
        n_cand = candidates.shape[0]
        candidates = torch.cat([candidates, _perturb_candidates(
            policy, states_j, zero, limits)])
        mean, bound, safe = _score_candidates(
            gp, lyapunov.lyapunov_function, lyapunov._lipschitz_lyapunov,
            lyapunov.c_max, candidates, margin)
        safe = safe[:n_cand]
        if safe_set_dev is not None:
            safe = safe & safe_set_dev[grid.state_to_index(mean[:n_cand])]
        any_safe = safe.any()
        best = torch.argmax(torch.where(safe, bound[:n_cand],
                                        torch.full_like(bound[:n_cand],
                                                        -np.inf)))
        best_backup = torch.argmax(bound[n_cand:]) + n_cand
        pick = torch.where(any_safe, best, best_backup).reshape(1)
        sa = candidates.index_select(0, pick)
        y = (true_dynamics(sa) if noise_key is None
             else true_dynamics(sa, noise_key=noise_key))
        gp = _device_border_append(gp, sa, y)
        rows.append(torch.cat([sa[0], y.reshape(-1).to(sa.dtype),
                               bound.index_select(0, pick),
                               any_safe.to(sa.dtype).reshape(1)]))
    return torch.stack(rows)


def _host_candidates(lyapunov, safe_states, safe_states_dev, perturbations,
                     actions, limits):
    """The candidate rows as a host matrix, as the JAX package builds them
    for its per-candidate margins (``safe_learning_tpu/explore.py:
    355-375``): every safe state with every action, or the policy's
    actions plus every perturbation through :func:`perturb_actions`
    (clipped and deduplicated with ``limits``)."""
    if perturbations is None:
        acts = np.atleast_2d(np.asarray(actions, dtype=config.np_dtype))
        n, na = len(safe_states), len(acts)
        return np.concatenate([np.repeat(safe_states, na, axis=0),
                               np.tile(acts, (n, 1))], axis=1)
    pol_acts = lyapunov.policy(safe_states_dev).cpu().numpy().astype(
        config.np_dtype)
    return perturb_actions(
        safe_states, pol_acts,
        np.atleast_2d(perturbations).astype(config.np_dtype), limits=limits)


def _per_candidate_margin(lyapunov, candidates):
    """``(N,)`` margins of the exploration level test over the candidate
    rows, or None when the derivation does not apply.

    ``errorbounds.analytic_exploration_margin(per_candidate=True)`` at the
    working dtype's unit: the rows are the model's inputs, so there is no
    construction term. None (the caller then collapses the sweep's margin,
    :func:`_margin_of`) for a sweep margin derived at a finer unit, and
    when the derivation raises ``NotImplementedError``, ``RuntimeError``
    or ``AttributeError``: no model for the instance, TF32 allowed, a
    duck-typed object (``safe_learning_tpu/explore.py:378-406``).
    """
    unit = getattr(lyapunov, "_certificate_margin_unit", None)
    consumer_unit = float(np.finfo(config.np_dtype).eps) / 2.0
    if unit is not None and unit < consumer_unit:
        return None
    try:
        return analytic_exploration_margin(
            lyapunov, candidates=candidates, set_margin=False,
            per_candidate=True)
    except (NotImplementedError, RuntimeError, AttributeError):
        return None


def _margin_of(lyapunov):
    """Conservatism margin of the exploration level test.

    A dedicated ``exploration_margin`` takes precedence; otherwise the
    verification sweep's ``certificate_margin`` is reused (the
    calibrator's measurement covers both pipelines at one scale). A
    per-grid-point margin collapses to its largest value, since
    candidates are not grid points. A margin derived at a finer unit
    roundoff than the working dtype's cannot cover this scorer and
    raises (``safe_learning_tpu/explore.py:409-449``).
    """
    consumer_unit = float(np.finfo(config.np_dtype).eps) / 2.0
    margin = getattr(lyapunov, "exploration_margin", None)
    if margin is not None:
        unit = getattr(lyapunov, "_exploration_margin_unit", None)
        if unit is not None and unit < consumer_unit:
            raise RuntimeError(
                "exploration_margin was derived at unit roundoff "
                f"{unit:.2e}; it cannot cover the plain scorer's rounding "
                f"at unit {consumer_unit:.2e}")
        return float(margin)
    margin = getattr(lyapunov, "certificate_margin", None)
    if margin is None:
        margin = float(config.certificate_margin)
    else:
        unit = getattr(lyapunov, "_certificate_margin_unit", None)
        if unit is not None and unit < consumer_unit:
            raise RuntimeError(
                "certificate_margin was derived at unit roundoff "
                f"{unit:.2e} and cannot cover the plain exploration "
                "scorer")
    return float(np.max(margin)) if np.ndim(margin) else float(margin)


def _fallback_margin(lyapunov):
    """The first margin not tagged below the working dtype's unit
    roundoff, for the backup-policy path (which warns rather than
    certifies, so it must not raise); else ``config.certificate_margin``
    (``safe_learning_tpu/explore.py:452-472``)."""
    consumer_unit = float(np.finfo(config.np_dtype).eps) / 2.0
    for attr, unit_attr in (
            ("exploration_margin", "_exploration_margin_unit"),
            ("certificate_margin", "_certificate_margin_unit")):
        margin = getattr(lyapunov, attr, None)
        if margin is None:
            continue
        unit = getattr(lyapunov, unit_attr, None)
        if unit is None or unit >= consumer_unit:
            return (float(np.max(margin)) if np.ndim(margin)
                    else float(margin))
    return float(config.certificate_margin)


def _device_safe_set(lyapunov):
    """Copy of the boolean safe set on ``config.device``.

    Cached on ``(id, version, mutations)`` of ``Lyapunov.safe_set`` (its
    setter bumps the version; the :class:`~safe_learning_tpu_torch.utils.
    TrackedMask` counts in-place writes), and on the device, so that a
    changed mask is never served stale. An object without the counters
    keys on a digest of the mask's bytes.
    """
    arr = lyapunov.safe_set
    version = getattr(lyapunov, "_safe_set_version", None)
    mut = getattr(arr, "mutations", None)
    key = ((id(arr), version, mut) if version is not None and mut is not None
           else (id(arr), hash(arr.tobytes())))
    key += (config.device,)
    cache = getattr(lyapunov, "_safe_set_dev_cache", None)
    if cache is None or cache[0] != key:
        cache = (key, torch.tensor(np.asarray(arr), device=config.device))
        lyapunov._safe_set_dev_cache = cache
    return cache[1]


def _evaluate_candidates(lyapunov, state_actions, positive, margin=None):
    """Score host candidate rows: ``(mean, bound, inside)`` as host
    arrays, ``inside`` including the membership check unless
    ``positive``."""
    if margin is None:
        margin = _margin_of(lyapunov)
    mean, bound, inside = _score_candidates(
        lyapunov.dynamics, lyapunov.lyapunov_function,
        lyapunov._lipschitz_lyapunov, lyapunov.c_max,
        as_tensor(state_actions), margin)
    inside = inside.cpu().numpy()
    if not positive:
        idx = lyapunov.discretization.state_to_index(mean).cpu().numpy()
        inside &= np.asarray(lyapunov.safe_set)[idx]
    return mean.cpu().numpy(), bound.cpu().numpy(), inside
