"""Lyapunov stability verification on discretized state spaces.

Counterpart of ``safe_learning_tpu/lyapunov.py``: the fused whole-grid
sweep, the streamed sweep, the adaptive sorted sweep, and the region tools
``smallest_boundary_value`` and ``get_lyapunov_region``.

- The fused sweep: the decrease condition for every grid point (policy,
  dynamics, possibly a GP posterior, Lyapunov values, Lipschitz
  threshold) runs on ``config.device`` in one pass, and the certified
  level ``c_max`` comes from O(n) reductions, ``max{v < min v(failing)}``,
  not from a sorted scan.
- The streamed sweep (non-adaptive grids above ``max(batch_size,
  config.fused_sweep_limit)``): one pass over batches of flat
  indices whose states are made on the device
  (:meth:`GridWorld.states_in_range`), keeping the lexicographic minimum
  of ``(value, flat index)`` over the failing states. That is the first
  failing state of the JAX package's stable value sort, so the certified
  set is its sorted prefix, ties at ``v_bad`` included, without a sort.
- The adaptive sweep (``Lyapunov(adaptive=True)``): the grid is sorted by
  value on the device, the coarse check runs over it in one pass (or in
  ``batch_size`` batches), and the failing states after the first failure
  are re-checked in value order on their full ``R^d`` sub-grids at
  ``tau / R``, in chunks of refined points, until the first state that no
  check rescues.

The JAX package's deliberate departures from the TF reference
(``safe_learning_tpu/lyapunov.py:13-26``) hold here too:

- if no state verifies, ``c_max`` is ``-inf``;
- with ``can_shrink=False`` previously safe states are always kept;
- the fused sweep excludes states tied with the smallest failing value;
  the streamed and the sorted sweeps keep those that sort before it (a
  stable sort, as the JAX package's host ``argsort``);
- the refined check evaluates the dynamics at the sub-grid points, with
  per-sub-point thresholds, always at the maximum refinement ``R``.

A ``Triangulation`` candidate defined on the verification grid gives its
vertex values directly, as the JAX package reads them
(``safe_learning_tpu/lyapunov.py:667-683``).

Not ported yet (ROADMAP queue 1): the extended and hybrid sweeps (item
18) and meshes (item 23).
"""

from __future__ import annotations

import heapq
import itertools
import warnings

import numpy as np
import torch

from .config import config
from .functions.base import Function, as_deterministic, as_tensor
from .functions.simplex import Triangulation
from .grids import GridWorld
from .utils import tracked_mask

__all__ = ["Lyapunov", "smallest_boundary_value",
           "get_lyapunov_region"]

#: Refined points per chunk of the adaptive sweep's refinement walk (one
#: dynamics evaluation, and one GP kernel launch, a chunk). The result
#: does not depend on it.
REFINED_POINTS_PER_CHUNK = 2 ** 20


def _as_lipschitz(lip):
    """Normalize a Lipschitz spec: a scalar stays a scalar, a callable
    becomes a Function."""
    if lip is None:
        return None
    if callable(lip) or isinstance(lip, Function):
        return as_deterministic(lip)
    return float(lip)


def _eval_lipschitz(lip, states):
    if isinstance(lip, Function) or callable(lip):
        return lip(states)
    return lip


def _as_column_batch(lv):
    """Normalize a local-Lipschitz evaluation to a per-state column.

    ``(N,)`` means one constant per state and becomes ``(N, 1)``; a scalar
    stays a number and broadcasts."""
    if not torch.is_tensor(lv):
        if np.ndim(lv) == 0:
            return float(lv)
        lv = as_tensor(lv)
    if lv.ndim == 1:
        return lv.reshape(-1, 1)
    if lv.ndim == 0:
        return lv.reshape(1, 1)
    return lv


def _lv_threshold_term(lipschitz_lyapunov, states):
    """L_v factor of the threshold; vector-valued constants are reduced
    with the L1 norm."""
    lv = _eval_lipschitz(lipschitz_lyapunov, states)
    if isinstance(lipschitz_lyapunov, Function) or callable(
            lipschitz_lyapunov):
        lv = _as_column_batch(lv)
        if torch.is_tensor(lv) and lv.shape[1] > 1:
            lv = lv.abs().sum(dim=1, keepdim=True)
    return lv


def _threshold(lipschitz_lyapunov, lipschitz_dynamics, states, tau):
    """``-L_v (1 + L_f) tau``."""
    lv = _lv_threshold_term(lipschitz_lyapunov, states)
    lf = _eval_lipschitz(lipschitz_dynamics, states)
    return -lv * (1.0 + lf) * tau


def _confidence_bound(lipschitz_lyapunov, next_states):
    """Split ``(mean, error)`` dynamics output into ``(mean, L_v error)``."""
    if isinstance(next_states, (tuple, list)):
        next_states, error = next_states
        lv = _as_column_batch(_eval_lipschitz(lipschitz_lyapunov,
                                              next_states))
        return next_states, (lv * error).sum(dim=1, keepdim=True)
    return next_states, 0.0


def _decrease_bound(lyapunov_function, lipschitz_lyapunov, states,
                    next_states):
    """Upper confidence bound on ``v(f(x)) - v(x)``."""
    next_states, bound = _confidence_bound(lipschitz_lyapunov, next_states)
    v_decrease = (lyapunov_function(next_states).reshape(-1, 1)
                  - lyapunov_function(states).reshape(-1, 1))
    return v_decrease + bound


def _margin_operand(margin, like):
    """A scalar margin stays a number; a per-point ``(N,)`` margin (an
    array or a tensor) becomes an ``(N, 1)`` column in ``like``'s dtype
    and device."""
    if np.ndim(margin) == 0:
        return float(margin)
    if not torch.is_tensor(margin):
        margin = torch.as_tensor(np.asarray(margin))
    return margin.to(device=like.device, dtype=like.dtype).reshape(-1, 1)


def _negative_batch(policy, dynamics, lyapunov_function, lipschitz_lyapunov,
                    lipschitz_dynamics, tau, states, margin=0.0):
    """Decrease-condition check for one batch of states.

    Computes ``v(f(x, pi(x))) - v(x) + L_v sigma < -L_v (1 + L_f) tau -
    margin``. Returns ``(negative, decrease, threshold)``, each ``(N,)``.
    """
    actions = policy(states)
    next_states = dynamics(states, actions)
    decrease = _decrease_bound(lyapunov_function, lipschitz_lyapunov,
                               states, next_states)
    threshold = _threshold(lipschitz_lyapunov, lipschitz_dynamics, states,
                           tau)
    negative = (decrease < threshold
                - _margin_operand(margin, decrease)).squeeze(1)
    return (negative, decrease.squeeze(1),
            torch.as_tensor(threshold, dtype=decrease.dtype,
                            device=decrease.device)
            .broadcast_to(decrease.shape).squeeze(1))


def refinement_offsets(unit_maxes, max_refinement, like):
    """``(R^d, d)`` offsets of a cell's ``R^d`` sub-grid from its centre,
    ``0.5 (1 - 1/R) unit_maxes (-1 + 2 j / (R - 1))`` for ``j`` in
    ``0..R-1`` per dimension (all zero for ``R = 1``), in ``like``'s
    dtype and device; the order is ``safe_learning_tpu/lyapunov.py:
    204-211``'s."""
    r = int(max_refinement)
    d = len(unit_maxes)
    combos = np.stack(np.meshgrid(*[np.arange(r)] * d, indexing="ij"),
                      axis=-1).reshape(-1, d).astype(np.float64)
    unit = (-1.0 + 2.0 * combos / (r - 1.0) if r > 1
            else np.zeros_like(combos))
    unit = torch.as_tensor(unit, dtype=like.dtype, device=like.device)
    maxes = torch.as_tensor(np.asarray(unit_maxes), dtype=like.dtype,
                            device=like.device)
    return ((0.5 * (1.0 - 1.0 / r)) * maxes) * unit


def _refined_negative_batch(policy, dynamics, lyapunov_function,
                            lipschitz_lyapunov, lipschitz_dynamics, tau,
                            states, offsets, max_refinement, margin=0.0):
    """Decrease check of each state's full ``R^d`` sub-grid at ``tau / R``.

    ``offsets`` are :func:`refinement_offsets`. The dynamics, the local
    Lipschitz constants and the threshold are evaluated at every sub-grid
    point (``safe_learning_tpu/lyapunov.py:177-226``); a per-state
    ``(N,)`` margin applies to all its sub-points. Returns ``(N,)``: every
    sub-point passes.
    """
    r = int(max_refinement)
    n, d = states.shape
    flat = (states[:, None, :] + offsets[None, :, :]).reshape(-1, d)
    actions = policy(flat)
    decrease = _decrease_bound(lyapunov_function, lipschitz_lyapunov, flat,
                               dynamics(flat, actions))
    threshold = _threshold(lipschitz_lyapunov, lipschitz_dynamics, flat,
                           tau / r)
    m = _margin_operand(margin, decrease)
    if not isinstance(m, float):
        m = m.repeat_interleave(offsets.shape[0], dim=0)
    ok = decrease < threshold - m
    return ok.reshape(n, -1).all(dim=1)


def _values_batch(fun, points):
    """Evaluate a scalar function on a batch of points, flattened."""
    return fun(points).reshape(-1)


def _fused_update(policy, dynamics, lyapunov_function, lipschitz_lyapunov,
                  lipschitz_dynamics, tau, points, exempt, margin=0.0,
                  level_margin=0.0, values_direct=None):
    """Whole-grid safe-set update in one pass on the points' device.

    Computes ``v`` on the grid, runs the decrease check for every point
    and finds the certified level with O(n) reductions: the level-set
    prefix in value order is unbroken exactly up to the smallest value
    among failing states, so ``c_max = max{v(x) : v(x) < min v(failing)}``.
    States tied with the smallest failing value are excluded.
    ``values_direct`` are the grid values when the caller has them (a
    ``Triangulation`` candidate on this grid); ``v(f(x))`` still goes
    through the candidate.

    Returns ``(safe_set, c_max, values, any_safe)`` as tensors.
    """
    if values_direct is not None:
        values = values_direct.reshape(-1)
    else:
        values = lyapunov_function(points).reshape(-1)
    actions = policy(points)
    next_states, bound = _confidence_bound(lipschitz_lyapunov,
                                           dynamics(points, actions))
    decrease = (lyapunov_function(next_states).reshape(-1, 1)
                - values.reshape(-1, 1) + bound)
    threshold = _threshold(lipschitz_lyapunov, lipschitz_dynamics, points,
                           tau)
    negative = (decrease < threshold
                - _margin_operand(margin, decrease)).squeeze(1)
    eligible = negative | exempt

    inf = torch.tensor(float("inf"), dtype=values.dtype,
                       device=values.device)
    v_bad = torch.where(eligible, inf, values).min()
    # level_margin guards the value comparison as margin guards the
    # decrease comparison (see oracle.calibrate_certificate_margin).
    safe_set = values < v_bad - level_margin
    any_safe = safe_set.any()
    c_max = torch.where(any_safe,
                        torch.where(safe_set, values, -inf).max(), -inf)
    return safe_set, c_max, values, any_safe


class Lyapunov:
    """A Lyapunov function certificate over a discretized domain.

    Parameters are those of ``safe_learning_tpu.Lyapunov``:

    Parameters
    ----------
    discretization : GridWorld
    lyapunov_function : Function or callable
        The candidate ``v(x)``.
    dynamics : Function or callable
        Closed-form or uncertain dynamics; uncertain dynamics return
        ``(mean, error_bound)`` tuples.
    lipschitz_dynamics : float or callable
        Closed-loop Lipschitz constant of the dynamics.
    lipschitz_lyapunov : float or callable
        Lipschitz constant of ``v`` (global or local).
    tau : float
        Discretization constant.
    policy : Function or callable
    initial_set : ndarray or index list, optional
        States known to be safe a priori.
    adaptive : bool, optional
        Enable adaptive refinement in :meth:`update_safe_set`.
    mesh : optional
        Must be None: meshes are not ported yet.
    certificate_margin : float, optional
        Absolute conservatism margin of the decrease check; ``None`` reads
        ``config.certificate_margin`` at each sweep.
    """

    def __init__(self, discretization, lyapunov_function, dynamics,
                 lipschitz_dynamics, lipschitz_lyapunov, tau, policy,
                 initial_set=None, adaptive=False, mesh=None,
                 certificate_margin=None):
        if not isinstance(discretization, GridWorld):
            raise TypeError("discretization must be a GridWorld")
        if mesh is not None:
            raise NotImplementedError(
                "meshes are ROADMAP queue 1 item 23 (parallel)")
        self.discretization = discretization
        self.mesh = None
        self.adaptive = bool(adaptive)
        #: The last adaptive sweep's work: coarse batches, refinement
        #: chunks and refined states (diagnostics; ``None`` before one).
        self.last_sweep_counts = None
        self.policy = as_deterministic(policy)
        self.dynamics = dynamics if isinstance(dynamics, Function) \
            else as_deterministic(dynamics)
        self.lyapunov_function = as_deterministic(lyapunov_function)
        self.tau = float(tau)
        self.certificate_margin = certificate_margin
        self._level_margin = None
        #: Unit roundoff the installed margin was derived at (None: an
        #: empirical or manual margin).
        self._certificate_margin_unit = None

        self._lipschitz_dynamics = _as_lipschitz(lipschitz_dynamics)
        self._lipschitz_lyapunov = _as_lipschitz(lipschitz_lyapunov)

        nindex = discretization.nindex
        self._safe_set_version = 0
        self._initial_set_version = 0
        self.safe_set = np.zeros(nindex, dtype=bool)
        self.initial_safe_set = None
        if initial_set is not None:
            mask = np.zeros(nindex, dtype=bool)
            mask[np.asarray(initial_set)] = True
            self.initial_safe_set = mask
            self.safe_set |= mask

        self.c_max = 0.0
        self.values = None
        self._refinement = np.zeros(nindex, dtype=int)
        if self.initial_safe_set is not None:
            self._refinement[self.initial_safe_set] = 1
        self.update_values()

    # ------------------------------------------------------------------
    @property
    def safe_set(self):
        """Boolean mask of certified-safe grid states (host
        :class:`~safe_learning_tpu_torch.utils.TrackedMask`)."""
        return self._safe_set

    @safe_set.setter
    def safe_set(self, value):
        """Set the safe set and bump its version counter."""
        self._safe_set = tracked_mask(value)
        self._safe_set_version += 1

    @property
    def initial_safe_set(self):
        """States safe a priori (exempt from the decrease check)."""
        return self._initial_safe_set

    @initial_safe_set.setter
    def initial_safe_set(self, value):
        """Set the initial set and bump its version counter."""
        self._initial_safe_set = (None if value is None
                                  else tracked_mask(value))
        self._initial_set_version += 1

    @property
    def certificate_margin(self):
        """Active conservatism margin of the decrease check.

        The per-instance value when one was set, else
        ``config.certificate_margin``. A scalar, or a per-grid-point
        ``(nindex,)`` array.
        """
        if self._certificate_margin is not None:
            return self._certificate_margin
        return float(config.certificate_margin)

    @certificate_margin.setter
    def certificate_margin(self, value):
        """Set (or with ``None`` clear) the per-instance margin."""
        if value is None:
            self._certificate_margin = None
        elif np.ndim(value):
            arr = np.asarray(value, dtype=np.float64)
            if arr.shape != (self.discretization.nindex,):
                raise ValueError(
                    "per-point certificate_margin must be a "
                    "(nindex,) array in grid order")
            self._certificate_margin = arr
        else:
            self._certificate_margin = float(value)
        self._certificate_margin_unit = None

    @property
    def level_margin(self):
        """Conservatism margin of the level comparison ``v < v_bad``."""
        if self._level_margin is not None:
            return self._level_margin
        return float(config.level_margin)

    @level_margin.setter
    def level_margin(self, value):
        """Set (or with ``None`` clear) the per-instance level margin."""
        self._level_margin = None if value is None else float(value)

    def _require_f32_margin(self):
        """Refuse a margin derived at a finer unit roundoff than the
        sweep's working dtype (it could not cover the sweep's rounding)."""
        unit = self._certificate_margin_unit
        consumer = float(torch.finfo(config.dtype).eps) / 2
        if unit is not None and unit < consumer:
            raise RuntimeError(
                "certificate_margin was derived at unit roundoff "
                f"{unit:.2e}; it cannot cover the plain sweep's rounding "
                f"at unit {consumer:.2e}")

    def lipschitz_dynamics(self, states):
        """Global or local Lipschitz constant of the dynamics at
        ``states``."""
        return _eval_lipschitz(self._lipschitz_dynamics, states)

    def lipschitz_lyapunov(self, states):
        """Global or local Lipschitz constant of ``v`` at ``states``."""
        return _eval_lipschitz(self._lipschitz_lyapunov, states)

    def threshold(self, states, tau=None):
        """Safety threshold ``-L_v (1 + L_f) tau``."""
        tau = self.tau if tau is None else tau
        return _threshold(self._lipschitz_lyapunov,
                          self._lipschitz_dynamics, as_tensor(states), tau)

    def is_safe(self, state):
        """Whether states lie in the current safe set."""
        idx = self.discretization.state_to_index(state).cpu().numpy()
        return self.safe_set[idx]

    def v_decrease_confidence(self, states, next_states):
        """``(v(f(x)) - v(x), L_v error)``, each ``(N, 1)``; the error
        term is 0 for deterministic dynamics (a ``(mean, error)`` tuple
        gives uncertain ones)."""
        if isinstance(next_states, (tuple, list)):
            next_states, error = next_states
            lv = _as_column_batch(self.lipschitz_lyapunov(next_states))
            bound = (lv * error).sum(dim=1, keepdim=True)
        else:
            bound = torch.zeros((), dtype=config.dtype,
                                device=config.device)
        v_decrease = (self.lyapunov_function(next_states).reshape(-1, 1)
                      - self.lyapunov_function(states).reshape(-1, 1))
        return v_decrease, bound

    def v_decrease_bound(self, states, next_states):
        """Upper bound on the decrease ``v(f(x)) - v(x)``."""
        v_dot, error = self.v_decrease_confidence(states, next_states)
        return v_dot + error

    def safety_constraint(self, policy, include_initial=True):
        """Whether each grid state passes the decrease check under
        ``policy``'s actions (host boolean array); with
        ``include_initial`` the initial set counts as passing."""
        points = self._device_points()
        actions = as_deterministic(policy)(points)
        prediction = self.dynamics(points, actions)
        bound = self.v_decrease_bound(points, prediction)
        negative = (bound < self.threshold(points)).squeeze(1).cpu().numpy()
        if include_initial and self.initial_safe_set is not None:
            negative |= self.initial_safe_set
        return np.asarray(negative)

    def _device_points(self):
        """Copy of the grid on ``config.device``, cached per device and
        dtype."""
        pts = getattr(self, "_points_dev", None)
        if (pts is None or pts.device != config.device
                or pts.dtype != config.dtype):
            pts = as_tensor(self.discretization.all_points)
            self._points_dev = pts
        return pts

    def _fused_limit(self, batch_size):
        batch = batch_size or max(int(config.gp_batch_size), 1)
        return max(batch, int(config.fused_sweep_limit))

    def _direct_grid_values(self):
        """Vertex values of a ``Triangulation`` candidate defined on this
        grid (``v(grid)`` is exactly its parameters), flattened; ``None``
        for every other candidate."""
        lf = self.lyapunov_function
        if (isinstance(lf, Triangulation) and lf.output_dim == 1
                and lf.discretization == self.discretization):
            return lf.parameters.reshape(-1)
        return None

    def update_values(self, batch_size=None):
        """Re-evaluate ``v`` on the whole grid (kept on the device).

        One pass over the grid up to ``config.fused_sweep_limit``;
        larger grids, or any ``batch_size``, stream: batches of
        ``batch_size`` (default ``config.gp_batch_size``) states made on
        the device, written into one device buffer.
        """
        direct = self._direct_grid_values()
        if direct is not None:
            self.values = direct
            return
        grid = self.discretization
        nindex = grid.nindex
        if batch_size is None and nindex <= self._fused_limit(None):
            self.values = _values_batch(self.lyapunov_function,
                                        self._device_points())
            return
        batch = batch_size or max(int(config.gp_batch_size), 1)
        values = None
        for start in range(0, nindex, batch):
            stop = min(start + batch, nindex)
            v = _values_batch(self.lyapunov_function,
                              grid.states_in_range(start, stop))
            if values is None:
                values = torch.empty(nindex, dtype=v.dtype, device=v.device)
            values[start:stop] = v
        self.values = values

    def update_safe_set(self, can_shrink=True, max_refinement=1,
                        safety_factor=1.0, parallel_iterations=None,
                        batch_size=None, extended=False):
        """Compute the largest certified level set and update ``safe_set``.

        A non-adaptive instance runs the fused whole-grid sweep
        (:func:`_fused_update`) and ignores ``max_refinement``, as the JAX
        package does. An adaptive one runs the sorted sweep
        (:meth:`_update_safe_set_adaptive`): the coarse check in batches
        of ``batch_size`` (default: the whole grid up to
        ``config.fused_sweep_limit``), then the refinement walk at
        ``max_refinement``. ``parallel_iterations`` and ``safety_factor``
        are accepted for API compatibility and have no effect (a
        non-default value warns). A non-adaptive grid above ``max(batch,
        config.fused_sweep_limit)``, ``batch`` being ``batch_size`` or
        ``config.gp_batch_size``, runs the streamed sweep
        (:meth:`_update_safe_set_streamed`). ``extended`` sweeps are not
        ported yet and raise ``NotImplementedError``.
        """
        if safety_factor != 1.0 or parallel_iterations is not None:
            warnings.warn(
                "safety_factor/parallel_iterations are accepted for "
                "reference-API compatibility but have no effect",
                RuntimeWarning, stacklevel=2)
        if extended not in (False, True, "hybrid"):
            raise ValueError(
                "extended must be False, True, or 'hybrid'; got "
                f"{extended!r}")
        if extended:
            raise NotImplementedError(
                "the extended and hybrid sweeps are ROADMAP queue 1 "
                "item 18")
        self._require_f32_margin()
        if self.adaptive:
            self._update_safe_set_adaptive(can_shrink, int(max_refinement),
                                           batch_size)
            return
        if self.discretization.nindex > self._fused_limit(batch_size):
            self._update_safe_set_streamed(can_shrink, batch_size)
            return
        self._update_safe_set_fused(can_shrink)

    def _exempt_and_previous(self, can_shrink):
        """``(initial, prev_safe, exempt)`` host masks: the initial set
        (all False without one), the safe set before the sweep, and the
        states that pass without the decrease check (the initial set, and
        the previous safe set when ``can_shrink`` is False)."""
        nindex = self.discretization.nindex
        initial = (self.initial_safe_set
                   if self.initial_safe_set is not None
                   else np.zeros(nindex, dtype=bool))
        # Plain copies: TrackedMask.copy() shares the counter.
        prev_safe = np.array(self.safe_set)
        exempt = np.array(initial)
        if not can_shrink:
            exempt |= prev_safe
        return initial, prev_safe, exempt

    def _store(self, safe, refinement, can_shrink, initial, prev_safe):
        """Install a sweep's host safe mask and refinement levels, with the
        previous safe set kept (``can_shrink=False``) and the initial set
        added, each at a refinement of at least 1."""
        if not can_shrink:
            safe |= prev_safe
            keep = prev_safe & (refinement == 0)
            refinement[keep] = np.maximum(self._refinement[keep], 1)
        if self.initial_safe_set is not None:
            safe |= initial
            refinement[initial] = np.maximum(refinement[initial], 1)
        self.safe_set = safe
        self._refinement = refinement

    def _update_safe_set_streamed(self, can_shrink, batch_size):
        """The streamed sweep: one pass over batches of flat indices.

        ``safe_learning_tpu/lyapunov.py:1035-1275`` without the adaptive,
        mesh, extended and hybrid branches, and without its host
        ``argsort``:

        1. ``values`` is refreshed batch by batch into one device buffer
           (:meth:`update_values`);
        2. each batch of ``batch_size`` (default ``config.gp_batch_size``)
           states, made on the device, runs the decrease check
           (:func:`_negative_batch`); a state that neither passes nor is
           exempt fails. The pass keeps, on the device, the smallest
           ``(value, flat index)`` over failing states in lexicographic
           order, ``(v_bad, i_bad)``: the first failing state of the JAX
           package's stable value sort. The host waits for the device
           nowhere inside the loop;
        3. the certified set is that sort's prefix before ``(v_bad,
           i_bad)``: ``v < v_bad``, and ``v == v_bad`` at indices below
           ``i_bad``; with a ``level_margin`` it is ``v < v_bad -
           level_margin`` (the JAX package's trim). ``c_max`` is the
           largest value in it, ``-inf`` when it is empty. States with a
           NaN value are never certified.

        A per-point ``certificate_margin`` is sliced per batch. The last
        sweep's batches are in ``last_sweep_counts``.
        """
        grid = self.discretization
        nindex = grid.nindex
        batch = batch_size or max(int(config.gp_batch_size), 1)
        initial, prev_safe, exempt = self._exempt_and_previous(can_shrink)
        self.update_values(batch_size=batch)
        values = self.values
        device = values.device
        exempt_dev = torch.as_tensor(exempt, device=device)
        margin = self.certificate_margin
        inf = torch.full((), float("inf"), dtype=values.dtype, device=device)
        v_bad = inf
        i_bad = torch.full((), nindex, dtype=torch.int64, device=device)
        batches = 0
        for start in range(0, nindex, batch):
            stop = min(start + batch, nindex)
            negative = _negative_batch(
                self.policy, self.dynamics, self.lyapunov_function,
                self._lipschitz_lyapunov, self._lipschitz_dynamics, self.tau,
                grid.states_in_range(start, stop, device),
                margin if np.ndim(margin) == 0 else margin[start:stop])[0]
            v = values[start:stop]
            failing = ~(negative | exempt_dev[start:stop]) & ~torch.isnan(v)
            v_min = torch.where(failing, v, inf).min()
            first = (failing & (v == v_min)).to(torch.uint8).argmax()
            i_min = torch.where(failing.any(), first + start, nindex)
            better = (v_min < v_bad) | ((v_min == v_bad) & (i_min < i_bad))
            v_bad = torch.where(better, v_min, v_bad)
            i_bad = torch.where(better, i_min, i_bad)
            batches += 1
        self.last_sweep_counts = dict(coarse_batches=batches,
                                      refinement_chunks=0, refined_points=0,
                                      rescued_states=0)

        level_margin = self.level_margin
        if level_margin > 0.0:
            safe_dev = values < v_bad - level_margin
        else:
            safe_dev = values < v_bad
            head = int(i_bad)
            safe_dev[:head] |= values[:head] == v_bad
        c_max = torch.where(safe_dev, values, -inf).max()
        safe = safe_dev.cpu().numpy()
        self.c_max = float(c_max) if safe.any() else -np.inf
        self._store(safe, np.where(safe, 1, 0), can_shrink, initial,
                    prev_safe)

    def _update_safe_set_adaptive(self, can_shrink, max_refinement,
                                  batch_size):
        """The sorted sweep with adaptive refinement, on the device.

        ``safe_learning_tpu/lyapunov.py:1040-1275`` without the mesh,
        extended and hybrid branches:

        1. ``values`` is refreshed and sorted by value with a stable sort
           (ties keep grid order, as the JAX package's host ``argsort``);
        2. the coarse check runs over the sorted grid, in batches of
           ``batch_size`` states (default: all of it up to
           ``config.fused_sweep_limit``); a state passes it, or is
           exempt;
        3. the states that fail it are re-checked in value order on their
           full ``R^d`` sub-grids at ``tau / R``
           (:func:`_refined_negative_batch`), in chunks of about
           ``REFINED_POINTS_PER_CHUNK`` refined points, one host read a
           chunk; the walk stops at the first state no check rescues;
        4. the certified prefix ends before that state, trimmed by
           ``level_margin``; ``_refinement`` is 1 for a coarse pass or an
           exempt state, ``R`` for a refined rescue.

        The result does not depend on the batch or the chunk size. A
        per-point ``certificate_margin`` rides along in value order.
        """
        grid = self.discretization
        nindex = grid.nindex
        points = self._device_points()
        device = points.device
        r = max(int(max_refinement), 1)
        initial, prev_safe, exempt = self._exempt_and_previous(can_shrink)

        self.update_values()
        values = self.values
        order = torch.sort(values, stable=True).indices
        sorted_values = values[order]
        exempt_sorted = torch.as_tensor(exempt, device=device)[order]
        margin = self.certificate_margin
        if np.ndim(margin):
            margin = torch.as_tensor(margin, dtype=points.dtype,
                                     device=device)[order]

        def margin_at(index):
            return margin if isinstance(margin, float) else margin[index]

        # 2. The coarse check, batch by batch, into one sorted mask.
        batch = batch_size or max(int(config.gp_batch_size),
                                  min(nindex, self._fused_limit(None)))
        passed = torch.empty(nindex, dtype=torch.bool, device=device)
        batches = 0
        for start in range(0, nindex, batch):
            idx = order[start:start + batch]
            passed[start:start + len(idx)] = _negative_batch(
                self.policy, self.dynamics, self.lyapunov_function,
                self._lipschitz_lyapunov, self._lipschitz_dynamics,
                self.tau, points[idx],
                margin_at(slice(start, start + len(idx))))[0]
            batches += 1
        passed |= exempt_sorted

        # 3. The refinement walk over the failing states in value order.
        failing = torch.nonzero(~passed).reshape(-1)
        n_fail = int(failing.shape[0])
        stop = nindex if n_fail == 0 else None
        chunks = refined_points = rescued = 0
        if n_fail and r > 1:
            offsets = refinement_offsets(grid.unit_maxes, r, points)
            chunk = max(1, REFINED_POINTS_PER_CHUNK // offsets.shape[0])
            for start in range(0, n_fail, chunk):
                pos = failing[start:start + chunk]
                ok = _refined_negative_batch(
                    self.policy, self.dynamics, self.lyapunov_function,
                    self._lipschitz_lyapunov, self._lipschitz_dynamics,
                    self.tau, points[order[pos]], offsets, r,
                    margin_at(pos))
                chunks += 1
                refined_points += len(pos) * offsets.shape[0]
                # One read a chunk: whether every state passed, the first
                # that did not, and its sorted position.
                first = (~ok).long().argmax().reshape(1)
                all_ok, first_bad, bad_pos = torch.cat(
                    [ok.all().long().reshape(1), first,
                     pos.gather(0, first)]).tolist()
                if not all_ok:
                    rescued += first_bad
                    stop = bad_pos
                    break
                rescued += len(pos)
            else:
                stop = nindex
        elif n_fail:
            stop = int(failing[0])
        self.last_sweep_counts = dict(coarse_batches=batches,
                                      refinement_chunks=chunks,
                                      refined_points=refined_points,
                                      rescued_states=rescued)

        # 4. The prefix, trimmed by the level margin.
        max_index = stop - 1
        level_margin = self.level_margin
        if level_margin > 0.0 and 0 <= max_index < nindex - 1:
            trimmed = int(torch.searchsorted(
                sorted_values, sorted_values[stop:stop + 1] - level_margin,
                side="left")) - 1
            max_index = min(max_index, trimmed)
        self.c_max = (float(sorted_values[max_index]) if max_index >= 0
                      else -np.inf)

        rank = torch.arange(nindex, device=device)
        in_prefix = rank <= max_index
        ref_sorted = torch.where(passed, 1, torch.where(rank < stop, r, 0))
        ref_sorted = torch.where(in_prefix, ref_sorted, 0)
        safe_dev = torch.empty(nindex, dtype=torch.bool, device=device)
        safe_dev[order] = in_prefix
        ref_dev = torch.empty(nindex, dtype=ref_sorted.dtype, device=device)
        ref_dev[order] = ref_sorted
        safe = safe_dev.cpu().numpy()
        refinement = ref_dev.cpu().numpy().astype(int)
        self._store(safe, refinement, can_shrink, initial, prev_safe)

    def _update_safe_set_fused(self, can_shrink):
        """Whole-grid single-pass path."""
        initial, prev_safe, exempt = self._exempt_and_previous(can_shrink)
        points = self._device_points()
        # With can_shrink the exempt mask is just the initial set; keep
        # its device copy until that mask changes.
        key = (id(self.initial_safe_set), self._initial_set_version,
               getattr(self.initial_safe_set, "mutations", None),
               points.device)
        exempt_dev = (getattr(self, "_exempt_dev", None)
                      if can_shrink and getattr(self, "_exempt_key",
                                                None) == key
                      else None)
        if exempt_dev is None:
            exempt_dev = torch.as_tensor(exempt, device=points.device)
            if can_shrink:
                self._exempt_dev = exempt_dev
                self._exempt_key = key

        safe_dev, c_max, values, _ = _fused_update(
            self.policy, self.dynamics, self.lyapunov_function,
            self._lipschitz_lyapunov, self._lipschitz_dynamics, self.tau,
            points, exempt_dev, self.certificate_margin, self.level_margin,
            self._direct_grid_values())

        # Values stay on the device; c_max is -inf when nothing verifies.
        self.values = values
        safe = safe_dev.cpu().numpy()
        self.c_max = float(c_max)
        self._store(safe, np.where(safe, 1, 0), can_shrink, initial,
                    prev_safe)


def smallest_boundary_value(fun, discretization):
    """Smallest value of ``fun`` on the boundary of the discretization.

    ``safe_learning_tpu/lyapunov.py:1366-1379``: the points of each pair
    of opposite faces are evaluated on ``config.device``, and the minima
    are taken on the host.
    """
    fun = as_deterministic(fun)
    min_value = np.inf
    for i in range(discretization.ndim):
        axes = list(discretization.discrete_points)
        axes[i] = axes[i][[0, -1]]
        mesh = np.meshgrid(*axes, indexing="ij")
        points = np.column_stack([col.ravel() for col in mesh])
        smallest = float(fun(as_tensor(points)).min())
        min_value = min(min_value, smallest)
    return min_value


def get_lyapunov_region(lyapunov, discretization, init_node,
                        use_native=None):
    """Region on which a function grows monotonically away from a node.

    ``safe_learning_tpu/lyapunov.py:1382-1448``: a flood fill from
    ``init_node`` (a grid multi-index) over the grid's neighbours in
    increasing-value order, with a heap, that stops at the domain boundary
    or at the first value below the last one expanded; the nodes expanded
    form the region. The values are evaluated on ``config.device`` at
    states made there (:meth:`GridWorld.states_in_range`); the heap runs on
    the host, in the package's C++ flood fill (:mod:`.native`) or in
    Python. ``use_native``: ``None`` takes the C++ one when it builds,
    ``True`` raises when it cannot, ``False`` takes Python. Returns a
    boolean array of the grid's shape.
    """
    fun = as_deterministic(lyapunov)
    states = discretization.states_in_range(0, discretization.nindex)
    values = fun(states).detach().cpu().numpy()
    lyapunov_values = values.reshape(discretization.shape)

    if use_native is None or use_native:
        from .native import flood_fill

        flat_init = int(np.ravel_multi_index(tuple(init_node),
                                             discretization.shape))
        native = flood_fill(lyapunov_values, discretization.shape,
                            flat_init)
        if native is not None:
            return native
        if use_native:
            raise RuntimeError("the native flood fill did not build")

    init_node = tuple(init_node)
    init_value = lyapunov_values[init_node]
    ndim = discretization.ndim
    num_points = np.asarray(discretization.shape)

    neighbor_offsets = np.array(
        list(itertools.product(*[(0, -1, 1)] * ndim))[1:])

    visited = np.zeros(discretization.shape, dtype=bool)
    visited[init_node] = True

    tiebreaker = itertools.count()
    last_value = init_value
    priority_queue = [(init_value, next(tiebreaker), np.asarray(init_node))]

    while priority_queue:
        value, _, node = heapq.heappop(priority_queue)
        if np.any(node == 0) or np.any(node == num_points - 1):
            visited[tuple(node)] = False
            break
        if value < last_value:
            break
        last_value = value

        neighbors = node + neighbor_offsets
        keys = tuple(neighbors.T)
        is_new = ~visited[keys]
        neighbors = neighbors[is_new]
        if neighbors.size:
            keys = tuple(neighbors.T)
            visited[keys] = True
            for val, neighbor in zip(lyapunov_values[keys], neighbors):
                heapq.heappush(priority_queue,
                               (val, next(tiebreaker), neighbor))

    for _, _, node in priority_queue:
        visited[tuple(node)] = False

    return visited
