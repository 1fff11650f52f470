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

The rigor modes (``update_safe_set(extended=True)`` and ``"hybrid"``) run
the decrease check in float64 on the card (``ops.extended_verify``) in
each of these structures but the fused one, which they skip as the JAX
package does: a non-adaptive grid up to the fused limit takes the sorted
sweep without refinement. The hybrid mode checks in float32 first and
re-checks in float64 only the states within the band of their derived
margins (:class:`_DecreaseCheck`).

Each sweep also runs over a mesh (``Lyapunov(mesh=...)``, ``parallel``):
the grid's rows are split into contiguous ranges, one per entry of this
process, and across processes each rank runs its own (``parallel.
distributed``). The host logic is replicated on every rank and the device
work sharded: the fused sweep combines its two reductions (``v_bad``, then
``c_max``) over the shards; the streamed sweep gives each entry a
contiguous run of its batches and combines the lexicographic minimum
``(v_bad, i_bad)``; the sorted sweep sorts the gathered values on every
rank and splits each coarse batch and refinement chunk over the entries.
Every rank ends with the same ``safe_set``, ``c_max``, ``values`` and
refinement levels, bit for bit those of the sweep without a mesh.
"""

from __future__ import annotations

import heapq
import itertools
import math
import warnings

import numpy as np
import torch

from . import profiling
from .config import config
from .functions.base import Function, as_deterministic, as_tensor
from .functions.simplex import Triangulation
from .grids import GridWorld
from .parallel.distributed import (gather_rows, global_grid_points,
                                   put_global, reduce_scalars)
from .parallel.mesh import Mesh, ShardedArray, grid_sharding, split_rows
from .utils import TrackedMask, tracked_mask

__all__ = ["Lyapunov", "smallest_boundary_value",
           "get_lyapunov_region"]

#: Refined points per chunk of the adaptive sweep's refinement walk (one
#: dynamics evaluation, and one GP kernel launch, a chunk). The result
#: does not depend on it.
REFINED_POINTS_PER_CHUNK = 2 ** 20

#: The widths of refinement levels, narrowest first: ``(numpy, torch)``.
_LEVEL_DTYPES = ((np.uint8, torch.uint8), (np.int16, torch.int16),
                 (np.int32, torch.int32), (np.int64, torch.int64))


def level_dtypes(max_level):
    """``(numpy, torch)`` dtypes of refinement levels up to ``max_level``:
    one byte a state up to 255 (every refinement the repo runs), else the
    narrowest signed width that holds it."""
    return next(pair for pair in _LEVEL_DTYPES
                if max_level <= np.iinfo(pair[0]).max)


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


def _read(fetch, *args):
    """``fetch(*args)``, a read that waits for the device and copies to the
    host, inside a ``lyapunov.read`` span and counted in
    ``lyapunov.host_reads``."""
    profiling.count("lyapunov.host_reads")
    with profiling.named_scope("lyapunov.read"):
        return fetch(*args)


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
    values, eligible = _fused_eligible(
        policy, dynamics, lyapunov_function, lipschitz_lyapunov,
        lipschitz_dynamics, tau, points, exempt, margin, values_direct)
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


def _fused_eligible(policy, dynamics, lyapunov_function, lipschitz_lyapunov,
                    lipschitz_dynamics, tau, points, exempt, margin=0.0,
                    values_direct=None):
    """The per-point part of :func:`_fused_update`: ``(values, eligible)``,
    the candidate's values and whether each point passes the decrease
    check or is exempt."""
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
    return values, negative | exempt


def _sharded_fused_update(policy, dynamics, lyapunov_function,
                          lipschitz_lyapunov, lipschitz_dynamics, tau, points,
                          exempt, margin=0.0, level_margin=0.0,
                          values_direct=None):
    """:func:`_fused_update` over a mesh: ``points`` and ``exempt`` are
    :class:`~.parallel.mesh.ShardedArray`\\ s of the grid's rows; a
    per-point ``margin`` and ``values_direct`` are whole-grid and sliced.

    Each shard runs the per-point work (:func:`_fused_eligible`) on its
    device; then two reductions over the shards and the mesh's processes:
    ``v_bad``, the smallest value of a failing state (NaN when a value is,
    as a minimum over the whole grid), and, once each shard has cut at
    ``v_bad - level_margin``, the largest safe value and whether any state
    is safe. The per-point outputs stay on their shards.

    Returns ``(safe_set, c_max, values, any_safe)``: sharded arrays of the
    safe mask and the values, ``c_max`` and ``any_safe`` as numbers.
    """
    mesh = points.mesh
    local = []
    for pos, (lo, hi), pts in points.local():
        values, eligible = _fused_eligible(
            policy, dynamics, lyapunov_function, lipschitz_lyapunov,
            lipschitz_dynamics, tau, pts, exempt.shards[pos],
            margin if np.ndim(margin) == 0 else margin[lo:hi],
            None if values_direct is None
            else values_direct.reshape(-1)[lo:hi])
        inf = torch.tensor(float("inf"), dtype=values.dtype,
                           device=values.device)
        local.append((pos, values, torch.where(eligible, inf, values).min()))
    # One host read for the shards' minima, one for their maxima (the
    # shards of one process share config.device).
    mins = (_read(torch.stack([m for _, _, m in local]).double().tolist)
            if local else [])
    nan = any(np.isnan(m) for m in mins)
    v_bad, nan = reduce_scalars(
        [np.inf if nan or not mins else min(mins), -float(nan)], "min", mesh)
    if nan < 0:
        v_bad = np.nan
    safe = [None] * mesh.size
    vals = [None] * mesh.size
    tops = []
    for pos, values, _ in local:
        cut = torch.tensor(v_bad, dtype=values.dtype, device=values.device)
        safe[pos] = values < cut - level_margin
        vals[pos] = values
        tops.append(torch.stack([
            torch.where(safe[pos], values, -float("inf")).max().double(),
            safe[pos].any().double()]))
    c_max, any_safe = (_read(torch.stack(tops).max(dim=0).values.tolist)
                       if tops else (-np.inf, 0.0))
    c_max, any_safe = reduce_scalars([c_max, any_safe], "max", mesh)
    n = points.shape[0]
    return (ShardedArray(safe, grid_sharding(mesh, 1), (n,), torch.bool),
            c_max,
            ShardedArray(vals, grid_sharding(mesh, 1), (n,), next(
                (v.dtype for v in vals if v is not None), points.dtype)),
            bool(any_safe))


def _f64(value, like):
    """A margin (a number, an array or a tensor) as float64 on ``like``'s
    device; a number stays a number."""
    if np.ndim(value) == 0:
        return float(value)
    return torch.as_tensor(value).to(device=like.device, dtype=torch.float64)


class _DecreaseCheck:
    """The decrease check of one sweep: the working-dtype one, the float64
    one of an ``ops.extended_verify.ExtendedSweep``, or the hybrid of both.

    ``negative(states, margin, index)`` checks a batch of states (``index``
    selects their rows of a per-state band margin, in grid order) and
    ``refined(states, offsets, r, margin)`` their ``R^d`` sub-grids; each
    returns a device bool ``(N,)``. The hybrid's refined checks go straight
    to the float64 one, as the JAX package's do.
    """

    def __init__(self, lyapunov, sweep=None, band_margin=None):
        self.lyapunov = lyapunov
        self.sweep = sweep
        self.band = band_margin
        self.band_states = 0
        self.checked = 0

    def negative(self, states, margin, index):
        lyap = self.lyapunov
        if self.sweep is None:
            return _negative_batch(
                lyap.policy, lyap.dynamics, lyap.lyapunov_function,
                lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics,
                lyap.tau, states, margin)[0]
        if self.band is None:
            return self.sweep.negative_batch(states, margin=margin)
        return self._hybrid(states, margin, index)

    def _hybrid(self, states, m_ext, index):
        """The two passes of ``safe_learning_tpu/lyapunov.py:832-912``.

        Pass 1 runs the working-dtype pipeline. With ``|diff32 - exact| <=
        m_band`` (the derived per-state bound) and ``|diff64 - exact| <=
        m_ext``, a state with ``diff32 < -(m_band + 2 m_ext)`` passes the
        float64 check and one with ``diff32 > m_band + 2 m_ext`` fails it;
        only the band between is checked in float64 (pass 2). So the
        verdicts equal the float64 check's. ``diff32 = dec - thr`` is
        formed in float64, exact unless the exponents of ``dec`` and
        ``thr`` are far apart; the band is widened by twice that
        subtraction's rounding, ``2^-52 |diff|``, and the float64 sum
        ``m_band + 2 m_ext`` by ``2^-50`` of itself.
        """
        lyap = self.lyapunov
        _, dec, thr = _negative_batch(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            states, 0.0)
        diff = dec.double() - thr.double()
        m_ext = _f64(m_ext, diff)
        width = (self.band[index] + 2.0 * m_ext) * (1.0 + 2.0 ** -50)
        width = width + 2.0 ** -52 * diff.abs()
        negative = diff < -width
        band = ~negative & (diff <= width)
        n_band = _read(int, band.sum())
        self.band_states += n_band
        self.checked += int(states.shape[0])
        if n_band:
            negative[band] = self.sweep.negative_batch(
                states[band],
                margin=m_ext if isinstance(m_ext, float) else m_ext[band])
        return negative

    def refined(self, states, offsets, r, margin):
        lyap = self.lyapunov
        if self.sweep is None:
            return _refined_negative_batch(
                lyap.policy, lyap.dynamics, lyap.lyapunov_function,
                lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics,
                lyap.tau, states, offsets, r, margin)
        return self.sweep.refined_negative_batch(states, r, margin=margin)


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
    mesh : parallel.Mesh, optional
        Shard every sweep over the mesh's entries (``parallel.make_mesh``
        in one process, ``parallel.distributed.make_global_mesh`` over
        ranks); this process's entries must be ``config.device``. The
        results are those of the sweep without a mesh, bit for bit. It
        may be set later as ``lyapunov.mesh``.
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
        self.discretization = discretization
        self.mesh = mesh
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
        #: Unit roundoff each installed margin was derived at (None: an
        #: empirical or manual margin); set by ``errorbounds``.
        self._certificate_margin_unit = None
        self._exploration_margin_unit = None
        self.exploration_margin = None

        self._lipschitz_dynamics = _as_lipschitz(lipschitz_dynamics)
        self._lipschitz_lyapunov = _as_lipschitz(lipschitz_lyapunov)

        # The rigor modes (ops.extended_verify): the linear models of a
        # callable L_v or L_f, the float64 sweep and its key, the hybrid's
        # band margin (installed, or derived and keyed like the sweep) and
        # the share of states the last hybrid sweep checked in float64.
        self._extended_lv_matrix = None
        self._extended_lf_matrix = None
        self._ext_sweep = None
        self._ext_sweep_key = None
        self._ext_sweep_refs = None
        self._ext_matrix_keys = {}
        #: A manual per-state (or scalar) band margin of the hybrid sweep;
        #: ``None`` derives ``ops.extended_verify.hybrid_band_margin``.
        self.hybrid_band_margin = None
        self._auto_band_margin = None
        self._auto_band_key = None
        #: Share of the checked states the last hybrid sweep re-checked in
        #: float64 (its cost driver).
        self.last_band_fraction = None

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
        # Refinement levels: 0 outside the safe set, at least 1 in it.
        self._refinement = np.array(self.safe_set, dtype=np.uint8)
        self.update_values()

    # ------------------------------------------------------------------
    @property
    def mesh(self):
        """The :class:`~.parallel.mesh.Mesh` the sweeps shard over, or
        ``None``."""
        return self._mesh

    @mesh.setter
    def mesh(self, value):
        if value is not None and not isinstance(value, Mesh):
            raise TypeError("mesh must be a parallel.Mesh or None, got {}"
                            .format(type(value).__name__))
        self._mesh = value

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
    def exploration_margin(self):
        """Dedicated margin of the exploration level test ``v_future <
        c_max - margin`` (or None), installed by ``errorbounds.
        analytic_exploration_margin``; ``explore._margin_of`` prefers it
        over ``certificate_margin``."""
        return self._exploration_margin

    @exploration_margin.setter
    def exploration_margin(self, value):
        """Set (or with ``None`` clear) the exploration margin; clears its
        derivation unit."""
        self._exploration_margin = None if value is None else float(value)
        self._exploration_margin_unit = None

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

    @staticmethod
    def _freeze_matrix(value):
        """A read-only float64 copy of an ``L_v`` or ``L_f`` model matrix:
        the extended sweep's key holds its bytes, and an in-place change
        raises instead of going unseen."""
        if value is None:
            return None
        arr = np.array(value, dtype=np.float64, copy=True)
        arr.setflags(write=False)
        return arr

    @property
    def extended_lv_matrix(self):
        """The ``G`` of a callable ``L_v(x) = |x G^T|`` for the extended
        sweep (a read-only copy; assign to replace)."""
        return self._extended_lv_matrix

    @extended_lv_matrix.setter
    def extended_lv_matrix(self, value):
        self._extended_lv_matrix = self._freeze_matrix(value)

    @property
    def extended_lf_matrix(self):
        """The one-row ``H`` of a callable ``L_f(x) = |x H^T|`` for the
        extended sweep (a read-only copy; assign to replace)."""
        return self._extended_lf_matrix

    @extended_lf_matrix.setter
    def extended_lf_matrix(self, value):
        self._extended_lf_matrix = self._freeze_matrix(value)

    def _require_f32_margin(self):
        """Refuse a margin derived at a finer unit roundoff than the
        sweep's working dtype (it could not cover the sweep's rounding)."""
        unit = self._certificate_margin_unit
        consumer = float(torch.finfo(config.dtype).eps) / 2
        if unit is not None and unit < consumer:
            raise RuntimeError(
                "certificate_margin was derived at unit roundoff "
                f"{unit:.2e} (the extended pipeline's); it cannot cover the "
                f"plain sweep's rounding at unit {consumer:.2e}. Run "
                "update_safe_set(extended=True), or install a plain "
                "margin (oracle.calibrate_certificate_margin, "
                "errorbounds.analytic_certificate_margin)")

    def _get_extended_sweep(self):
        """The float64 sweep of the current models, built or reused
        (``safe_learning_tpu/lyapunov.py:758-812``): keyed on the models'
        identities, the GP's count, ``tau``, the values of the model
        matrices and the device; the keyed objects are held so that no
        freed id is reused."""
        from .ops.extended_verify import ExtendedSweep

        lf = self._lipschitz_dynamics
        try:
            lf_key = float(lf)
        except (TypeError, ValueError):
            lf_key = id(lf)

        def matrix_key(m, slot):
            if m is None:
                return None
            cached = self._ext_matrix_keys.get(slot)
            if cached is not None and cached[0] is m:
                return cached[1]
            key_m = (m.shape, m.tobytes())
            self._ext_matrix_keys[slot] = (m, key_m)
            return key_m

        key = (id(self.dynamics), int(getattr(self.dynamics, "count", -1)),
               id(self.policy), id(self.lyapunov_function),
               id(self._lipschitz_lyapunov), lf_key, self.tau,
               matrix_key(self.extended_lv_matrix, "lv"),
               matrix_key(self.extended_lf_matrix, "lf"), config.device)
        if self._ext_sweep is None or self._ext_sweep_key != key:
            self._ext_sweep = ExtendedSweep(
                self, lv_matrix=self.extended_lv_matrix,
                lf_matrix=self.extended_lf_matrix)
            self._ext_sweep_key = key
            self._ext_sweep_refs = (self.dynamics, self.policy,
                                    self.lyapunov_function,
                                    self._lipschitz_lyapunov,
                                    self._lipschitz_dynamics)
        return self._ext_sweep

    def _get_hybrid_band_margin(self):
        """The hybrid sweep's band margin: the installed
        :attr:`hybrid_band_margin`, else the derived one, cached on the
        extended sweep's key (``safe_learning_tpu/lyapunov.py:814-830``)."""
        if self.hybrid_band_margin is not None:
            return self.hybrid_band_margin
        from .ops.extended_verify import hybrid_band_margin

        key = self._ext_sweep_key
        if self._auto_band_margin is None or self._auto_band_key != key:
            self._auto_band_margin = hybrid_band_margin(
                self, lv_matrix=self.extended_lv_matrix)
            self._auto_band_key = key
        return self._auto_band_margin

    def _decrease_check(self, extended):
        """The sweep's :class:`_DecreaseCheck`: the float64 one for
        ``extended`` (with the band margin for ``"hybrid"``), else the
        working-dtype one, which refuses a margin of a finer unit."""
        if not extended:
            self._require_f32_margin()
            return _DecreaseCheck(self)
        sweep = self._get_extended_sweep()
        band = None
        if extended == "hybrid":
            band = self._get_hybrid_band_margin()
            band = torch.as_tensor(np.broadcast_to(
                np.asarray(band, np.float64), (self.discretization.nindex,))
                .copy(), device=config.device)
        return _DecreaseCheck(self, sweep, band)

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

    def _sharded_points(self):
        """This process's rows of the grid over :attr:`mesh`, made on the
        entries' devices (``parallel.distributed.global_grid_points``),
        cached per mesh, device and dtype."""
        self.mesh.check_local_devices(config.device)
        cached = getattr(self, "_points_sharded", None)
        key = (config.device, config.dtype)
        if cached is None or cached[0] is not self.mesh or cached[1] != key:
            cached = (self.mesh, key,
                      global_grid_points(self.discretization, self.mesh))
            self._points_sharded = cached
        return cached[2]

    def _map_rows(self, n, fn, dtype=torch.bool):
        """``fn(lo, hi)``, a device tensor of the rows ``[lo, hi)`` of a
        batch of ``n``: one call without a mesh; over :attr:`mesh` one
        call per entry of this process on its range of ``split_rows(n,
        mesh.size)``, the ranges gathered onto ``config.device`` on every
        process."""
        mesh = self.mesh
        if mesh is None:
            return fn(0, n)
        ranges = split_rows(n, mesh.size)
        shards = [fn(lo, hi) if mesh.is_local(i) and hi > lo else None
                  for i, (lo, hi) in enumerate(ranges)]
        return gather_rows(mesh, ranges, shards, (n,), dtype, config.device)

    def _batch_ranges(self, batch):
        """Each mesh entry's ``(start, stop)`` over the grid's batches of
        ``batch`` states: a contiguous run of whole batches (``split_rows``
        of the batch count), so that every batch is the one the sweep
        without a mesh runs; ``[(0, nindex)]`` without a mesh."""
        nindex = self.discretization.nindex
        parts = 1 if self.mesh is None else self.mesh.size
        return [(min(b0 * batch, nindex), min(b1 * batch, nindex))
                for b0, b1 in split_rows(-(-nindex // batch), parts)]

    def _batch_groups(self, batch):
        """``(position, start, stop)`` of :meth:`_batch_ranges` for this
        process's entries that hold a batch (which must be on
        ``config.device``); ``[(0, 0, nindex)]`` without a mesh."""
        if self.mesh is None:
            return [(0, 0, self.discretization.nindex)]
        self.mesh.check_local_devices(config.device)
        return [(i, lo, hi)
                for i, (lo, hi) in enumerate(self._batch_ranges(batch))
                if self.mesh.is_local(i) and hi > lo]

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
        the device, written into one device buffer. Over a mesh each entry
        of this process evaluates its rows (:meth:`_sharded_points`, or its
        run of batches) and every process gathers the whole vector.
        """
        with profiling.named_scope("lyapunov.values"):
            direct = self._direct_grid_values()
            if direct is not None:
                self.values = direct
                return
            grid = self.discretization
            nindex = grid.nindex
            if batch_size is None and nindex <= self._fused_limit(None):
                if self.mesh is None:
                    self.values = _values_batch(self.lyapunov_function,
                                                self._device_points())
                    return
                points = self._sharded_points()
                shards = [None] * self.mesh.size
                for pos, _, pts in points.local():
                    shards[pos] = _values_batch(self.lyapunov_function, pts)
                self.values = gather_rows(
                    self.mesh, points.ranges, shards, (nindex,),
                    self._values_dtype(shards), config.device)
                return
            batch = batch_size or max(int(config.gp_batch_size), 1)
            shards = [None] * (1 if self.mesh is None else self.mesh.size)
            for pos, lo, hi in self._batch_groups(batch):
                values = None
                for start in range(lo, hi, batch):
                    stop = min(start + batch, hi)
                    v = _values_batch(self.lyapunov_function,
                                      grid.states_in_range(start, stop))
                    if values is None:
                        values = torch.empty(hi - lo, dtype=v.dtype,
                                             device=v.device)
                    values[start - lo:stop - lo] = v
                shards[pos] = values
            if self.mesh is None:
                self.values = shards[0]
                return
            self.values = gather_rows(
                self.mesh, self._batch_ranges(batch), shards, (nindex,),
                self._values_dtype(shards), config.device)

    @staticmethod
    def _values_dtype(shards):
        """The dtype of the value shards of this process (the working
        dtype on a process without rows)."""
        return next((s.dtype for s in shards if s is not None), config.dtype)

    def update_safe_set(self, can_shrink=True, max_refinement=1,
                        safety_factor=1.0, parallel_iterations=None,
                        batch_size=None, extended=False):
        """Compute the largest certified level set and update ``safe_set``.

        A non-adaptive instance runs the fused whole-grid sweep
        (:func:`_fused_update`) and ignores ``max_refinement``, as the JAX
        package does. An adaptive one runs the sorted sweep
        (:meth:`_update_safe_set_sorted`): the coarse check in batches
        of ``batch_size`` (default: the whole grid up to
        ``config.fused_sweep_limit``), then the refinement walk at
        ``max_refinement``. ``parallel_iterations`` and ``safety_factor``
        are accepted for API compatibility and have no effect (a
        non-default value warns). A non-adaptive grid above ``max(batch,
        config.fused_sweep_limit)``, ``batch`` being ``batch_size`` or
        ``config.gp_batch_size``, runs the streamed sweep
        (:meth:`_update_safe_set_streamed`). Each shards over
        :attr:`mesh` when one is set.

        ``extended=True`` checks the decrease in float64 on the card
        (``ops.extended_verify.ExtendedSweep``), so that the installed
        ``certificate_margin`` may be the small one derived at the float64
        unit (``extended_certificate_margin``) or measured for that check
        (``oracle.calibrate_extended_margin``); the level cut still
        compares the working-dtype values, guarded by ``level_margin``.
        Such a sweep skips the fused pass: a non-adaptive grid up to the
        fused limit takes the sorted sweep without refinement, a larger
        one the streamed sweep; an adaptive one refines in float64.
        ``extended="hybrid"`` gives the same verdicts at less cost: the
        working-dtype check decides every state whose ``decrease -
        threshold`` clears the band of the derived float32 margin
        (``hybrid_band_margin``, or an installed :attr:`hybrid_band_margin`)
        plus twice the extended one, and only the band is checked in
        float64 (:class:`_DecreaseCheck`); its share over every shard is
        :attr:`last_band_fraction`.

        With a ``torch.profiler`` session running, the sweep's phases are
        spans of ``profiling`` under ``lyapunov.update_safe_set``:
        ``lyapunov.masks``, ``lyapunov.values``, ``lyapunov.fused``,
        ``lyapunov.sort``, ``lyapunov.coarse``, ``lyapunov.walk`` (a
        ``lyapunov.walk.chunk`` a chunk), ``lyapunov.cut`` and
        ``lyapunov.read`` (each read that waits for the device, counted in
        ``lyapunov.host_reads``).
        """
        with profiling.named_scope("lyapunov.update_safe_set"):
            if safety_factor != 1.0 or parallel_iterations is not None:
                warnings.warn(
                    "safety_factor/parallel_iterations are accepted for "
                    "reference-API compatibility but have no effect",
                    RuntimeWarning, stacklevel=2)
            if extended not in (False, True, "hybrid"):
                raise ValueError(
                    "extended must be False, True, or 'hybrid'; got "
                    f"{extended!r}")
            check = self._decrease_check(extended)
            if self.adaptive:
                self._update_safe_set_sorted(can_shrink, int(max_refinement),
                                             batch_size, check)
            elif self.discretization.nindex > self._fused_limit(batch_size):
                self._update_safe_set_streamed(can_shrink, batch_size, check)
            elif extended:
                self._update_safe_set_sorted(can_shrink, 1, batch_size, check)
            else:
                self._update_safe_set_fused(can_shrink)
            if extended == "hybrid":
                band, checked = reduce_scalars(
                    [check.band_states, check.checked], "sum", self.mesh)
                self.last_band_fraction = band / max(checked, 1)

    def _exempt(self, can_shrink):
        """A fresh host mask of the states that pass without the decrease
        check: the initial set (none without one), and the safe set before
        the sweep when ``can_shrink`` is False."""
        with profiling.named_scope("lyapunov.masks"):
            initial = self.initial_safe_set
            exempt = (np.zeros(self.discretization.nindex, dtype=bool)
                      if initial is None else np.array(initial, dtype=bool))
            if not can_shrink:
                exempt |= np.asarray(self.safe_set, dtype=bool)
            return exempt

    def _kept_levels(self):
        """The host levels a sweep with ``can_shrink=False`` keeps where it
        certifies nothing: ``max(level, 1)`` on the safe set before the
        sweep, 1 on the rest of the initial set, 0 elsewhere (nonzero on
        exactly the exempt states), in the dtype of the levels held."""
        with profiling.named_scope("lyapunov.masks"):
            old = self._refinement
            initial = self.initial_safe_set
            kept = (np.zeros(len(old), dtype=old.dtype) if initial is None
                    else np.asarray(initial).astype(old.dtype))
            np.maximum(old, 1, out=kept,
                       where=np.asarray(self.safe_set, dtype=bool))
            return kept

    def _store(self, levels, can_shrink, merged=False):
        """Install a sweep's host refinement levels, a fresh array that no
        one else holds, and the safe mask ``levels != 0`` as a new
        ``safe_set``. Unless the sweep ``merged`` them on the device, the
        exempt states' levels are merged in first: where ``levels`` is 0,
        :meth:`_kept_levels` with ``can_shrink=False``, else the initial
        set at 1."""
        with profiling.named_scope("lyapunov.masks"):
            if not merged and not can_shrink:
                kept = self._kept_levels()
                levels = levels.astype(
                    np.promote_types(levels.dtype, kept.dtype), copy=False)
                np.copyto(levels, kept, where=levels == 0)
            elif not merged and self.initial_safe_set is not None:
                np.maximum(levels, np.asarray(self.initial_safe_set),
                           out=levels)
            self._refinement = levels
            # A new array: wrapped, not copied as the setter copies.
            self._safe_set = (levels != 0).view(TrackedMask)
            self._safe_set_version += 1

    def _count_sweep(self, coarse_batches, refinement_chunks, refined_points,
                     rescued_states):
        """Keep a sweep's counts in ``last_sweep_counts`` and count its
        refined points in ``profiling`` (``lyapunov.refined_points``)."""
        self.last_sweep_counts = dict(
            coarse_batches=coarse_batches,
            refinement_chunks=refinement_chunks,
            refined_points=refined_points, rescued_states=rescued_states)
        profiling.count("lyapunov.refined_points", refined_points)

    def _update_safe_set_streamed(self, can_shrink, batch_size, check):
        """The streamed sweep: one pass over batches of flat indices.

        ``safe_learning_tpu/lyapunov.py:1035-1275`` without the adaptive,
        extended and hybrid branches, and without its host ``argsort``:

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

        Over a mesh each entry of this process takes a contiguous run of
        the batches (:meth:`_batch_groups`; :meth:`update_values` gives the
        values of the same runs, gathered) and keeps its own ``(v_bad,
        i_bad)``; the entries and processes combine them in two
        reductions (the smallest value, then the smallest index among
        those holding it), cut their rows, and gather the safe mask.

        A per-point ``certificate_margin`` is sliced per batch. ``check``
        is the sweep's :class:`_DecreaseCheck`. The last sweep's batches
        are in ``last_sweep_counts`` (this process's, over a mesh), its
        first failing state ``(v_bad, i_bad)`` in ``last_stream_bad``.
        """
        grid = self.discretization
        nindex = grid.nindex
        batch = batch_size or max(int(config.gp_batch_size), 1)
        exempt = self._exempt(can_shrink)
        self.update_values(batch_size=batch)
        values = self.values
        device = values.device
        exempt_dev = torch.as_tensor(exempt, device=device)
        margin = self.certificate_margin
        inf = torch.full((), float("inf"), dtype=values.dtype, device=device)
        batches = 0
        scans = []
        with profiling.named_scope("lyapunov.coarse"):
            for pos, lo, hi in self._batch_groups(batch):
                v_bad = inf
                i_bad = torch.full((), nindex, dtype=torch.int64,
                                   device=device)
                for start in range(lo, hi, batch):
                    stop = min(start + batch, hi)
                    negative = check.negative(
                        grid.states_in_range(start, stop, device),
                        margin if np.ndim(margin) == 0
                        else margin[start:stop], slice(start, stop))
                    v = values[start:stop]
                    failing = ~(negative | exempt_dev[start:stop]) \
                        & ~torch.isnan(v)
                    v_min = torch.where(failing, v, inf).min()
                    first = (failing & (v == v_min)).to(torch.uint8).argmax()
                    i_min = torch.where(failing.any(), first + start, nindex)
                    better = (v_min < v_bad) | ((v_min == v_bad)
                                                & (i_min < i_bad))
                    v_bad = torch.where(better, v_min, v_bad)
                    i_bad = torch.where(better, i_min, i_bad)
                    batches += 1
                scans.append((pos, lo, hi, v_bad, i_bad))
        self._count_sweep(batches, 0, 0, 0)
        with profiling.named_scope("lyapunov.cut"):
            safe = self._streamed_cut(scans, batch)
        # The gathered mask, fresh, as levels 0 and 1.
        self._store(safe.view(np.uint8), can_shrink)

    def _streamed_cut(self, scans, batch):
        """The streamed sweep's cut: ``scans`` holds each local entry's
        ``(position, start, stop, v_bad, i_bad)`` (one, over the whole
        grid, without a mesh). The first failing state is the
        lexicographic minimum over the entries and processes (the smallest
        ``v_bad``, then the smallest ``i_bad`` among those holding it);
        each entry cuts its rows, and the safe mask is gathered on the
        host. Sets ``c_max``; returns the host safe mask."""
        mesh = self.mesh
        nindex = self.discretization.nindex
        values = self.values
        local = [(_read(float, v), _read(int, i)) for *_, v, i in scans]
        v_loc, i_loc = min(local) if local else (np.inf, nindex)
        v_bad = reduce_scalars([v_loc], "min", mesh)[0]
        i_bad = int(reduce_scalars([i_loc if v_loc == v_bad else nindex],
                                   "min", mesh)[0])
        self.last_stream_bad = (v_bad, i_bad)
        level_margin = self.level_margin
        cut = torch.tensor(v_bad, dtype=values.dtype, device=values.device)
        safe = [None] * (1 if mesh is None else mesh.size)
        c_max, any_safe = -np.inf, 0.0
        for pos, lo, hi, _, _ in scans:
            v = values[lo:hi]
            if level_margin > 0.0:
                s = v < cut - level_margin
            else:
                s = v < cut
                head = min(max(i_bad - lo, 0), hi - lo)
                s[:head] |= v[:head] == cut
            safe[pos] = s
            c_max = max(c_max, _read(float, torch.where(
                s, v, -float("inf")).max()))
            any_safe = max(any_safe, _read(float, s.any()))
        c_max, any_safe = reduce_scalars([c_max, any_safe], "max", mesh)
        safe = _read(gather_rows, mesh, self._batch_ranges(batch), safe,
                     (nindex,), torch.bool, "cpu").numpy()
        self.c_max = c_max if any_safe else -np.inf
        return safe

    def _update_safe_set_sorted(self, can_shrink, max_refinement, batch_size,
                                check):
        """The sorted sweep with adaptive refinement, on the device.

        ``safe_learning_tpu/lyapunov.py:1040-1275`` without the extended
        and hybrid branches:

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
        ``check`` is the sweep's :class:`_DecreaseCheck`; an extended
        sweep of a non-adaptive grid runs here at ``max_refinement=1``.

        Over a mesh every process holds the gathered values and sorts them
        alike; each coarse batch and refinement chunk, rounded up to a
        multiple of ``lcm(256, mesh.size)`` (JAX ``:996-1003``,
        ``:1170-1173``), is split over the entries (:meth:`_map_rows`),
        which make their states from the flat indices on the device
        (:meth:`GridWorld.states_at`), and the verdicts are gathered before
        the walk reads them.
        """
        grid = self.discretization
        nindex = grid.nindex
        mesh = self.mesh
        if mesh is None:
            points = self._device_points()
            device = points.device

            def states_at(idx):
                return points[idx]
        else:
            mesh.check_local_devices(config.device)
            device = config.device
            states_at = grid.states_at
        like = torch.empty(0, dtype=config.dtype, device=device)
        r = max(int(max_refinement), 1)
        exempt = self._exempt(can_shrink)

        self.update_values()
        values = self.values
        with profiling.named_scope("lyapunov.sort"):
            order = torch.sort(values, stable=True).indices
            sorted_values = values[order]
            exempt_sorted = torch.as_tensor(exempt, device=device)[order]
            margin = self.certificate_margin
            if np.ndim(margin):
                # Float64: the extended check compares against it in
                # float64; the working-dtype check rounds it as before.
                margin = torch.as_tensor(margin, dtype=torch.float64,
                                         device=device)[order]

        def margin_at(index):
            return margin if isinstance(margin, float) else margin[index]

        def rounded(size):
            if mesh is None:
                return size
            unit = math.lcm(256, mesh.size)
            return -(-size // unit) * unit

        # 2. The coarse check, batch by batch, into one sorted mask.
        batch = batch_size or max(int(config.gp_batch_size),
                                  min(nindex, self._fused_limit(None)))
        if mesh is not None:
            batch = rounded(min(batch, nindex))
        passed = torch.empty(nindex, dtype=torch.bool, device=device)
        batches = 0
        with profiling.named_scope("lyapunov.coarse"):
            for start in range(0, nindex, batch):
                idx = order[start:start + batch]
                passed[start:start + len(idx)] = self._map_rows(
                    len(idx), lambda lo, hi: check.negative(
                        states_at(idx[lo:hi]),
                        margin_at(slice(start + lo, start + hi)),
                        idx[lo:hi]))
                batches += 1
            passed |= exempt_sorted

        # 3. The refinement walk over the failing states in value order.
        with profiling.named_scope("lyapunov.walk"):
            failing = _read(torch.nonzero, ~passed).reshape(-1)
            n_fail = int(failing.shape[0])
            stop = nindex if n_fail == 0 else None
            chunks = refined_points = rescued = 0
            if n_fail and r > 1:
                offsets = refinement_offsets(grid.unit_maxes, r, like)
                chunk = rounded(max(1, REFINED_POINTS_PER_CHUNK
                                    // offsets.shape[0]))
                for start in range(0, n_fail, chunk):
                    with profiling.named_scope("lyapunov.walk.chunk"):
                        pos = failing[start:start + chunk]
                        ok = self._map_rows(
                            len(pos), lambda lo, hi: check.refined(
                                states_at(order[pos[lo:hi]]), offsets, r,
                                margin_at(pos[lo:hi])))
                        chunks += 1
                        refined_points += len(pos) * offsets.shape[0]
                        # One read a chunk: whether every state passed,
                        # the first that did not, and its sorted position.
                        first = (~ok).long().argmax().reshape(1)
                        all_ok, first_bad, bad_pos = _read(torch.cat(
                            [ok.all().long().reshape(1), first,
                             pos.gather(0, first)]).tolist)
                    if not all_ok:
                        rescued += first_bad
                        stop = bad_pos
                        break
                    rescued += len(pos)
                else:
                    stop = nindex
            elif n_fail:
                stop = _read(int, failing[0])
        self._count_sweep(batches, chunks, refined_points, rescued)

        # 4. The prefix, trimmed by the level margin.
        with profiling.named_scope("lyapunov.cut"):
            max_index = stop - 1
            level_margin = self.level_margin
            if level_margin > 0.0 and 0 <= max_index < nindex - 1:
                trimmed = _read(int, torch.searchsorted(
                    sorted_values,
                    sorted_values[stop:stop + 1] - level_margin,
                    side="left")) - 1
                max_index = min(max_index, trimmed)
            self.c_max = (_read(float, sorted_values[max_index])
                          if max_index >= 0 else -np.inf)

            # In sorted order: 1 for a coarse pass, R for a refined rescue
            # (every failing state before ``stop``), 0 past the prefix.
            ref_sorted = torch.full((nindex,), r,
                                    dtype=level_dtypes(r)[1], device=device)
            ref_sorted.masked_fill_(passed, 1)
            ref_sorted[max_index + 1:] = 0
            ref_dev = torch.empty_like(ref_sorted)
            ref_dev[order] = ref_sorted
            levels = _read(ref_dev.cpu).numpy()
        self._store(levels, can_shrink)

    def _update_safe_set_fused(self, can_shrink):
        """Whole-grid single-pass path (over :attr:`mesh` when one is set:
        :meth:`_update_safe_set_fused_sharded`).

        The levels are made on the device, the exempt states' merged in,
        and read to the host once, one byte a state."""
        if self.mesh is not None:
            self._update_safe_set_fused_sharded(can_shrink)
            return
        points = self._device_points()
        # The exempt states' levels: with can_shrink the initial set as a
        # mask, whose device copy is kept until that mask changes.
        key = (id(self.initial_safe_set), self._initial_set_version,
               getattr(self.initial_safe_set, "mutations", None),
               points.device)
        if not can_shrink:
            kept = self._kept_levels()
        elif getattr(self, "_exempt_key", None) != key:
            kept = self._exempt(True)
        else:
            kept = None
        with profiling.named_scope("lyapunov.fused"):
            if kept is None:
                kept_dev = self._exempt_dev
            else:
                kept_dev = torch.as_tensor(kept, device=points.device)
                if can_shrink:
                    self._exempt_dev, self._exempt_key = kept_dev, key
            exempt_dev = kept_dev if can_shrink else kept_dev != 0
            safe_dev, c_max, values, _ = _fused_update(
                self.policy, self.dynamics, self.lyapunov_function,
                self._lipschitz_lyapunov, self._lipschitz_dynamics, self.tau,
                points, exempt_dev, self.certificate_margin,
                self.level_margin, self._direct_grid_values())
            # 1 where certified, else the exempt states' levels (a bool
            # mask's are 0 and 1).
            levels_dev = kept_dev.masked_fill(safe_dev, 1)
            if levels_dev.dtype == torch.bool:
                levels_dev = levels_dev.view(torch.uint8)

        # Values stay on the device; c_max is -inf when nothing verifies.
        self.values = values
        levels = _read(levels_dev.cpu).numpy()
        self.c_max = _read(float, c_max)
        self._store(levels, can_shrink, merged=True)

    def _update_safe_set_fused_sharded(self, can_shrink):
        """The fused path over :attr:`mesh`: :func:`_sharded_fused_update`
        on this process's rows, the safe mask and the values gathered onto
        every process. The exempt mask's shards are cached as the path
        without a mesh caches its copy, keyed on the mesh too (which the
        key holds)."""
        mesh = self.mesh
        points = self._sharded_points()
        key = (id(self.initial_safe_set), self._initial_set_version,
               getattr(self.initial_safe_set, "mutations", None),
               config.device, mesh)
        cached = getattr(self, "_exempt_sharded", None)
        exempt_sh = (cached[1] if can_shrink and cached is not None
                     and cached[0] == key else None)
        if exempt_sh is None:
            exempt_sh = put_global(self._exempt(can_shrink),
                                   grid_sharding(mesh, 1))
            if can_shrink:
                self._exempt_sharded = (key, exempt_sh)

        with profiling.named_scope("lyapunov.fused"):
            safe_sh, c_max, values, any_safe = _sharded_fused_update(
                self.policy, self.dynamics, self.lyapunov_function,
                self._lipschitz_lyapunov, self._lipschitz_dynamics, self.tau,
                points, exempt_sh, self.certificate_margin,
                self.level_margin, self._direct_grid_values())
            direct = self._direct_grid_values()
            self.values = (direct if direct is not None
                           else values.gather(config.device))
        safe = _read(safe_sh.numpy)
        self.c_max = c_max if any_safe else -np.inf
        # The gathered mask, fresh, as levels 0 and 1.
        self._store(safe.view(np.uint8), can_shrink)

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
