"""Float64 oracle evaluation and conservative-certificate calibration.

Counterpart of ``safe_learning_tpu/oracle.py``, part 1. A verification
sweep in float32 could certify a grid point whose exact decrease margin
lies inside the float32 noise band. So the sweep certifies only
``decrease < threshold - margin``, with a margin measured here:

- :func:`oracle_margins` evaluates the decrease-condition margin of a
  Lyapunov instance in float64 on the CPU, with the same model
  parameters the working-dtype pipeline uses (tensors widened exactly;
  Gaussian processes rebuilt in float64 from their raw data);
- :func:`calibrate_certificate_margin` measures the worst difference
  between the working-dtype sweep and the oracle on a grid subsample,
  half of it moved onto refined sub-grids for adaptive sweeps, and
  installs ``safety`` times it;
- :func:`calibrate_extended_margin` measures, one-sidedly, how far the
  float64 decrease check on the card (``ops.extended_verify``) understates
  the oracle's margin, and installs ``safety`` times it for the extended
  sweep.

The oracle always runs on the CPU; :func:`lift64` also makes the float64
copies the extended sweep keeps on ``config.device``.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from .config import config
from .functions import gp as gp_mod
from .functions.base import Function
from .grids import GridWorld
from .lyapunov import (_decrease_bound, _negative_batch, _threshold,
                       _values_batch)

__all__ = ["lift64", "oracle_margins", "oracle_safe_set",
           "calibrate_certificate_margin", "calibrate_extended_margin"]

#: Grid rows per float64 pass of :func:`oracle_margins`: at a GP capacity
#: of 32 its intermediates take a few hundred MB.
ORACLE_CHUNK = 2 ** 18


@contextlib.contextmanager
def _oracle_env(device="cpu"):
    """Float64 working dtype on ``device`` (the CPU unless given) for the
    duration of the block."""
    dtype, old_device = config.dtype, config.device
    config.dtype = torch.float64
    config.device = device
    try:
        yield
    finally:
        config.dtype = dtype
        config.device = old_device


def lift64(fn, device="cpu"):
    """Float64 copy of a function or kernel object on ``device`` (the CPU
    unless given).

    Every floating tensor is widened exactly, so the copy computes the
    exact-arithmetic value of the same model the working-dtype pipeline
    evaluates. Gaussian processes, stacked ones included, are rebuilt from
    their raw data and widened hyperparameters, through the same host
    island as any GP, so a GP and its float64 copy share their factors bit
    for bit. Attributes that are functions or kernels, alone or in a tuple
    or list (a ``FunctionStack``'s members, a network's weights and its
    ``None`` output bias), are lifted in turn. A ``GridWorld`` (a
    ``Triangulation``'s discretization) passes through: its metadata is
    float64 and its points follow ``config.dtype``. Callables inside
    :class:`LambdaFunction` are kept as they are (they must work on
    float64 CPU tensors). An attribute that would stay in the working
    dtype, such as a numpy array or a dict, raises ``TypeError``. On a
    CUDA ``device`` the copy runs the float64 kernels.
    """
    if fn is None or isinstance(fn, (int, float)):
        return fn
    if isinstance(fn, gp_mod.StackedGaussianProcess):
        with _oracle_env(device):
            return gp_mod.StackedGaussianProcess(
                tuple(lift64(k, device) for k in fn.kernels),
                fn.X.astype(np.float64), fn.Y.astype(np.float64),
                fn.noise_variances.detach().cpu().double().numpy(),
                betas=np.asarray(fn.betas, dtype=np.float64),
                mean_functions=tuple(lift64(m, device)
                                     for m in fn.mean_functions),
                capacity=fn.capacity, scale=fn.scale)
    if isinstance(fn, gp_mod.GaussianProcess):
        with _oracle_env(device):
            return gp_mod.GaussianProcess(
                lift64(fn.kernel, device), fn.X.astype(np.float64),
                fn.Y.astype(np.float64), float(fn.noise_variance),
                beta=fn.beta,
                mean_function=lift64(fn.mean_function, device),
                capacity=fn.capacity, scale=fn.scale)
    if not isinstance(fn, (Function, gp_mod.Kernel)):
        raise TypeError("lift64 takes a Function or a Kernel, not "
                        "{}".format(type(fn).__name__))
    new = copy.copy(fn)
    for name, value in vars(fn).items():
        setattr(new, name, _lift_attribute(fn, name, value, device))
    return new


def _lift_attribute(owner, name, value, device):
    """Float64 counterpart on ``device`` of one attribute of a lifted
    object."""
    if torch.is_tensor(value):
        if value.is_floating_point():
            return value.detach().to(device, torch.float64)
        return value.detach().to(device)
    if isinstance(value, (Function, gp_mod.Kernel)):
        return lift64(value, device)
    if isinstance(value, (tuple, list)):
        return type(value)(_lift_attribute(owner, name, v, device)
                           for v in value)
    # A grid is float64 host metadata whose points follow config.dtype.
    if (value is None or isinstance(value, (bool, int, float, str,
                                            GridWorld))
            or callable(value)):
        return value
    raise TypeError("lift64 cannot lift {}.{} of type {}".format(
        type(owner).__name__, name, type(value).__name__))


def _host(states):
    if torch.is_tensor(states):
        return states.detach().cpu().numpy()
    return np.asarray(states)


def oracle_margins(lyapunov, states, tau=None):
    """Exact-arithmetic margins ``decrease - threshold`` at ``states``.

    Runs the whole decrease-condition pipeline of the given
    :class:`~safe_learning_tpu_torch.Lyapunov` in float64 on the CPU.
    Negative means the point passes the exact check. ``tau`` overrides the
    instance's discretization constant. Returns a float64 numpy array.
    """
    tau = lyapunov.tau if tau is None else tau
    policy = lift64(lyapunov.policy)
    dynamics = lift64(lyapunov.dynamics)
    v_fun = lift64(lyapunov.lyapunov_function)
    lip_v = lift64(lyapunov._lipschitz_lyapunov)
    lip_f = lift64(lyapunov._lipschitz_dynamics)
    states = _host(states)
    margins = np.empty(len(states))
    # Row chunks bound the host memory of a GP posterior's (cap, rows)
    # intermediates; each row's margin is computed independently.
    with _oracle_env():
        for start in range(0, len(states), ORACLE_CHUNK):
            points = torch.as_tensor(states[start:start + ORACLE_CHUNK],
                                     dtype=torch.float64)
            next_states = dynamics(points, policy(points))
            decrease = _decrease_bound(v_fun, lip_v, points, next_states)
            threshold = _threshold(lip_v, lip_f, points, tau)
            margins[start:start + len(points)] = (decrease - torch.as_tensor(
                threshold, dtype=torch.float64).broadcast_to(
                    decrease.shape)).numpy().ravel()
    return margins


def _oracle_values(lyapunov, points):
    """Float64 Lyapunov values at ``points``."""
    v_fun = lift64(lyapunov.lyapunov_function)
    with _oracle_env():
        pts = torch.as_tensor(_host(points), dtype=torch.float64)
        return v_fun(pts).reshape(-1).numpy()


def oracle_safe_set(lyapunov, margins=None):
    """Exact-arithmetic certified level set of a Lyapunov instance.

    The construction of a fresh ``update_safe_set`` (decrease check,
    initial-set exemption, ``v_bad = min v(failing)`` level cut) entirely
    in float64. ``margins`` are :func:`oracle_margins` at the grid's
    points when the caller has them already; without them only the states
    below the first failing value are evaluated
    (:func:`_first_failing_value`). Returns ``(safe_set, c_max)`` with the
    initial set OR-ed in, as the sweep does.
    """
    grid = lyapunov.discretization
    points = grid.all_points
    values = _oracle_values(lyapunov, points)
    exempt = (np.asarray(lyapunov.initial_safe_set, dtype=bool)
              if lyapunov.initial_safe_set is not None
              else np.zeros(grid.nindex, dtype=bool))
    if margins is None:
        v_bad = _first_failing_value(lyapunov, points, values, exempt)
    else:
        eligible = (margins < 0.0) | exempt
        v_bad = np.inf if eligible.all() else values[~eligible].min()
    safe = values < v_bad
    c_max = float(values[safe].max()) if safe.any() else -np.inf
    safe |= exempt
    return safe, c_max


def _first_failing_value(lyapunov, points, values, exempt):
    """``v_bad``: the least value of a state that fails the exact decrease
    check outside the exempt set (``inf`` if none). The states are checked
    in increasing value, ``ORACLE_CHUNK`` at a time, and none whose value
    is at or above a failing one's is evaluated: their margins cannot move
    the level."""
    order = np.argsort(values, kind="stable")
    v_bad = np.inf
    for start in range(0, len(order), ORACLE_CHUNK):
        idx = order[start:start + ORACLE_CHUNK]
        if values[idx[0]] >= v_bad:
            break
        failing = ~(oracle_margins(lyapunov, points[idx]) < 0.0) & \
            ~exempt[idx]
        if failing.any():
            v_bad = min(v_bad, float(values[idx][failing].min()))
    return v_bad


def _calibration_sample(lyapunov, num_samples, rng, refinement):
    """The calibrators' grid subsample in the working dtype, drawn as the
    JAX package draws it, and the mask of its rows moved onto random
    points of their cells' ``refinement``-refined sub-grids (a random half
    when ``refinement > 1``, none otherwise)."""
    grid = lyapunov.discretization
    if grid.nindex > num_samples:
        idx = rng.choice(grid.nindex, size=num_samples, replace=False)
        # The rows of ``all_points``, without building the whole grid.
        pts = grid.points_at(np.sort(idx))
    else:
        pts = grid.all_points
    pts = np.array(pts, dtype=config.np_dtype)
    refined = np.zeros(pts.shape[0], dtype=bool)
    if refinement > 1:
        refined = rng.random(pts.shape[0]) < 0.5
        j = rng.integers(0, refinement, size=(int(refined.sum()),
                                              pts.shape[1]))
        unit = -1.0 + 2.0 * j / (refinement - 1.0)
        half_width = (0.5 * (1.0 - 1.0 / refinement)
                      * np.asarray(grid.unit_maxes))
        pts[refined] = pts[refined] + (half_width * unit).astype(
            config.np_dtype)
    return pts, refined


def calibrate_certificate_margin(lyapunov, num_samples=4096, safety=2.0,
                                 rng=None, set_margin=True, refinement=1):
    """Measure the working-dtype pipeline error; install a dominating margin.

    Compares the working-dtype decrease margins on ``config.device``
    against the float64 oracle on a random grid subsample (drawn as the
    JAX package draws it) and returns ``safety * max |margin - margin64|``.

    Parameters
    ----------
    lyapunov : Lyapunov
    num_samples : int, optional
        Grid subsample size (the full grid is used when smaller).
    safety : float, optional
        Multiplier on the measured worst-case error.
    rng : numpy Generator, optional
    set_margin : bool, optional
        Install the results as ``lyapunov.certificate_margin`` and
        ``lyapunov.level_margin``.
    refinement : int, optional
        The ``max_refinement`` ``R`` of the adaptive sweeps the margin will
        guard. With ``R > 1`` a random half of the subsample moves onto
        random points of the cells' ``R``-refined sub-grids and is measured
        against ``tau / R``, the comparison of the refined check
        (``safe_learning_tpu/oracle.py:219-255``, the same draws).
    """
    rng = np.random.default_rng(0) if rng is None else rng
    refinement = int(refinement)
    pts, refined = _calibration_sample(lyapunov, num_samples, rng,
                                       refinement)

    def measure(points, tau):
        """Worst ``|margin - margin64|`` at ``points`` against ``tau``."""
        if points.shape[0] == 0:
            return 0.0
        states = torch.as_tensor(points, dtype=config.dtype,
                                 device=config.device)
        _, dec, thr = _negative_batch(
            lyapunov.policy, lyapunov.dynamics, lyapunov.lyapunov_function,
            lyapunov._lipschitz_lyapunov, lyapunov._lipschitz_dynamics,
            tau, states)
        margins = (dec.cpu().numpy().astype(np.float64)
                   - thr.cpu().numpy().astype(np.float64))
        return float(np.max(np.abs(
            margins - oracle_margins(lyapunov, points, tau=tau))))

    err = max(measure(pts[~refined], lyapunov.tau),
              measure(pts[refined], lyapunov.tau / max(refinement, 1)))
    margin = float(safety) * err
    level_margin = _measured_level_margin(lyapunov, pts, safety)
    if set_margin:
        lyapunov.certificate_margin = margin
        lyapunov.level_margin = level_margin
    return margin


def _measured_level_margin(lyapunov, pts, safety):
    """Companion margin of the level cut.

    The cut compares working-dtype Lyapunov values, so containment also
    needs ``level_margin >= 2 * max |v - v64|`` (one delta for the cut
    value, one for the compared state), floored at a few ULPs of the value
    scale so that exact ties at the cut are excluded.
    """
    states = torch.as_tensor(pts, dtype=config.dtype, device=config.device)
    v_dev = _values_batch(lyapunov.lyapunov_function,
                          states).cpu().numpy().astype(np.float64)
    v64 = _oracle_values(lyapunov, pts)
    delta_v = float(np.max(np.abs(v_dev - v64)))
    v_scale = float(np.max(np.abs(v64))) or 1.0
    eps = float(np.finfo(config.np_dtype).eps)
    return max(2.0 * float(safety) * delta_v, 4.0 * eps * v_scale)


def calibrate_extended_margin(lyapunov, num_samples=4096, safety=2.0,
                              rng=None, set_margin=True, refinement=1):
    """Measure the extended sweep's error; install a dominating margin.

    The measured counterpart of ``ops.extended_verify.
    extended_certificate_margin`` (``safe_learning_tpu/oracle.py:
    291-362``), for instances whose derived model refuses. On the subsample
    of :func:`calibrate_certificate_margin` (the same draws, a refined half
    measured against ``tau / R``) it compares the float64 decrease check on
    ``config.device`` (``ExtendedSweep.margins``) with the oracle, one-sided:
    ``max(oracle - extended, 0)``, since only an understated margin is
    unsound (an inflated ``GradientNorm`` program overstates by design).
    Installs ``safety`` times it, tagged with ``U_EFF`` so that the plain
    sweeps refuse it, and the measured level margin. Measured, not
    derived: ``safety`` covers the tail beyond the sample.
    """
    from .ops.extended_verify import U_EFF

    rng = np.random.default_rng(0) if rng is None else rng
    refinement = int(refinement)
    pts, refined = _calibration_sample(lyapunov, num_samples, rng,
                                       refinement)
    sweep = lyapunov._get_extended_sweep()

    def measure(points, tau):
        """Worst ``max(margin64 - margin_extended, 0)`` at ``points``."""
        if points.shape[0] == 0:
            return 0.0
        return float(np.max(np.maximum(
            oracle_margins(lyapunov, points, tau=tau)
            - sweep.margins(points, tau=tau), 0.0)))

    err = max(measure(pts[~refined], lyapunov.tau),
              measure(pts[refined], lyapunov.tau / max(refinement, 1)))
    margin = float(safety) * err
    level_margin = _measured_level_margin(lyapunov, pts, safety)
    if set_margin:
        lyapunov.certificate_margin = margin
        lyapunov.level_margin = level_margin
        lyapunov._certificate_margin_unit = U_EFF
    return margin
