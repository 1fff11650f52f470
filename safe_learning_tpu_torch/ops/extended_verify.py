"""The rigor mode: float64 decrease checks on the card.

Counterpart of ``safe_learning_tpu/ops/extended_verify.py``. The float32
sweep certifies ``decrease < threshold - margin`` with a margin that covers
its own rounding. The derived float32 margin
(:func:`~safe_learning_tpu_torch.errorbounds.analytic_certificate_margin`)
is rigorous but grows with the conditioning of the GP's factors: on
``bench.py``'s instance it is hundreds of times the measured one and
certifies the exempt set alone. This module runs the whole decrease
pipeline -- policy, GP posterior (mean and confidence), Lyapunov values,
Lipschitz threshold, comparison -- on a float64 copy of the instance on
``config.device``, so that the same rounding analysis, taken at the
float64 unit :data:`U_EFF`, gives a margin about ``2^29`` times smaller.

The JAX package reaches about ``2^-40`` on the TPU with double-word
float32 arithmetic (``ops/extended.py`` and a double-word compiler). The
H100 computes float64 natively, and the JAX package accepts a plain
float64 sweep whose margin was derived at the float64 unit as sound
(``safe_learning_tpu/lyapunov.py:585-610``). So the port departs on
purpose: the extended unit is the card's float64 unit, the check runs on
a float64 copy of the instance through the float64 instantiations of the
GP kernels (``csrc/``), and neither ``ops/extended.py`` nor the
double-word compiler nor their self-checks (``eft_selfcheck``,
``_check_trig_domain``) are ported.

Soundness chain:

1. the float64 copy is :func:`~safe_learning_tpu_torch.oracle.lift64` on
   ``config.device``: every tensor widened exactly, every GP rebuilt
   through the host float64 island, so its factors are bit for bit the
   ones the float64 oracle uses;
2. the check evaluates the oracle's formula (``oracle.oracle_margins``)
   term by term, with the modelled ``L_v`` and ``L_f`` realizations
   below in place of opaque callables; both realizations round at most
   ``U_EFF`` per operation, so
   ``errorbounds.analytic_certificate_margin(unit_roundoff=U_EFF)`` bounds
   their difference;
3. a margin derived at ``U_EFF`` is tagged with it: the float32 sweep and
   scorer refuse it (``Lyapunov._require_f32_margin``,
   ``explore._margin_of``); the extended sweep consumes it.

``L_v`` realizations: a scalar; the row-wise form ``|x G^T|``
(``lv_matrix``, spot-checked against the callable); the global spectral
bound of a ``GradientNorm(NeuralNetwork)``; the inflated piecewise-linear
gradient norm of a ``GradientNorm(Triangulation)``. ``L_f`` the same, with
one output. At ``tau == 0`` with deterministic dynamics neither is used.
The GP kernels of the float64 copy run in float64 on the card, at any
count the GPs route to a kernel (up to 2,048 rows), as the JAX package
does: kernels 1-3 take their tiled body up to 128 rows, the float64 panel
body up to 256 (``ops.gp_kernel.program_panel_max``) and the strip body
above it, each with the product on the FP64 tensor cores.

Over a mesh (``Lyapunov(mesh=...)``, ``parallel``) the sweeps split
their batches and refinement chunks over the entries and ranks, and each
rank checks its rows with its own :class:`ExtendedSweep` on its
``config.device``: every check is per state, so the verdicts, and the
hybrid's band filter, are those of the sweep without a mesh; the hybrid's
band counts are summed over the ranks (``Lyapunov.last_band_fraction``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..config import config
from ..dynamics import CartPole, InvertedPendulum, VanDerPol
from ..errorbounds import (ErrorModel, _auto_lv_matrix, _candidate_model,
                           _gp_members, _lf_error_model, _lv_error_model,
                           _model_reltol, _np64, _tensor, _unit_roundoff,
                           analytic_certificate_margin,
                           analytic_exploration_margin)
from ..explore import _future_values
from ..functions.base import (ConstantFunction, FunctionStack, GradientNorm,
                              MultipliedFunction, Saturation)
from ..functions.gp import (GaussianProcess, StackedGaussianProcess,
                            coerce_stacked)
from ..functions.linear import LinearSystem, QuadraticFunction
from ..functions.neural import LyapunovNetwork, NeuralNetwork
from ..functions.simplex import Triangulation
from ..grids import row_major_strides
from ..lyapunov import _negative_batch, refinement_offsets
from ..oracle import _oracle_env, lift64

__all__ = ["FP_ERROR_FACTOR64", "U_EFF", "ExtendedSweep",
           "extended_gp_evaluate", "extended_certificate_margin",
           "extended_exploration_margin", "hybrid_band_margin",
           "BandModelRefused"]

#: Units of ``2^-53`` one operation of the float64 pipeline may err by,
#: relative. On the H100: +, -, *, /, sqrt and FMA are IEEE
#: round-to-nearest (1 unit); dot products (the kernels' solves, cuBLAS
#: DGEMM) obey gamma_n in any order; ``exp`` errs by at most 1 ulp and
#: ``sin``, ``cos`` and ``tanh`` by 2 ulp by the CUDA Math API's table (2
#: and 4 units); torch's ``sigmoid``, ``1 / (1 + exp(-x))``, by about 4.
#: ``chip_smoke.py``'s ``phase_rigor`` measures each on the card against
#: ``numpy.longdouble`` and fails if one exceeds this factor.
FP_ERROR_FACTOR64 = 6.0

#: The extended pipeline's unit roundoff: the card's float64 unit.
U_EFF = FP_ERROR_FACTOR64 * 2.0 ** -53

#: Appended to every refusal of an instance: what it can use instead.
_FALLBACK = (" [fallback: run the plain float32 sweep with a derived "
             "margin (errorbounds.analytic_certificate_margin) or a "
             "measured one (oracle.calibrate_certificate_margin)]")


def _u_eff():
    """:data:`U_EFF` as it stands when called (tests may replace it)."""
    return U_EFF


def _is_extended_unit(unit):
    return unit is not None and float(unit) == _u_eff()


def _f64(value, device):
    """``value`` (a tensor, an array or a number) as float64 on
    ``device``; float32 values are widened exactly."""
    if torch.is_tensor(value):
        return value.detach().to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(value, dtype=np.float64),
                           device=device)


# ---------------------------------------------------------------------------
# L_v and L_f realizations
# ---------------------------------------------------------------------------
def _linear_form(matrix, device):
    """``|x G^T|`` in float64, ``(N, rows)``."""
    g_t = torch.as_tensor(np.array(np.atleast_2d(matrix), np.float64).T,
                          device=device)

    def fn(x):
        return torch.matmul(x, g_t).abs()
    return fn


#: ``sup |act'|`` of each supported activation: the chain-rule factor of
#: the spectral gradient bound (tanh', relu', identity' <= 1, sigmoid' <=
#: 1/4). softplus' <= 1 as well.
_ACT_DERIV_SUP = {None: 1.0, "linear": 1.0, "relu": 1.0, "tanh": 1.0,
                  "sigmoid": 0.25, "softplus": 1.0}

#: Relative headroom on each float64 singular value: LAPACK's SVD is
#: backward stable, so the computed sigma are exact for a perturbation of
#: about ``p(n) eps64 ||A||``, far below ``2^-30``.
_SVD_HEADROOM = 1.0 + 2.0 ** -30


def _spectral_grad_bound(net):
    """Global float64 bound on ``||grad net(x)||_2`` of a scalar MLP, or
    None for anything else (``safe_learning_tpu/ops/extended_verify.py:
    757-786``): ``|scale| prod_l sigma_max(W_l) sup|act_l'|``, the
    biases shifting the activations' operating points but never their
    slopes."""
    if not isinstance(net, NeuralNetwork) or int(net.layers[-1]) != 1:
        return None
    c = abs(float(net.output_scale))
    for w, act in zip(net.weights, net.nonlinearities):
        if act not in _ACT_DERIV_SUP:
            raise NotImplementedError(
                "spectral gradient bound supports relu/tanh/sigmoid/"
                "softplus/linear activations; got {!r}".format(act)
                + _FALLBACK)
        w64 = w.detach().cpu().double().numpy()
        smax = float(np.linalg.svd(w64, compute_uv=False)[0])
        c *= smax * _SVD_HEADROOM * _ACT_DERIV_SUP[act]
    return c


def _spectral_ord(lv):
    """``(dv, constant)`` bounding ``GradientNorm(MLP, ord)``, or None:
    from the 2-norm bound ``C``, every entry of ``|grad|`` and its maximum
    are at most ``C``, its sum at most ``sqrt(d) C``."""
    c = _spectral_grad_bound(lv.fun)
    if c is None:
        return None
    d_in = int(lv.fun.input_dim)
    if lv.ord is None:
        return d_in, c
    if np.isinf(lv.ord):
        return 1, c
    return 1, float(np.sqrt(d_in)) * c


def _gradnorm_spectral(lv, device):
    """``GradientNorm(NeuralNetwork, ord)`` as its baked spectral bound:
    a constant that dominates the callable everywhere, the conservative
    direction for both the threshold and the error term
    (``safe_learning_tpu/ops/extended_verify.py:813-842``). Returns
    ``(fn, dv)``."""
    dv_c = _spectral_ord(lv)
    if dv_c is None:
        raise NotImplementedError(
            "spectral gradient bound needs a scalar-output NeuralNetwork; "
            "got GradientNorm({})".format(type(lv.fun).__name__)
            + _FALLBACK)
    dv, c = dv_c

    def fn(x):
        return torch.full((x.shape[0], dv), c, dtype=torch.float64,
                          device=x.device)
    return fn, dv


#: Face-ambiguity trigger width in cell units: within it of a cell face
#: or a Kuhn-rank tie, the gradient program takes the maximum over the
#: neighbouring cells (``safe_learning_tpu/ops/extended_verify.py:
#: 694-706``).
_PWL_GRAD_DELTA = 2.0 ** -10


def _pwl_gradient_cell_table(tri):
    """Per-cell, per-axis maximum ``|simplex gradient|`` of a scalar PWL,
    exactly in float64 from its vertex table: ``(table (cells..., d),
    cells_shape, unit64)`` (``safe_learning_tpu/ops/extended_verify.py:
    709-743``). A Kuhn simplex's gradient component along an axis is one
    corner difference along it, so the maximum over a cell's ``2^(d-1)``
    edges along the axis bounds every simplex in the cell."""
    grid_v = tri.discretization
    d = grid_v.ndim
    shape = tuple(int(s) for s in grid_v.shape)
    cells_shape = tuple(s - 1 for s in shape)
    theta64 = tri.parameters.detach().cpu().double().numpy()[:, 0]
    vals_nd = theta64.reshape(shape)
    lim64 = np.asarray(grid_v._limits, np.float64)
    unit64 = ((lim64[:, 1] - lim64[:, 0])
              / (np.asarray(grid_v.num_points, np.float64) - 1.0))
    table = np.zeros(cells_shape + (d,))
    for ax in range(d):
        diff = np.abs(np.diff(vals_nd, axis=ax)) / unit64[ax]
        for other in range(d):
            if other != ax:
                lo = [slice(None)] * d
                hi = [slice(None)] * d
                lo[other] = slice(0, -1)
                hi[other] = slice(1, None)
                diff = np.maximum(diff[tuple(lo)], diff[tuple(hi)])
        table[..., ax] = diff
    return table, cells_shape, unit64


def _gradnorm_pwl(lv, d, device):
    """``GradientNorm(Triangulation, ord)`` as the conservative float64
    program of ``safe_learning_tpu/ops/extended_verify.py:845-965``.

    The interpolant's gradient is constant on each Kuhn simplex: the axis
    stepped at rank ``k`` has ``(theta[v_{k+1}] - theta[v_k]) / unit``. A
    point whose locate decisions (its cell along an axis, or the order of
    two fractional coordinates) lie within :data:`_PWL_GRAD_DELTA` of a
    boundary takes instead the per-axis maximum over the located cell and
    every neighbour it is near (:func:`_pwl_gradient_cell_table`), which
    bounds the gradient of every simplex any realization (this program,
    the float32 sweep, the float64 oracle) could locate. The geometry is
    the grid's exact float64 one. Returns ``(fn, dv)``.
    """
    tri = lv.fun
    if not (isinstance(tri, Triangulation) and tri.output_dim == 1):
        raise NotImplementedError(
            "extended sweep supports GradientNorm of a scalar "
            "Triangulation or NeuralNetwork; got GradientNorm({})"
            .format(type(tri).__name__) + _FALLBACK)
    grid_v = tri.discretization
    if grid_v.ndim != d:
        raise ValueError("GradientNorm grid dimension mismatch")
    ordv = lv.ord
    if not (ordv is None or ordv == 1 or np.isinf(ordv)):
        raise NotImplementedError(
            "extended sweep supports GradientNorm ord in {{None, 1, inf}}; "
            "got ord={!r}".format(ordv) + _FALLBACK)
    table, cells_shape, unit64 = _pwl_gradient_cell_table(tri)
    n_cells = int(np.prod(cells_shape))
    lim64 = np.asarray(grid_v._limits, np.float64)
    off = torch.as_tensor(lim64[:, 0], device=device)
    inv_unit = torch.as_tensor(1.0 / unit64, device=device)
    theta = tri.parameters.detach().to(device, torch.float64)[:, 0]
    strides = torch.as_tensor(row_major_strides(grid_v.shape), device=device)
    cell_strides = torch.as_tensor(row_major_strides(cells_shape),
                                   device=device)
    top = torch.as_tensor(np.asarray(cells_shape) - 1, device=device)
    g_tab = torch.as_tensor(table.reshape(n_cells, d), device=device)
    subsets = torch.as_tensor(
        list(itertools.product((0, 1), repeat=d)), device=device)
    dims = torch.arange(d, device=device)
    iu = torch.triu_indices(d, d, offset=1, device=device)

    def fn(x):
        n = x.shape[0]
        frac = (x - off) * inv_unit
        cell = torch.minimum(torch.floor(frac).clamp(min=0), top)
        z = (frac - cell).clamp(0.0, 1.0)
        cell = cell.to(torch.int64)
        # The Kuhn rank of each coordinate, ties by index (the locate's
        # rule, ``functions/simplex.py``).
        zj, zi = z[:, None, :], z[:, :, None]
        before = (zj > zi) | ((zj == zi) & (dims[None, None, :]
                                            < dims[None, :, None]))
        rank = before.sum(dim=2)
        order = torch.empty_like(rank).scatter_(
            1, rank, dims.expand(n, d).contiguous())
        corner = (cell * strides).sum(dim=1, keepdim=True)
        vertices = torch.cat(
            [corner, corner + torch.cumsum(strides[order], dim=1)], dim=1)
        vals = theta[vertices]
        diff = vals[:, 1:] - vals[:, :-1]
        g = (torch.gather(diff, 1, rank) * inv_unit).abs()

        near_lo = z < _PWL_GRAD_DELTA
        near_hi = z > 1.0 - _PWL_GRAD_DELTA
        amb = (near_lo | near_hi).any(dim=1)
        if d > 1:
            pair = (z[:, iu[0]] - z[:, iu[1]]).abs()
            amb = amb | (pair < _PWL_GRAD_DELTA).any(dim=1)
        shift = torch.where(near_lo, -1, torch.where(near_hi, 1, 0))
        g_nb = None
        for s in subsets:
            nb = torch.minimum((cell + shift * s).clamp(min=0), top)
            row = g_tab[(nb * cell_strides).sum(dim=1)]
            g_nb = row if g_nb is None else torch.maximum(g_nb, row)
        g = torch.where(amb[:, None], g_nb, g)
        if ordv is None:
            return g
        if np.isinf(ordv):
            return g.amax(dim=1, keepdim=True)
        return g.sum(dim=1, keepdim=True)

    return fn, (d if ordv is None else 1)


def _is_scalar(value):
    if isinstance(value, ConstantFunction):
        return value.is_scalar()
    return isinstance(value, (int, float, np.floating, np.integer)) or (
        isinstance(value, np.ndarray) and value.size == 1)


def _scalar_value(value):
    if isinstance(value, ConstantFunction):
        value = value.constant
    if torch.is_tensor(value):
        return float(value.detach().cpu().double().reshape(()))
    return float(np.asarray(value, np.float64).reshape(()))


def _compile_lv(lv, lv_matrix, d, device):
    """The float64 ``L_v`` realization: ``(fn_or_scalar, dv)``
    (``safe_learning_tpu/ops/extended_verify.py:650-703``)."""
    if _is_scalar(lv):
        return _scalar_value(lv), 1
    if lv_matrix is None and isinstance(lv, GradientNorm):
        if isinstance(lv.fun, NeuralNetwork):
            return _gradnorm_spectral(lv, device)
        return _gradnorm_pwl(lv, d, device)
    if lv_matrix is None:
        raise NotImplementedError(
            "extended sweep needs lv_matrix (the G of L_v(x) = |x G^T|) "
            "for a non-constant L_v; got {} with no model".format(
                type(lv).__name__) + _FALLBACK)
    g = np.atleast_2d(np.asarray(lv_matrix, dtype=np.float64))
    if g.shape[1] != d:
        raise ValueError("lv_matrix must have one column per state dim")
    return _linear_form(g, device), int(g.shape[0])


def _compile_lf(lf, lf_matrix, d, device):
    """The float64 ``L_f`` realization: a scalar, or a function of one
    column (``safe_learning_tpu/ops/extended_verify.py:968-1013``)."""
    if _is_scalar(lf):
        return _scalar_value(lf)
    if not callable(lf):
        raise NotImplementedError(
            "extended sweep needs a scalar L_f, or a callable with an "
            "lf_matrix model or a GradientNorm" + _FALLBACK)
    if lf_matrix is None and isinstance(lf, GradientNorm):
        if isinstance(lf.fun, NeuralNetwork):
            fn, dv = _gradnorm_spectral(lf, device)
        else:
            fn, dv = _gradnorm_pwl(lf, d, device)
        if dv != 1:
            raise NotImplementedError(
                "extended sweep needs a scalar L_f; use ord=1 or ord=inf "
                "on the GradientNorm" + _FALLBACK)
        return fn
    if lf_matrix is None:
        raise NotImplementedError(
            "extended sweep needs lf_matrix (the H of L_f(x) = |x H^T|) "
            "for a callable L_f; got {} with no model".format(
                type(lf).__name__) + _FALLBACK)
    h = np.atleast_2d(np.asarray(lf_matrix, dtype=np.float64))
    if h.shape != (1, d):
        raise ValueError("lf_matrix must be one row with one column per "
                         "state dim")
    return _linear_form(h, device)


# ---------------------------------------------------------------------------
# The instance's pieces
# ---------------------------------------------------------------------------
def _check_policy(policy):
    if isinstance(policy, Saturation):
        return _check_policy(policy.fun)
    if isinstance(policy, (LinearSystem, ConstantFunction, NeuralNetwork)):
        return
    raise NotImplementedError(
        "extended sweep supports LinearSystem/Saturation/Constant/"
        "NeuralNetwork policies; got {}".format(type(policy).__name__)
        + _FALLBACK)


def _check_candidate(v_fun):
    if isinstance(v_fun, MultipliedFunction):
        _, inner = v_fun.split_scalar_factor("extended sweep")
        return _check_candidate(inner)
    if isinstance(v_fun, (QuadraticFunction, Triangulation,
                          LyapunovNetwork, NeuralNetwork)):
        return
    raise NotImplementedError(
        "extended sweep supports QuadraticFunction / Triangulation / "
        "LyapunovNetwork / NeuralNetwork candidates (optionally scaled by "
        "a constant); got {}".format(type(v_fun).__name__) + _FALLBACK)


def _spotcheck(lyapunov, fn, matrix, what):
    """Fail loudly when a callable ``L_v`` or ``L_f`` disagrees with its
    linear model beyond 32 working units of the positive form
    ``|x| |M|^T`` (``safe_learning_tpu/ops/extended_verify.py:
    1595-1664``), at every grid state: the JAX package samples 256, which
    leaves the argument for the hybrid band open at the others.
    """
    if matrix is None or not callable(fn) or _is_scalar(fn):
        return
    grid = lyapunov.discretization
    m64 = np.array(np.atleast_2d(matrix), np.float64)
    m_t = torch.as_tensor(m64.T, device=config.device)
    m_abs_t = m_t.abs()
    worst = torch.zeros((), dtype=torch.float64, device=config.device)
    with torch.no_grad():
        for start in range(0, grid.nindex, 2 ** 18):
            pts = grid.states_in_range(start,
                                       min(start + 2 ** 18, grid.nindex))
            got = torch.as_tensor(fn(pts)).double()
            pts64 = pts.double()
            want = torch.matmul(pts64, m_t).abs()
            if got.reshape(-1).shape != want.reshape(-1).shape:
                worst = torch.full_like(worst, np.inf)
                break
            scale = torch.clamp(torch.matmul(pts64.abs(), m_abs_t),
                                min=1e-6)
            worst = torch.maximum(worst, ((got.reshape(want.shape) - want)
                                          .abs() / scale).max())
    if not float(worst) <= _model_reltol():
        raise ValueError(
            "{} does not reproduce the callable {} on the grid: the "
            "extended sweep would certify a different condition".format(
                "lv_matrix" if what == "L_v" else "lf_matrix", what))


class ExtendedSweep:
    """The float64 decrease check of one Lyapunov instance on the card.

    Construction makes the float64 copy (policy, dynamics, candidate) on
    ``config.device`` and the modelled ``L_v`` and ``L_f``; rebuild after
    any model change (``Lyapunov._get_extended_sweep`` keys it on the
    models' identities, the GP's count and the matrices).

    Parameters
    ----------
    lyapunov : Lyapunov
    lv_matrix : array (dv, d), optional
        The ``G`` of a callable ``L_v = |x G^T|``, spot-checked against the
        callable; derived when ``L_v`` is a ``GradientNorm`` of a quadratic
        or a callable of that form beside a quadratic candidate.
    lf_matrix : array (1, d), optional
        The ``H`` of a callable ``L_f = |x H^T|``.
    """

    def __init__(self, lyapunov, lv_matrix=None, lf_matrix=None):
        if lv_matrix is None:
            lv_matrix = _auto_lv_matrix(lyapunov)
        grid = lyapunov.discretization
        d = grid.ndim
        device = config.device
        self._d = d
        self._device = device
        self._tau = float(lyapunov.tau)
        self._unit_maxes = grid.unit_maxes

        dynamics = lyapunov.dynamics
        if isinstance(dynamics, FunctionStack):
            dynamics = coerce_stacked(dynamics)
            if isinstance(dynamics, FunctionStack):
                raise NotImplementedError(
                    "extended sweep: a FunctionStack of anything but "
                    "GaussianProcesses" + _FALLBACK)
        det = not isinstance(dynamics, (GaussianProcess,
                                        StackedGaussianProcess))
        if det and not isinstance(dynamics, (LinearSystem, InvertedPendulum,
                                             CartPole, VanDerPol)):
            raise NotImplementedError(
                "extended sweep supports GaussianProcess / "
                "StackedGaussianProcess or deterministic LinearSystem / "
                "InvertedPendulum / CartPole / VanDerPol dynamics; got "
                "{}".format(type(dynamics).__name__) + _FALLBACK)
        _check_policy(lyapunov.policy)
        _check_candidate(lyapunov.lyapunov_function)
        self._det = det

        # At tau == 0 with deterministic dynamics, L_v and L_f multiply
        # only the exactly zero threshold and there is no error term:
        # neither is evaluated (the CoRL-18 example's GradientNorm of a
        # LyapunovNetwork needs no model).
        self._requires_zero_tau = det and self._tau == 0.0
        if self._requires_zero_tau:
            self._lv, dv = 0.0, 1
            self._lf = 0.0
        else:
            self._lv, dv = _compile_lv(lyapunov._lipschitz_lyapunov,
                                       lv_matrix, d, device)
            _spotcheck(lyapunov, lyapunov._lipschitz_lyapunov, lv_matrix,
                       "L_v")
            self._lf = _compile_lf(lyapunov._lipschitz_dynamics, lf_matrix,
                                   d, device)
            _spotcheck(lyapunov, lyapunov._lipschitz_dynamics, lf_matrix,
                       "L_f")
        n_out = d if det else int(dynamics.output_dim)
        if dv not in (1, n_out):
            raise ValueError(
                "lv_matrix rows ({}) must be 1 or the number of dynamics "
                "outputs ({})".format(dv, n_out))

        self._policy = lift64(lyapunov.policy, device)
        self._dynamics = lift64(dynamics, device)
        self._v = lift64(lyapunov.lyapunov_function, device)

    # -- the pipeline ----------------------------------------------------
    def _tau_of(self, tau):
        tau = self._tau if tau is None else float(tau)
        if self._requires_zero_tau and tau != 0.0:
            raise ValueError(
                "this sweep was built for tau == 0 (L_v was elided from the "
                "zero threshold); rebuild with a nonzero instance tau to use "
                "one")
        return tau

    def _check(self, states, tau, margin):
        """``(negative, decrease, threshold)`` in float64 on the device:
        ``lyapunov._negative_batch`` on the float64 copy."""
        x = _f64(states, self._device)
        m = margin if np.ndim(margin) == 0 else _f64(margin, self._device)
        with _oracle_env(self._device):
            return _negative_batch(self._policy, self._dynamics, self._v,
                                   self._lv, self._lf, tau, x, m)

    def negative_batch(self, states, tau=None, margin=0.0):
        """Float64 decrease check ``decrease < threshold - margin`` at the
        states (exactly widened), a device bool ``(N,)``; ``margin`` is a
        number or a per-state ``(N,)`` array."""
        return self._check(states, self._tau_of(tau), margin)[0]

    def margins(self, states, tau=None):
        """Float64 ``decrease - threshold`` at ``states`` as a host array
        (a diagnostic: against ``oracle.oracle_margins`` it measures the
        extended pipeline's deviation)."""
        _, dec, thr = self._check(states, self._tau_of(tau), 0.0)
        return (dec - thr).cpu().numpy()

    def score_candidates(self, state_actions, c_max, margin=0.0):
        """Float64 exploration check at candidate rows (exactly widened):
        ``(score, inside, mean_next)`` on the device, the summed
        confidence width (the argmax criterion), whether ``v(mu) + sum_j
        |L_v_j| err_j < c_max - margin``, and the mean next state in the
        working dtype (for the safe-set membership test)."""
        if self._det:
            raise NotImplementedError(
                "extended exploration scoring needs uncertain (GP) "
                "dynamics: deterministic dynamics have no predictive "
                "variance to rank candidates by")
        sa = _f64(state_actions, self._device)
        with _oracle_env(self._device):
            mean, score, future = _future_values(self._dynamics, self._v,
                                                 self._lv, sa)
            inside = future < float(c_max) - float(margin)
        return score, inside, mean.to(config.dtype)

    def refined_negative_batch(self, states, max_refinement, margin=0.0):
        """Float64 check of every state's ``R^d`` sub-grid at ``tau / R``,
        ``(N,)``: every sub-point passes.

        The sub-points are made exactly as the working-dtype sweep makes
        them (``lyapunov.refinement_offsets`` added in ``states``' dtype),
        then widened; a per-state margin applies to all its sub-points.
        """
        r = int(max_refinement)
        tau = self._tau_of(None) / r
        states = torch.as_tensor(states)
        if not states.is_floating_point():
            states = states.to(config.dtype)
        offsets = refinement_offsets(self._unit_maxes, r, states)
        flat = (states[:, None, :] + offsets[None, :, :]).reshape(-1, self._d)
        if np.ndim(margin):
            margin = _f64(margin, self._device).repeat_interleave(
                offsets.shape[0])
        ok = self._check(flat, tau, margin)[0]
        return ok.reshape(states.shape[0], -1).all(dim=1)


def extended_gp_evaluate(gp, points):
    """``(mean, beta * std)`` of a GP in float64 on ``config.device``, as
    host float64 arrays: the posterior the extended sweep uses, alone."""
    gp64 = lift64(coerce_stacked(gp), config.device)
    with _oracle_env(config.device):
        mean, err = gp64.evaluate(_f64(points, config.device))
    return mean.cpu().numpy(), err.cpu().numpy()


# ---------------------------------------------------------------------------
# The derived margins at U_EFF
# ---------------------------------------------------------------------------
def _gradnorm_error_model(lv):
    """One-sided ``ErrorModel`` of an inflated ``GradientNorm`` program,
    valid only for the extended pipeline's realizations
    (``safe_learning_tpu/ops/extended_verify.py:1774-1858``).

    ``GradientNorm(NeuralNetwork)``: the baked spectral constant dominates
    the callable everywhere, so the unsound deviation is zero and the
    excess over the plain value is at most the constant.
    ``GradientNorm(Triangulation)``: the cell-maximum inflation inside the
    trigger band makes a disagreement of the locates conservative; the
    rest is rounding, relative to the neighbourhood's gradient magnitude,
    dilated by two cells per axis, with the input uncertainty capped at
    half the trigger band.
    """
    from scipy.ndimage import maximum_filter

    inner = lv.fun
    if isinstance(inner, NeuralNetwork):
        try:
            dv_c = _spectral_ord(lv)
        except NotImplementedError:
            return None
        if dv_c is None:
            return None
        dv, c = dv_c

        def zero(x):
            return torch.zeros((x.shape[0], dv), dtype=x.dtype,
                               device=x.device)

        def anchor(x):
            return torch.full((x.shape[0], dv), c, dtype=x.dtype,
                              device=x.device)

        return ErrorModel(zero, 0.0, anchor_bound=anchor)
    if not (isinstance(inner, Triangulation) and inner.output_dim == 1):
        return None
    ordv = lv.ord
    table, cells_shape, unit64 = _pwl_gradient_cell_table(inner)
    d = len(cells_shape)
    dil = maximum_filter(table, size=tuple([5] * d + [1]), mode="nearest")
    if ordv is None:
        red = dil
    elif np.isinf(ordv):
        red = dil.max(axis=-1, keepdims=True)
    elif ordv == 1:
        red = dil.sum(axis=-1, keepdims=True)
    else:
        return None
    n_cells = int(np.prod(cells_shape))
    table_dev = _tensor(red.reshape(n_cells, -1))
    lim64 = np.asarray(inner.discretization._limits, np.float64)
    off = _tensor(lim64[:, 0])
    inv_unit = _tensor(1.0 / unit64)
    top = torch.as_tensor(np.asarray(cells_shape) - 1, device=config.device)
    cell_strides = torch.as_tensor(row_major_strides(cells_shape),
                                   device=config.device)
    u = _u_eff()
    gam = (2 * d + 8) * u / (1.0 - (2 * d + 8) * u)

    def rows(x):
        cell = torch.minimum(torch.floor((x - off) * inv_unit)
                             .to(torch.int64).clamp(min=0), top)
        return table_dev[(cell * cell_strides).sum(dim=1)]

    def eval_bound(x):
        return gam * rows(x)

    return ErrorModel(eval_bound, 0.0, anchor_bound=rows,
                      max_input_shift=0.5 * _PWL_GRAD_DELTA * unit64)


class BandModelRefused(NotImplementedError):
    """The hybrid sweep's derived band has no float32 rounding model for
    the plain realization of ``L_v`` or ``L_f``; a measured band
    (``Lyapunov.hybrid_band_margin`` from
    ``oracle.calibrate_certificate_margin``) still applies."""


def hybrid_band_margin(lyapunov, lv_matrix=None, refinement=1, safety=1.0):
    """Derived per-state float32 margin of the hybrid sweep's band filter.

    ``update_safe_set(extended="hybrid")`` keeps every float32 verdict whose
    ``decrease - threshold`` clears this margin plus twice the extended
    margin, and re-checks the rest in float64. For the result to equal the
    full extended sweep's, the margin must bound the float32 pipeline's
    error two-sidedly at every state: ``analytic_certificate_margin`` at
    the working unit, per state, with ``L_v`` and ``L_f`` resolved as for
    :func:`extended_certificate_margin` at that unit
    (``safe_learning_tpu/ops/extended_verify.py:1942-1996``). Raises
    :class:`BandModelRefused` when the float32 realization of ``L_v`` or
    ``L_f`` has no model (a ``GradientNorm`` of a ``Triangulation`` without
    an installed matrix); at ``tau == 0`` with deterministic dynamics none
    is needed.
    """
    u32 = _unit_roundoff()
    lvm = lfm = None
    trivial = (_gp_members(lyapunov.dynamics) is None
               and float(lyapunov.tau) == 0.0)
    if not trivial:
        lv = lyapunov._lipschitz_lyapunov
        lvm = _lv_error_model(lyapunov, lv_matrix, u32)
        if lvm is None and callable(lv) and not _is_scalar(lv):
            raise BandModelRefused(
                "hybrid sweep: no float32 rounding model for the plain "
                "realization of this L_v (a GradientNorm of a Triangulation "
                "is modelled only for the extended pipeline's inflated "
                "program): install extended_lv_matrix, or run "
                "update_safe_set(extended=True)")
        lf = lyapunov._lipschitz_dynamics
        lfm = _lf_error_model(lyapunov, unit=u32)
        if lfm is None and callable(lf) and not _is_scalar(lf):
            raise BandModelRefused(
                "hybrid sweep: no float32 rounding model for the plain "
                "realization of this L_f: install extended_lf_matrix, or "
                "run update_safe_set(extended=True)")
    return analytic_certificate_margin(
        lyapunov, safety=safety, lipschitz_model=lvm, refinement=refinement,
        set_margin=False, lf_model=lfm, per_point=True)


def extended_exploration_margin(lyapunov, perturbations=None, actions=None,
                                limits=None, safety=1.0, lv_matrix=None,
                                set_margin=True, candidates=None):
    """Derived exploration margin at :data:`U_EFF` for the float64 scorer:
    ``analytic_exploration_margin`` over the given candidate rows (what
    ``get_safe_sample(extended=True)`` derives per call) or over every
    candidate the sampler can build, installed as
    ``lyapunov.exploration_margin`` and tagged with the unit
    (``safe_learning_tpu/ops/extended_verify.py:1999-2024``)."""
    return analytic_exploration_margin(
        lyapunov, perturbations=perturbations, actions=actions,
        limits=limits, safety=safety,
        lipschitz_model=_lv_error_model(lyapunov, lv_matrix, _u_eff()),
        unit_roundoff=_u_eff(), set_margin=set_margin,
        candidates=candidates)


def _level_error32(lyapunov):
    """``(err32, v_mag)``: a bound on the float32 candidate values' error
    over the grid and the values' scale, for the level margin
    (``safe_learning_tpu/ops/extended_verify.py:2064-2121``): closed forms
    for a quadratic and a ``Triangulation`` (exact on its own grid), the
    candidate's rounding rule over the grid otherwise."""
    v_fun = lyapunov.lyapunov_function
    grid = lyapunov.discretization
    d = grid.ndim
    u32s = (float(np.finfo(np.float32).eps) / 2.0
            * float(config.fp_error_factor))
    if isinstance(v_fun, QuadraticFunction):
        # x^T P x over the box: 2d + 2 roundings against |x|^T |P| |x|,
        # largest at the per-dimension |corner|.
        corner = np.max(np.abs(np.asarray(grid.limits, np.float64)), axis=1)
        p_abs = np.abs(_np64(v_fun.matrix))
        v_mag = float(corner @ p_abs @ corner)
        n_ops = 2 * d + 2
        return n_ops * u32s / (1.0 - n_ops * u32s) * v_mag, v_mag
    if isinstance(v_fun, Triangulation):
        theta = _np64(v_fun.parameters)[:, 0]
        v_mag = float(np.max(np.abs(theta))) or 1.0
        if v_fun.discretization == grid:
            # The ranking values are the table itself
            # (Lyapunov._direct_grid_values).
            return 0.0, v_mag
        grid_v = v_fun.discretization
        shape = tuple(int(n) for n in grid_v.shape)
        vals_nd = theta.reshape(shape)
        unit_v = np.asarray(grid_v.unit_maxes, np.float64)
        g_per_dim = np.array([
            (float(np.max(np.abs(np.diff(vals_nd, axis=ax))))
             if shape[ax] > 1 else 0.0) / unit_v[ax] for ax in range(d)])
        corner = np.max(np.abs(np.asarray(grid.limits, np.float64)), axis=1)
        off_abs = np.abs(np.asarray(grid_v.offset, np.float64))
        delta32 = 3.0 * u32s * (corner + off_abs)
        n_ops = 3 * d + 10
        gam32 = n_ops * u32s / (1.0 - n_ops * u32s)
        w_sum = 1.0 + 2.0 * float(np.sum(delta32 / unit_v))
        return (gam32 * (d + 1) * v_mag * w_sum
                + 2.0 * float(g_per_dim @ delta32)), v_mag
    rule = _candidate_model(v_fun, d, u32s)
    err32 = v_mag = torch.zeros((), dtype=torch.float64,
                                device=config.device)
    with torch.no_grad():
        for start in range(0, grid.nindex, 2 ** 14):
            pts = grid.states_in_range(start,
                                       min(start + 2 ** 14, grid.nindex))
            mag, err = rule(pts, pts.abs(), torch.zeros_like(pts))
            err32 = torch.maximum(err32, err.max().double())
            v_mag = torch.maximum(v_mag, mag.abs().max().double())
    err32, v_mag = torch.stack([err32, v_mag]).tolist()
    return err32, (v_mag or 1.0)


def extended_certificate_margin(lyapunov, lv_matrix=None, refinement=1,
                                safety=1.0, set_margin=True,
                                per_point=False, batch_size=2 ** 14):
    """Derived conservative margin of the extended sweep.

    ``analytic_certificate_margin`` at ``unit_roundoff = U_EFF``, with
    ``L_v`` and ``L_f`` resolved at that unit (a ``GradientNorm`` of a
    ``Triangulation`` or a network by its inflated program's model), and a
    float32-scale level margin: the level cut compares the float32 values
    whatever checked the decrease, so that guard stays at the float32 unit
    (:func:`_level_error32`). With ``set_margin`` both are installed, the
    margin tagged with ``U_EFF`` (the plain sweeps refuse it), and a given
    ``lv_matrix`` becomes ``lyapunov.extended_lv_matrix``. Returns the
    decrease margin (per state with ``per_point``)
    (``safe_learning_tpu/ops/extended_verify.py:2027-2133``).
    ``batch_size`` is the bound sweep's states a device pass.
    """
    u = _u_eff()
    margin = analytic_certificate_margin(
        lyapunov, safety=safety,
        lipschitz_model=_lv_error_model(lyapunov, lv_matrix, u),
        refinement=refinement, set_margin=False, unit_roundoff=u,
        lf_model=_lf_error_model(lyapunov, unit=u), per_point=per_point,
        batch_size=batch_size)
    err32, v_mag = _level_error32(lyapunov)
    eps32 = float(np.finfo(np.float32).eps)
    level_margin = max(2.0 * float(safety) * err32, 4.0 * eps32 * v_mag)
    if set_margin:
        lyapunov.certificate_margin = margin
        lyapunov.level_margin = level_margin
        lyapunov._certificate_margin_unit = u
        if lv_matrix is not None:
            lyapunov.extended_lv_matrix = lv_matrix
    return margin
