"""Derived forward-error bounds for the working-dtype verification pipeline.

Counterpart of ``safe_learning_tpu/errorbounds.py``.
:func:`~safe_learning_tpu_torch.oracle.calibrate_certificate_margin`
*measures* the pipeline's error on a grid subsample; this module *derives*
a bound on it, a per-instance Higham-style rounding-error analysis of the
decrease-condition pipeline (policy -> GP posterior -> Lyapunov values ->
threshold) evaluated at every grid point, and at every refined sub-point
of the adaptive sweep on request, so that the installed margin dominates
the working-dtype error at every checked point by construction.

The analysis is the JAX package's, term for term (Higham, *Accuracy and
Stability of Numerical Algorithms*, ch. 3): every scalar operation is
exact up to a relative error ``u``, and an inner product of length ``n``
errs by at most ``gamma_n = n u / (1 - n u)`` of the sum of absolute
products, for any summation order. So the bound covers the kernels' own
orders: kernel 1's tiled solve and the 64-row panels of kernels 2 and 3
above 128 rows (``csrc/``). The kernel entry is modelled on the cancelling
``xx - 2 cross + zz`` form of ``functions/gp.py:_sqdist``; the kernels'
per-dimension differences are better conditioned, so the same bound holds
for both routes. Only the unit and its precondition are the card's:

- ``u = config.fp_error_factor * eps / 2`` of the working dtype. On the
  H100 the largest single charge of the model is a transcendental or
  torch's composite sigmoid, not a dot product (``config.py`` derives the
  factor; PERF.md lists every operation of the float32 path);
- the default unit REQUIRES full-precision float32 matmuls: TF32 off for
  cuBLAS and cuDNN and ``torch.get_float32_matmul_precision() ==
  "highest"``. TF32 keeps ten mantissa bits and voids the model; a
  ``RuntimeError`` enforces this (importing ``config`` sets all three);
- the bound sweep's own products run through
  :func:`~safe_learning_tpu_torch.functions.base.dot` on
  ``config.device``, and every magnitude anchor carries the two-sided
  slack ``|real| <= |anchor| + 2 error``;
- the cached GP factors are taken as the correct rounding of the float64
  factorization (``|C_32 - C_64| <= u |C_64|``): ``chol_inv`` and
  ``alpha`` come from the float64 host island. A GP advanced on the card
  by ``functions.gp._device_border_append`` has working-dtype factors and
  is refused.

Supported instances are the JAX package's: LinearSystem / Saturation /
Constant / NeuralNetwork (relu, tanh, sigmoid, linear) policies;
GaussianProcess / StackedGaussianProcess (or a FunctionStack of GPs) over
RBF, the Matern kernels, LinearKernel and their sums, products and
ActiveDims, with LinearSystem or no prior mean, or deterministic
LinearSystem / InvertedPendulum / CartPole / VanDerPol dynamics;
QuadraticFunction, Triangulation, LyapunovNetwork and scalar
NeuralNetwork candidates, each optionally scaled by a constant; a scalar
or modelled ``L_f``; a constant ``L_v``, one of the row-wise linear form
``|x G^T|`` (derived automatically), or an explicit :class:`ErrorModel`.
Anything else raises ``NotImplementedError``: the measured calibrator
covers it. The ``GradientNorm`` of a ``Triangulation`` or a network as
``L_v`` or ``L_f`` has a model only in the extended pipeline (ROADMAP
queue 1 item 18) and raises here.
"""

from __future__ import annotations

import itertools
from collections import namedtuple

import numpy as np
import torch

from .config import config
from .dynamics import GRAVITY, CartPole, InvertedPendulum, VanDerPol
from .functions.base import (ConstantFunction, FunctionStack, GradientNorm,
                             MultipliedFunction, Saturation, dot)
from .functions.gp import (RBF, ActiveDims, GaussianProcess, LinearKernel,
                           Matern12, Matern32, Matern52, ProductKernel,
                           StackedGaussianProcess, SumKernel,
                           _StationaryKernel)
from .functions.linear import LinearSystem, QuadraticFunction
from .functions.neural import LyapunovNetwork, NeuralNetwork
from .functions.simplex import Triangulation
from .lyapunov import _as_column_batch

__all__ = ["ErrorModel", "analytic_certificate_margin",
           "analytic_exploration_margin"]

#: Rounding model of an opaque function used as ``L_v`` or ``L_f``.
#: ``eval_bound(x) -> (N, dv)`` bounds the realization's deviation in the
#: unsound direction (for symmetric rounding, the absolute evaluation
#: error); ``input_lipschitz`` bounds the function's own Lipschitz constant
#: (a scalar or per dimension). ``anchor_bound(x) -> (N, dv)`` bounds a
#: one-sided excess of an inflated realization over the plain evaluation
#: and ``max_input_shift`` caps, per dimension, the input uncertainty under
#: which the inflation holds (``safe_learning_tpu/errorbounds.py:104-123``).
ErrorModel = namedtuple(
    "ErrorModel",
    ["eval_bound", "input_lipschitz", "anchor_bound", "max_input_shift"],
    defaults=[None, None])

# max_t sqrt(t) e^{-t/2} (at t = 1): the peak of the RBF derivative
# magnitude, for the input-perturbation Lipschitz bounds.
_MAX_STE = float(np.exp(-0.5))

# The Matern kernels k = v g(r), r = sqrt(c t): (c, max_r |g'(r)|).
_MATERN = {
    Matern12: (1.0, 1.0),                      # g = e^{-r}
    Matern32: (3.0, float(np.exp(-1.0))),      # g' = -r e^{-r}
    Matern52: (5.0, 0.2801),                   # g' = -(r + r^2) e^{-r}/3
}


def _require_full_fp32():
    """Refuse the default unit when float32 matmuls may run in TF32."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the derived margins' rounding model requires full float32 "
            "matmuls: torch.backends.cuda.matmul.allow_tf32 and "
            "torch.backends.cudnn.allow_tf32 False and "
            "torch.get_float32_matmul_precision() == 'highest' (TF32 keeps "
            "ten mantissa bits and voids the bound)")


def _unit_roundoff():
    """Unit roundoff of the working dtype times ``config.fp_error_factor``."""
    base = float(np.finfo(config.np_dtype).eps) / 2.0
    return base * float(config.fp_error_factor)


def _resolve_unit(unit_roundoff):
    """The analysis' unit: an explicit one, or the default after the
    full-float32 precondition."""
    if unit_roundoff is None:
        _require_full_fp32()
        return _unit_roundoff()
    return float(unit_roundoff)


def _gamma(n, u):
    """Higham's ``gamma_n`` (valid for any summation order)."""
    nu = float(n) * u
    if nu >= 1.0:
        raise ValueError("accumulation length too large for the dtype")
    return nu / (1.0 - nu)


def _tensor(value):
    """``value`` (array, tensor or number) in the working dtype on
    ``config.device``."""
    if torch.is_tensor(value):
        return value.detach().to(device=config.device, dtype=config.dtype)
    return torch.as_tensor(np.array(value, dtype=np.float64),
                           dtype=config.dtype, device=config.device)


def _np64(value):
    """Host float64 copy of a tensor, array or number."""
    if torch.is_tensor(value):
        return value.detach().cpu().double().numpy()
    return np.asarray(value, dtype=np.float64)


def _scalar(value):
    """A one-element tensor, array or number as a Python float."""
    return float(_np64(value).reshape(()))


def _shift_frac(dvec, cap):
    """Largest input shift as a fraction of an inflated-realization L
    model's headroom (``ErrorModel.max_input_shift``)."""
    return torch.max(dvec / _tensor(cap)[None, :])


def _linear_core(fn):
    """Unwrap a LinearSystem-family function to its matrix, or None."""
    if isinstance(fn, Saturation):
        fn = fn.fun
    if isinstance(fn, LinearSystem):
        return fn.matrix
    return None


# ---------------------------------------------------------------------------
# Interval scaffolding: (value, error) pairs under the Higham model
# ---------------------------------------------------------------------------
# An "iv" is a tuple ``(v, e)`` of same-shape tensors: ``v`` is the bound
# sweep's own working-dtype value, the magnitude anchor, and ``e`` bounds
# ``|y_any - y_exact|`` for ANY realization rounding at ``u`` per op,
# evaluated at any input within the tracked input uncertainty, against the
# exact value of the stored parameters. Every rule keeps the anchor
# invariant ``|y_any| <= |v| + 2 e`` (one ``e`` to the exact value, one more
# to any other realization).
def _iv_hi(a):
    """Anchor on |any realization| of an interval."""
    return a[0].abs() + 2.0 * a[1]


def _iv_add(a, b, u):
    return (a[0] + b[0],
            a[1] + b[1] + u * (_iv_hi(a) + _iv_hi(b)))


def _iv_mul(a, b, u):
    hi_b = _iv_hi(b)
    return (a[0] * b[0],
            a[1] * hi_b + (a[0].abs() + a[1]) * b[1]
            + u * _iv_hi(a) * hi_b)


def _iv_const_mul(a, c, u):
    """Multiply by an exactly stored constant (a tensor or a number)."""
    c_abs = abs(c)
    return a[0] * c, c_abs * a[1] + u * c_abs * _iv_hi(a)


def _iv_matmul(a, w, u, bias=None, dw=None):
    """``a @ w (+ bias)`` for an (N, m) interval and an (m, k) constant.

    ``dw`` adds a per-entry error of the parameters' construction (the
    on-the-fly ``W0^T W0 + eps I`` of a LyapunovNetwork layer).
    """
    w_abs = w.abs()
    v = dot(a[0], w)
    hi = _iv_hi(a)
    anchor = dot(hi, w_abs)
    e = dot(a[1], w_abs)
    if dw is not None:
        e = e + dot(hi, dw)
    if bias is not None:
        v = v + bias[None, :]
        anchor = anchor + bias.abs()[None, :]
    e = e + _gamma(w.shape[0] + (2 if bias is not None else 1), u) * anchor
    return v, e


def _iv_sin(a, u):
    """sin is 1-Lipschitz and |sin| <= 1 (the same rule serves cos).

    ``u * mag`` charges the output's rounding and ``u * arg`` an argument
    reduction's absolute error, which scales with ``|x|``
    (``safe_learning_tpu/errorbounds.py:236-259``). CUDA's ``sinf`` and
    ``cosf`` err by at most 2 ulp over the whole range, reduction
    included, which ``u`` at ``config.fp_error_factor >= 4`` covers.
    """
    v = torch.sin(a[0])
    mag = torch.clamp(v.abs() + 2.0 * a[1], max=1.0)
    arg = a[0].abs() + 2.0 * a[1]
    return v, torch.clamp(a[1], max=2.0) + u * (mag + arg)


def _iv_cos(a, u):
    v = torch.cos(a[0])
    mag = torch.clamp(v.abs() + 2.0 * a[1], max=1.0)
    arg = a[0].abs() + 2.0 * a[1]
    return v, torch.clamp(a[1], max=2.0) + u * (mag + arg)


def _iv_div(a, b, u):
    """``a / b``; an infinite error when the denominator interval may reach
    0 (the caller's finiteness check turns that into a loud failure)."""
    b_lo = b[0].abs() - 2.0 * b[1]
    b_safe = torch.clamp(b_lo, min=1e-30)
    q = a[0] / b[0]
    qmag = _iv_hi(a) / b_safe
    e = (a[1] / b_safe
         + (a[0].abs() + a[1]) * b[1] / b_safe ** 2
         + u * qmag)
    return q, torch.where(b_lo > 0.0, e, torch.full_like(e, np.inf))


#: Activation rules ``name -> (fn, input Lipschitz, |output| cap)``. relu is
#: exact in floating point and 1-Lipschitz, so the error passes unchanged.
_IV_ACTS = {
    None: None, "linear": None,
    "relu": (torch.relu, 1.0, None),
    "tanh": (torch.tanh, 1.0, 1.0),
    "sigmoid": (torch.sigmoid, 0.25, 1.0),
}


def _iv_activation(a, name, u):
    if name is None or name == "linear":
        return a
    try:
        rule = _IV_ACTS[name]
    except (KeyError, TypeError):
        raise NotImplementedError(
            "analytic margin supports relu/tanh/sigmoid/linear "
            "activations; got {!r} — use the empirical calibrator"
            .format(name))
    fn, lip, cap = rule
    v = fn(a[0])
    if name == "relu":
        return v, a[1]
    # |in_any - v| <= 2 e, so |act(in_any)| <= |act(v)| + 2 lip e, capped.
    mag = v.abs() + 2.0 * lip * a[1]
    if cap is not None:
        mag = torch.clamp(mag, max=cap)
    return v, lip * a[1] + u * mag


def _mlp_program(net, u):
    """Interval forward pass of a :class:`NeuralNetwork`:
    ``fn((pts, dx)) -> (acts, du)``, the working-dtype output and a bound
    on ``|u_any(x') - u_exact(x)|`` for any realization at ``|x' - x| <=
    dx``."""
    acts = list(net.nonlinearities)
    for name in acts:
        if not (name is None or (isinstance(name, str)
                                 and name in _IV_ACTS)):
            raise NotImplementedError(
                "analytic margin supports relu/tanh/sigmoid/linear "
                "activations; got {!r}".format(name))
    scale = float(net.output_scale)
    weights = [_tensor(w) for w in net.weights]
    biases = [None if b is None else _tensor(b) for b in net.biases]

    def fn(x_iv):
        iv = x_iv
        for w, b, name in zip(weights, biases, acts):
            iv = _iv_activation(_iv_matmul(iv, w, u, bias=b), name, u)
        if scale != 1.0:
            iv = _iv_const_mul(iv, _tensor(scale), u)
        return iv
    return fn


def _policy_program(policy, u):
    """``fn((pts, dx)) -> (acts, du)`` for a supported policy."""
    if isinstance(policy, Saturation):
        inner = _policy_program(policy.fun, u)
        lo, hi = policy.lower, policy.upper
        if torch.is_tensor(lo):
            lo, hi = _tensor(lo), _tensor(hi)

        def fn_sat(x_iv):
            v, e = inner(x_iv)
            # clip is exact (min/max of representables) and 1-Lipschitz.
            return torch.clamp(v, lo, hi), e
        return fn_sat

    if isinstance(policy, LinearSystem):
        mat_t = _tensor(policy.matrix).T

        def fn_lin(x_iv):
            return _iv_matmul(x_iv, mat_t, u)
        return fn_lin

    if isinstance(policy, ConstantFunction):
        cval = torch.atleast_2d(_tensor(policy.constant))

        def fn_const(x_iv):
            v = cval.expand(x_iv[0].shape[0], cval.shape[1])
            return v, torch.zeros_like(v)
        return fn_const

    if isinstance(policy, NeuralNetwork):
        return _mlp_program(policy, u)

    raise NotImplementedError(
        "analytic margin supports LinearSystem/Saturation/Constant/"
        "NeuralNetwork policies; got {} — use calibrate_certificate_margin"
        .format(type(policy).__name__))


def _det_dynamics_program(dyn, u):
    """Interval forward pass of deterministic dynamics ``f(x, u)``:
    ``fn((q, dq)) -> (next, d_next)`` over state-action rows, through the
    benchmark systems' denormalize -> inner Euler -> normalize chain
    (``dynamics._OdeDynamics.evaluate``) or a LinearSystem product. A
    cart-pole denominator interval that may reach zero gives an infinite
    bound."""
    if isinstance(dyn, LinearSystem):
        mat_t = _tensor(dyn.matrix).T

        def fn_lin(q_iv):
            return _iv_matmul(q_iv, mat_t, u)
        return fn_lin

    if not isinstance(dyn, (InvertedPendulum, VanDerPol, CartPole)):
        raise NotImplementedError(
            "analytic margin supports GaussianProcess / "
            "StackedGaussianProcess (uncertain) or LinearSystem / "
            "InvertedPendulum / CartPole / VanDerPol (deterministic) "
            "dynamics; got {} — use calibrate_certificate_margin"
            .format(type(dyn).__name__))

    steps = int(dyn.inner_euler_steps)
    dt_i = _tensor(float(dyn.dt) / steps)
    d = int(dyn.state_dim)
    has_act = int(dyn.action_dim) > 0
    norm = dyn._norm_arrays()
    if norm is None:
        tx = tu = itx = None
    else:
        tx64 = _np64(norm[0])
        tx = _tensor(tx64)
        itx = _tensor(1.0 / tx64)
        tu = None if norm[1] is None else _tensor(_np64(norm[1]))

    def col(iv, j):
        return iv[0][:, j:j + 1], iv[1][:, j:j + 1]

    def cat(ivs):
        return (torch.cat([p[0] for p in ivs], dim=1),
                torch.cat([p[1] for p in ivs], dim=1))

    def const(like, value):
        return torch.full_like(like, value), torch.zeros_like(like)

    if isinstance(dyn, InvertedPendulum):
        length = _scalar(dyn.length)
        gl = _tensor(GRAVITY / length)
        inertia = _scalar(dyn.mass) * length ** 2
        ii = _tensor(1.0 / inertia)
        fi = _tensor(_scalar(dyn.friction) / inertia)

        def ode_iv(x, a):
            ang, om = col(x, 0), col(x, 1)
            acc = _iv_add(
                _iv_add(_iv_const_mul(_iv_sin(ang, u), gl, u),
                        _iv_const_mul(om, -fi, u), u),
                _iv_const_mul(a, ii, u), u)
            return cat([om, acc])

    elif isinstance(dyn, VanDerPol):
        damp = _tensor(_scalar(dyn.damping))
        one = _tensor(1.0)

        def ode_iv(x, a):
            del a
            xx, yy = col(x, 0), col(x, 1)
            x_dot = _iv_const_mul(yy, -one, u)
            x2m1 = _iv_add(_iv_mul(xx, xx, u), const(xx[0], -1.0), u)
            y_dot = _iv_add(
                xx, _iv_const_mul(_iv_mul(x2m1, yy, u), damp, u), u)
            return cat([x_dot, y_dot])

    else:  # CartPole
        m = _scalar(dyn.pendulum_mass)
        big_m = _scalar(dyn.cart_mass)
        length = _scalar(dyn.length)
        b = _scalar(dyn.rot_friction)
        mp = _tensor(m)
        lp = _tensor(length)
        bml = _tensor(b * (m + big_m) / (m * length))
        bp = _tensor(b)
        mg = _tensor((m + big_m) * GRAVITY)
        mgl_half = _tensor(0.5 * m * GRAVITY * length)
        ml_half = _tensor(0.5 * m * length)

        def ode_iv(x, a):
            theta, v, om = col(x, 1), col(x, 2), col(x, 3)
            sin_t = _iv_sin(theta, u)
            cos_t = _iv_cos(theta, u)
            sin_2t = _iv_sin(_iv_const_mul(theta, 2.0, 0.0), u)
            om2 = _iv_mul(om, om, u)
            det = _iv_const_mul(
                _iv_add(const(sin_t[0], big_m),
                        _iv_const_mul(_iv_mul(sin_t, sin_t, u), mp, u),
                        u), lp, u)
            v_num = _iv_add(
                _iv_add(
                    a,
                    _iv_const_mul(
                        _iv_mul(_iv_const_mul(om2, 2.0, 0.0),
                                sin_t, u), -ml_half, u), u),
                _iv_add(
                    _iv_const_mul(_iv_mul(om, cos_t, u), -bp, u),
                    _iv_const_mul(sin_2t, mgl_half, u), u), u)
            v_dot = _iv_div(_iv_const_mul(v_num, lp, u), det, u)
            om_num = _iv_add(
                _iv_add(
                    _iv_mul(a, cos_t, u),
                    _iv_const_mul(_iv_mul(om2, sin_2t, u),
                                  -ml_half, u), u),
                _iv_add(_iv_const_mul(om, -bml, u),
                        _iv_const_mul(sin_t, mg, u), u), u)
            om_dot = _iv_div(om_num, det, u)
            return cat([v, om, v_dot, om_dot])

    def fn(q_iv):
        x = (q_iv[0][:, :d], q_iv[1][:, :d])
        if has_act:
            a = (q_iv[0][:, d:], q_iv[1][:, d:])
        else:
            a = (torch.zeros((q_iv[0].shape[0], 1), dtype=config.dtype,
                             device=config.device),) * 2
        if tx is not None:
            x = _iv_const_mul(x, tx[None, :], u)
        if tu is not None and has_act:
            a = _iv_const_mul(a, tu[None, :], u)
        for _ in range(steps):
            dxdt = ode_iv(x, a)
            x = _iv_add(x, _iv_const_mul(dxdt, dt_i, u), u)
        if itx is not None:
            x = _iv_const_mul(x, itx[None, :], u)
        return x
    return fn


# ---------------------------------------------------------------------------
# L_v and L_f models
# ---------------------------------------------------------------------------
def _model_reltol():
    """Tolerance of the L_v probe: 32 units on the positive form. The same
    32 units are added back into the linear-form models below, so any
    callable the probe admits deviates from the form by less than the
    models derive (``safe_learning_tpu/ops/extended_verify.py:
    1595-1611``)."""
    return 32.0 * _unit_roundoff()


def _probe_lv(lyapunov, lv_matrix):
    """Whether the callable ``L_v`` reproduces ``|x G^T|`` on a seeded
    sample of 256 grid states, within :func:`_model_reltol` of the positive
    form ``|x| |G|^T`` (the port's own copy of the JAX package's
    ``ExtendedSweep._spotcheck_lv``)."""
    lv = lyapunov._lipschitz_lyapunov
    grid = lyapunov.discretization
    rng = np.random.default_rng(0)
    idx = rng.choice(grid.nindex, size=min(grid.nindex, 256), replace=False)
    pts = np.asarray(grid.points_at(idx), dtype=config.np_dtype)
    got = _np64(lv(_tensor(pts)))
    g64 = np.asarray(lv_matrix, np.float64)
    pts64 = pts.astype(np.float64)
    want = np.abs(pts64 @ g64.T)
    got = got.reshape(len(pts), -1)
    scale = np.maximum(np.abs(pts64) @ np.abs(g64).T, 1e-6)
    return got.shape == want.shape and np.max(
        np.abs(got - want) / scale) <= _model_reltol()


def _auto_lv_matrix(lyapunov):
    """The matrix ``G`` of an ``L_v`` of the row-wise form ``|x G^T|``, or
    None (``safe_learning_tpu/ops/extended_verify.py:608-647``).

    ``GradientNorm(QuadraticFunction, ord=None)`` is that form with ``G = P
    + P^T``; a generic callable ``L_v`` beside a quadratic candidate (the
    ``2|Px|`` pattern) is probed against it (:func:`_probe_lv`).
    """
    lv = lyapunov._lipschitz_lyapunov
    if (isinstance(lv, GradientNorm) and lv.ord is None
            and isinstance(lv.fun, QuadraticFunction)):
        pm = _np64(lv.fun.matrix)
        return pm + pm.T
    if (callable(lv)
            and not isinstance(lv, (ConstantFunction, GradientNorm))
            and isinstance(lyapunov.lyapunov_function, QuadraticFunction)):
        pm = _np64(lyapunov.lyapunov_function.matrix)
        g = pm + pm.T
        return g if _probe_lv(lyapunov, g) else None
    return None


def _refuse_gradient_norm(what):
    raise NotImplementedError(
        "the GradientNorm of a non-quadratic function as {} has a rounding "
        "model only in the extended pipeline (ROADMAP queue 1 item 18); "
        "pass an ErrorModel or use oracle.calibrate_certificate_margin"
        .format(what))


def _linear_form_model(matrix, d, unit):
    """``ErrorModel`` of ``|x M^T|`` evaluated by the plain pipeline: the
    ``(d + 2)``-op product at ``unit`` plus the probe's 32-unit slack."""
    m = np.atleast_2d(np.asarray(matrix, dtype=np.float64))
    m_abs_t = _tensor(np.abs(m).T)
    gam = (d + 2) * unit / (1.0 - (d + 2) * unit) + 32.0 * unit

    def eval_bound(x):
        return dot(gam * x.abs(), m_abs_t)

    return ErrorModel(eval_bound, float(np.max(np.sum(np.abs(m), axis=1))))


def _lv_error_model(lyapunov, lv_matrix, unit):
    """Rounding model of the instance's ``L_v`` at ``unit``, or None
    (``safe_learning_tpu/ops/extended_verify.py:1861-1907`` at the plain
    unit). ``lv_matrix`` defaults to :func:`_auto_lv_matrix`, then to an
    installed ``extended_lv_matrix``."""
    if lv_matrix is None:
        lv_matrix = _auto_lv_matrix(lyapunov)
    if lv_matrix is None:
        lv_matrix = getattr(lyapunov, "extended_lv_matrix", None)
    if lv_matrix is None:
        if isinstance(lyapunov._lipschitz_lyapunov, GradientNorm):
            _refuse_gradient_norm("L_v")
        return None
    return _linear_form_model(lv_matrix, lyapunov.discretization.ndim, unit)


def _lf_error_model(lyapunov, lf_matrix=None, unit=None):
    """Rounding model of a callable ``L_f`` at ``unit``, or None (a scalar
    needs none; ``safe_learning_tpu/ops/extended_verify.py:1910-1939``).
    ``lf_matrix`` defaults to an installed ``extended_lf_matrix``."""
    lf = lyapunov._lipschitz_dynamics
    if not callable(lf) or isinstance(lf, ConstantFunction):
        return None
    if lf_matrix is None:
        lf_matrix = getattr(lyapunov, "extended_lf_matrix", None)
    if lf_matrix is None:
        if isinstance(lf, GradientNorm):
            _refuse_gradient_norm("L_f")
        return None
    return _linear_form_model(lf_matrix, lyapunov.discretization.ndim, unit)


def _lv_model(lyapunov, lipschitz_model, u):
    """Resolve the ``L_v`` rounding model: an explicit one; a constant
    (exact, zero error); or a derivable linear form."""
    if lipschitz_model is not None:
        return lipschitz_model
    lv = lyapunov._lipschitz_lyapunov
    if isinstance(lv, (int, float, ConstantFunction)):
        # A constant's "evaluation" is an exact broadcast.
        return ErrorModel(lambda x: torch.zeros((x.shape[0], 1),
                                                dtype=x.dtype,
                                                device=x.device), 0.0)
    model = _lv_error_model(lyapunov, None, u)
    if model is not None:
        return model
    raise NotImplementedError(
        "analytic margin needs an ErrorModel for non-constant L_v "
        "functions with no derivable linear-form model (pass "
        "lipschitz_model=...; the measured "
        "oracle.calibrate_certificate_margin covers any callable); got "
        "{}".format(type(lv).__name__))


# ---------------------------------------------------------------------------
# Candidate and kernel programs
# ---------------------------------------------------------------------------
def _candidate_model(v_fun, d, u):
    """Per-point magnitude and error rule of the Lyapunov candidate:
    ``v_mag_err(y, y_abs, dy) -> (mag, err)``, an anchor on ``|v_any(y')|``
    and a bound on ``|v_any(y') - v_exact(y)|`` for any realization at any
    ``|y' - y| <= dy`` (``safe_learning_tpu/errorbounds.py:562-704``:
    the quadratic chain of 2d + 2 roundings; a Triangulation's barycentric
    arithmetic with per-dimension gradient bounds absorbing the input
    uncertainty, the coordinate rounding and cell misassignment; a
    constant factor; a LyapunovNetwork's on-the-fly layer kernels; a
    scalar MLP)."""
    if isinstance(v_fun, QuadraticFunction):
        p_abs = _tensor(v_fun.matrix).abs()
        p_sym = p_abs + p_abs.T
        g_quad = _gamma(2 * d + 2, u)

        def v_mag_err(y, y_abs, dy):
            mag = (dot(y_abs, p_abs) * y_abs).sum(dim=1)
            err = ((dot(dy, p_sym) * (y_abs + dy)).sum(dim=1)
                   + g_quad * mag)
            return mag, err
        return v_mag_err

    if isinstance(v_fun, Triangulation):
        if v_fun.output_dim != 1:
            raise NotImplementedError(
                "analytic margin needs a scalar PWL candidate")
        grid_v = v_fun.discretization
        if grid_v.ndim != d:
            raise ValueError("candidate grid dimension mismatch")
        theta = _np64(v_fun.parameters)[:, 0]
        theta_max = float(np.max(np.abs(theta))) or 1.0
        shape = tuple(int(n) for n in grid_v.shape)
        vals_nd = theta.reshape(shape)
        unit = np.asarray(grid_v.unit_maxes, dtype=np.float64)
        g_per_dim = np.array([
            (float(np.max(np.abs(np.diff(vals_nd, axis=ax))))
             if shape[ax] > 1 else 0.0) / unit[ax]
            for ax in range(d)])
        g_dev = _tensor(g_per_dim)
        off_abs = _tensor(np.abs(np.asarray(grid_v.offset, np.float64)))
        limits = np.asarray(grid_v.limits, np.float64)
        lo, hi = _tensor(limits[:, 0]), _tensor(limits[:, 1])
        g_w = _gamma(3 * d + 10, u) * (d + 1)
        inv_unit = _tensor(1.0 / unit)

        def v_mag_err(y, y_abs, dy):
            out = (torch.clamp(lo[None, :] - y, min=0.0)
                   + torch.clamp(y - hi[None, :], min=0.0))
            delta = dy + 3.0 * u * (y_abs + off_abs[None, :])
            reach = out + delta
            # Value anchor: the located cell's linear extension.
            mag = theta_max + dot(reach, g_dev[:, None])[:, 0]
            # sum |w| <= 1 + 2 * out-of-cell excess in cell units.
            w_sum = 1.0 + 2.0 * dot(reach, inv_unit[:, None])[:, 0]
            err = (g_w * theta_max * w_sum
                   + 2.0 * dot(delta, g_dev[:, None])[:, 0])
            return mag, err
        return v_mag_err

    if isinstance(v_fun, MultipliedFunction):
        const, inner = v_fun.split_scalar_factor("analytic margin")
        inner_rule = _candidate_model(inner, d, u)
        c_abs = abs(_scalar(const.constant))

        def v_mag_err_scaled(y, y_abs, dy):
            mag, err = inner_rule(y, y_abs, dy)
            return c_abs * mag, c_abs * (err + u * (mag + 2.0 * err))
        return v_mag_err_scaled

    if isinstance(v_fun, LyapunovNetwork):
        # Each layer kernel W0^T W0 + eps I (+ free rows) is assembled in
        # the working dtype at every evaluation: gamma per entry (dw).
        layers = []
        in_dim = v_fun.input_dim
        for w0, w1 in zip(v_fun.posdef_weights, v_fun.extra_weights):
            w0_c = _np64(w0)
            kern = w0_c.T @ w0_c + v_fun.eps * np.eye(in_dim)
            gam_k = _gamma(w0_c.shape[0] + 2, u)
            dkern = gam_k * (np.abs(w0_c).T @ np.abs(w0_c)
                             + v_fun.eps * np.eye(in_dim))
            if w1 is not None:
                w1_c = _np64(w1)
                kern = np.vstack([kern, w1_c])
                dkern = np.vstack([dkern, u * np.abs(w1_c)])
            layers.append((_tensor(kern.T), _tensor(dkern.T)))
            in_dim = kern.shape[0]
        acts = list(v_fun.activations)

        def v_mag_err_lyapnet(y, y_abs, dy):
            iv = (y, dy)
            for (kern_t, dkern_t), name in zip(layers, acts):
                iv = _iv_activation(
                    _iv_matmul(iv, kern_t, u, dw=dkern_t), name, u)
            hi = _iv_hi(iv)
            mag = (hi * hi).sum(dim=1)
            # |a_any^2 - a_exact^2| <= (|a_any| + |a_exact|) e.
            err = (((hi + iv[0].abs() + iv[1]) * iv[1]).sum(dim=1)
                   + _gamma(hi.shape[1] + 1, u) * mag)
            return mag, err
        return v_mag_err_lyapnet

    if isinstance(v_fun, NeuralNetwork):
        if v_fun.output_dim != 1:
            raise NotImplementedError(
                "analytic margin needs a scalar NN candidate")
        prog = _mlp_program(v_fun, u)

        def v_mag_err_nn(y, y_abs, dy):
            v, e = prog((y, dy))
            return _iv_hi((v, e))[:, 0], e[:, 0]
        return v_mag_err_nn

    raise NotImplementedError(
        "analytic margin supports QuadraticFunction / Triangulation / "
        "LyapunovNetwork / NeuralNetwork candidates (optionally scaled "
        "by a constant); got {}".format(type(v_fun).__name__))


def _column_batch(vals, n_pts):
    """An ``L_v`` evaluation as ``(N, dv)``: the sweep's own shape rule
    (``lyapunov._as_column_batch``) plus the batch broadcast."""
    vals = _as_column_batch(vals)
    if not torch.is_tensor(vals):
        vals = _tensor(vals).reshape(1, 1)
    if vals.shape[0] == 1 and n_pts > 1:
        vals = vals.expand(n_pts, vals.shape[1])
    return vals


def _kernel_program(kernel, dims, u):
    """The per-pair kernel error program of a kernel node restricted to
    the full-input columns ``dims``: ``fn(X, q, dq) -> (val, dk, diag_abs,
    ddiag)``.

    ``val (cap, N)`` is the node's signed working-dtype value at ``q``;
    ``dk`` bounds ``|k_any(q') - k_exact(q)|`` for any realization at any
    ``|q' - q| <= dq``, evaluation rounding and input perturbation at once,
    keeping ``|k_any(q')| <= |val| + 2 dk``; ``diag_abs, ddiag (N,)`` are
    the same pair for ``k.diag(q)`` (``safe_learning_tpu/errorbounds.py:
    721-862``).
    """
    dims = np.asarray(dims, dtype=int)

    if isinstance(kernel, ActiveDims):
        return _kernel_program(kernel.kernel, dims[list(kernel.dims)], u)

    if isinstance(kernel, SumKernel):
        f1 = _kernel_program(kernel.k1, dims, u)
        f2 = _kernel_program(kernel.k2, dims, u)

        def fn_sum(x, q, dq):
            v1, d1, g1, e1 = f1(x, q, dq)
            v2, d2, g2, e2 = f2(x, q, dq)
            dk = d1 + d2 + u * (v1.abs() + 2.0 * d1 + v2.abs() + 2.0 * d2)
            ddiag = e1 + e2 + u * (g1 + 2.0 * e1 + g2 + 2.0 * e2)
            return v1 + v2, dk, g1 + g2, ddiag
        return fn_sum

    if isinstance(kernel, ProductKernel):
        f1 = _kernel_program(kernel.k1, dims, u)
        f2 = _kernel_program(kernel.k2, dims, u)

        def fn_prod(x, q, dq):
            v1, d1, g1, e1 = f1(x, q, dq)
            v2, d2, g2, e2 = f2(x, q, dq)
            big1 = v1.abs() + 2.0 * d1
            big2 = v2.abs() + 2.0 * d2
            dk = d1 * big2 + (v1.abs() + d1) * d2 + u * big1 * big2
            gb1 = g1 + 2.0 * e1
            gb2 = g2 + 2.0 * e2
            ddiag = e1 * gb2 + (g1 + e1) * e2 + u * gb1 * gb2
            return v1 * v2, dk, g1 * g2, ddiag
        return fn_prod

    if isinstance(kernel, _StationaryKernel):
        if isinstance(kernel, RBF):
            mat_c = mat_gp = 0.0
            deriv_const = _MAX_STE
        elif type(kernel) in _MATERN:
            mat_c, mat_gp = _MATERN[type(kernel)]
            deriv_const = float(np.sqrt(mat_c)) * mat_gp
        else:
            raise NotImplementedError(
                "analytic margin: unsupported stationary kernel {}"
                .format(type(kernel).__name__))
        m = len(dims)
        var = _scalar(kernel.variance)
        ls = np.broadcast_to(np.atleast_1d(_np64(kernel.lengthscales)), (m,))
        ls_dev = _tensor(ls)
        lip = _tensor(var * deriv_const / ls)
        g_sq = _gamma(3 * m + 8, u)
        cols = list(dims)

        def fn_stat(x, q, dq):
            xs = x[:, cols] / ls_dev
            qs = q[:, cols] / ls_dev
            dqs = dq[:, cols] / ls_dev
            xx = (xs * xs).sum(dim=1, keepdim=True)
            qq = (qs * qs).sum(dim=1)[None, :]
            cross_abs = dot(xs.abs(), qs.abs().T)
            s_mag = xx + 2.0 * cross_abs + qq
            # The real sweep rounds its squared distance at q', not q.
            ds = (2.0 * dot(xs.abs(), dqs.T)
                  + ((2.0 * qs.abs() + dqs) * dqs).sum(dim=1)[None, :])
            dt = g_sq * (s_mag + ds)
            val = kernel(x[:, cols], q[:, cols])
            dpert = dot(dq[:, cols], lip[:, None])[None, :, 0]
            grow = torch.expm1(0.5 * dt)
            # |k_exact(q')| <= |val| e^{dt/2} (1 + 4u) + dpert
            val_infl = val.abs() * (1.0 + grow) * (1.0 + 4.0 * u) + dpert
            if isinstance(kernel, RBF):
                dval = val_infl * grow + 4.0 * u * val_infl
            else:
                # |delta k| <= v max|g'| sqrt(c dt) absorbs the r ~ 0
                # derivative blow-up.
                dval = (var * mat_gp * torch.sqrt(mat_c * dt)
                        + 8.0 * u * val_infl)
            n_q = q.shape[0]
            return (val, dval + dpert,
                    torch.full((n_q,), var, dtype=q.dtype, device=q.device),
                    torch.full((n_q,), u * var, dtype=q.dtype,
                               device=q.device))
        return fn_stat

    if isinstance(kernel, LinearKernel):
        m = len(dims)
        cols = list(dims)
        vv = _tensor(np.broadcast_to(
            np.atleast_1d(_np64(kernel.variances)), (m,)))
        g_lin = _gamma(m + 2, u)

        def fn_lin(x, q, dq):
            xa = x[:, cols].abs() * vv           # (cap, m)
            qa = q[:, cols].abs()
            dqa = dq[:, cols]
            # anchors at the perturbed point: |q'| <= |q| + dq
            abs_dot = dot(xa, (qa + dqa).T)      # (cap, N)
            val = kernel(x[:, cols], q[:, cols])
            dpert = dot(xa, dqa.T)
            dval = g_lin * abs_dot
            diag_abs = (qa * qa * vv).sum(dim=1)
            ddiag = (g_lin * ((qa + dqa) ** 2 * vv).sum(dim=1)
                     + ((2.0 * qa + dqa) * vv * dqa).sum(dim=1))
            return val, dval + dpert, diag_abs, ddiag
        return fn_lin

    raise NotImplementedError(
        "analytic margin: unsupported kernel node {} — use "
        "calibrate_certificate_margin".format(type(kernel).__name__))


# ---------------------------------------------------------------------------
# GP terms
# ---------------------------------------------------------------------------
def _gp_statics(gp, u):
    """The per-GP constants of the analysis: a (possibly multi-output)
    :class:`GaussianProcess` over a supported kernel with a LinearSystem or
    no prior mean."""
    mean_mat = None
    if gp.mean_function is not None:
        mean_mat = _linear_core(gp.mean_function)
        if mean_mat is None:
            raise NotImplementedError(
                "analytic margin supports LinearSystem prior means; "
                "got {}".format(type(gp.mean_function).__name__))
        mean_mat = _tensor(mean_mat)
    nd = gp.input_dim
    return {
        "gp": gp, "mean_mat": mean_mat, "nd": nd,
        "s2": float(gp.scale) ** 2, "scale": float(gp.scale),
        "beta": float(gp.beta), "mask": gp._mask(),
        "chol_abs": gp.chol_inv.abs(), "alpha_abs": gp.alpha.abs(),
        "entry": _kernel_program(gp.kernel, np.arange(nd), u),
        "g_dot": _gamma(gp.capacity + 2, u),
        "g_mean": 0.0 if mean_mat is None else _gamma(nd + 1, u),
    }


def _gp_terms(st, q, dq, u):
    """Per-point GP posterior magnitudes and error bounds.

    ``dq`` is the ``(N, nd)`` input uncertainty. Returns ``(mu_hat, d_mu,
    err_hat, d_err)``, each ``(N, S)``: the working-dtype posterior mean
    and its error bound, and the confidence term ``beta * std`` and its
    bound (``safe_learning_tpu/errorbounds.py:896-965``).
    """
    gp = st["gp"]
    s2, scale = st["s2"], st["scale"]
    g_dot = st["g_dot"]
    mask = st["mask"][:, None]

    # Kernel entries: dk already holds the input perturbation, so the solve
    # chain carries rounding and coordinate uncertainty at once.
    val, dk_raw, diag_abs, ddiag = st["entry"](gp.X_buf, q, dq)
    kx = s2 * val * mask                                    # (cap, N)
    kx_abs = kx.abs()
    dk = (s2 * dk_raw + 4.0 * u * kx_abs) * mask

    # The solve chain.
    a_hat = dot(gp.chol_inv, kx)
    r = dot(st["chol_abs"], kx_abs + 2.0 * dk)
    da = dot(st["chol_abs"], dk) + (g_dot + u) * r
    a_tot = a_hat.abs() + 2.0 * da

    # The posterior mean per output, (N, S).
    e_mn = (dot(da.T, st["alpha_abs"])
            + (g_dot + 2.0 * u) * dot(a_tot.T, st["alpha_abs"]))
    mean_num = dot(a_hat.T, gp.alpha) / scale
    prior = 0.0 if gp.mean_function is None else gp.mean_function(q)
    mu_hat = mean_num + prior
    mean_mat = st["mean_mat"]
    e_prior = (0.0 if mean_mat is None
               else st["g_mean"] * dot(q.abs(), mean_mat.abs().T))
    d_mu = (e_mn / scale + u * mean_num.abs() + e_prior
            + 2.0 * u * mu_hat.abs())
    if mean_mat is not None:
        # Only the prior mean's own Lipschitz term is left of dq.
        d_mu = d_mu + dot(dq, mean_mat.abs().T)

    # The variance and the std.
    sum_a2 = (a_hat * a_hat).sum(dim=0)                     # (N,)
    var_hat = torch.clamp(gp.kernel.diag(q) - sum_a2 / s2, min=1e-12)
    d_sum_a2 = (2.0 * a_tot * da + g_dot * a_tot ** 2).sum(dim=0)
    d_var_tot = ((d_sum_a2 + u * sum_a2) / s2 + u * diag_abs + ddiag
                 + u * var_hat.abs())
    sig_hat = torch.sqrt(var_hat)
    sig_lo = torch.sqrt(torch.clamp(var_hat - d_var_tot, min=0.0))
    d_sig = torch.where(sig_lo > 0.0, d_var_tot / (sig_hat + sig_lo),
                        torch.sqrt(d_var_tot))
    n_out = mu_hat.shape[1]
    err_hat = (st["beta"] * sig_hat)[:, None].expand(q.shape[0], n_out)
    d_err = st["beta"] * d_sig[:, None] + 2.0 * u * err_hat
    return mu_hat, d_mu, err_hat, d_err


def _gp_members(dyn):
    """Per-output GP list of uncertain dynamics, or None: a stacked GP's
    views, a GP, or a FunctionStack whose members are all GPs. A GP whose
    factors were advanced on the card (``_device_border_append``) is
    refused: its factors are not the rounded float64 ones the model
    assumes."""
    if isinstance(dyn, StackedGaussianProcess):
        members = [dyn]
    elif isinstance(dyn, GaussianProcess):
        members = [dyn]
    elif (isinstance(dyn, FunctionStack) and dyn.functions
          and all(isinstance(f, GaussianProcess) for f in dyn.functions)):
        members = list(dyn.functions)
    else:
        return None
    if any(getattr(gp, "_device_appended", False) for gp in members):
        raise RuntimeError(
            "the GP's factors were appended on the device in the working "
            "dtype; derive margins only on a GP refreshed in float64 "
            "(add_data_point)")
    if isinstance(dyn, StackedGaussianProcess):
        return dyn.unstack()
    return members


def _finalize_margin(worst, statics, d, u, safety):
    """The worst bound made installable (``safe_learning_tpu/
    errorbounds.py:988-1016``): ``1 / (1 - 4u)`` for the comparison's own
    rounding, and ``1 + own`` for the bound sweep's own working-dtype
    rounding of its positive-sum circuit."""
    cap_total = sum(st["gp"].capacity for st in statics)
    u32_slack = (float(np.finfo(np.float32).eps) / 2.0
                 * float(config.fp_error_factor))
    own = _gamma(64 * (cap_total + d + 16), u32_slack)
    scale = float(safety) * (1.0 + own) / (1.0 - 4.0 * u)
    if np.ndim(worst):
        return np.asarray(worst, np.float64) * scale
    return float(worst) * scale


def _refinement_offsets(unit, refinement, d):
    """Offsets of the bound sweep's passes: zero, or the ``R^d`` sub-grid
    of a cell (and zero for even ``R``)."""
    if refinement == 1:
        return [np.zeros(d)]
    steps = (np.arange(refinement) + 0.5) / refinement - 0.5
    offsets = [np.array(c) * unit
               for c in itertools.product(steps, repeat=d)]
    if refinement % 2 == 0:
        # An odd R's lattice already holds the zero offset.
        offsets.append(np.zeros(d))
    return offsets


def analytic_certificate_margin(lyapunov, batch_size=2 ** 14, safety=1.0,
                                lipschitz_model=None, refinement=1,
                                set_margin=True, unit_roundoff=None,
                                lf_model=None, per_point=False):
    """Derived conservative margin of the working-dtype sweep.

    Sweeps the whole grid on ``config.device``, computing at every state a
    bound on ``|margin_dtype(x) - margin_exact(x)|`` under the model of the
    module docstring, and returns ``safety`` times its maximum (inflated by
    ``1 / (1 - 4u)`` for the comparison's own rounding). With
    ``set_margin`` it also installs the level margin, ``2 * safety *
    max |v - v_exact|`` or a floor of four ulps of the value scale, as
    :func:`~safe_learning_tpu_torch.oracle.calibrate_certificate_margin`
    does, and records the unit in ``_certificate_margin_unit``.

    Parameters
    ----------
    lyapunov : Lyapunov
    batch_size : int, optional
        Grid states per device pass of the bound sweep.
    safety : float, optional
        Multiplier on the derived bound (1.0 is rigorous under the model).
    lipschitz_model : ErrorModel, optional
        Rounding model of a non-constant ``L_v``.
    refinement : int, optional
        Also cover the ``R^d`` refined sub-points of every cell, as
        ``update_safe_set(max_refinement=R)`` checks them; their
        coordinates' working-dtype construction is propagated through the
        state dimensions (at the float32 unit, whatever ``unit_roundoff``).
    set_margin : bool, optional
        Install ``certificate_margin`` and ``level_margin``.
    unit_roundoff : float, optional
        The per-operation unit. The default (``None``) models the
        working-dtype sweep, ``eps / 2 * config.fp_error_factor``, and
        requires full-precision float32 matmuls (``RuntimeError``).
    lf_model : ErrorModel, optional
        Rounding model of a callable ``L_f`` (a scalar needs none).
    per_point : bool, optional
        Install and return the per-state margin array (the maximum over the
        state and its refined sub-points) instead of its maximum.

    Returns
    -------
    margin : float or (nindex,) ndarray
    """
    u = _resolve_unit(unit_roundoff)
    dyn = lyapunov.dynamics
    grid = lyapunov.discretization
    d = grid.ndim
    det_prog = None
    gp_list = _gp_members(dyn)
    if gp_list is None:
        gp_list = []
        det_prog = _det_dynamics_program(dyn, u)
    v_fun = lyapunov.lyapunov_function
    v_mag_err = _candidate_model(v_fun, d, u)
    tau = float(lyapunov.tau)

    lfm = None
    lf = 0.0
    lf_raw = lyapunov._lipschitz_dynamics
    if isinstance(lf_raw, ConstantFunction) and lf_raw.is_scalar():
        lf_raw = _scalar(lf_raw.constant)
    if isinstance(lf_raw, (int, float, np.floating, np.integer)):
        lf = float(lf_raw)
    elif det_prog is not None and tau == 0.0:
        # thr = -L_v (1 + L_f) * 0 == 0 in every realization: a callable
        # L_f multiplies nothing and needs no model.
        pass
    else:
        if lf_model is None:
            lf_model = _lf_error_model(lyapunov, unit=u)
        if lf_model is None:
            raise NotImplementedError(
                "analytic margin needs a scalar L_f, or an ErrorModel "
                "via lf_model for a callable one (the measured "
                "oracle.calibrate_certificate_margin covers any "
                "callable)")
        lfm = lf_model
        lf_lip = _tensor(lfm.input_lipschitz)

    pol_prog = _policy_program(lyapunov.policy, u)
    # At tau == 0 with deterministic dynamics L_v multiplies only the
    # exactly zero threshold and there is no error term: no L_v model.
    lv_trivial = det_prog is not None and tau == 0.0
    if lv_trivial:
        lvm = None
    else:
        lvm = _lv_model(lyapunov, lipschitz_model, u)
        lv_lip = _tensor(lvm.input_lipschitz)
    statics = [_gp_statics(gp, u) for gp in gp_list]
    lv_fun = lyapunov._lipschitz_lyapunov

    def _lv_at(x, n_pts):
        return _column_batch(lv_fun(x) if callable(lv_fun) else lv_fun,
                             n_pts)

    def _lv_err_at(x, n_pts):
        return _column_batch(lvm.eval_bound(x), n_pts)

    def _lv_anchor_at(x, n_pts):
        """One-sided excess of an inflated realization; 0 otherwise."""
        if lvm.anchor_bound is None:
            return 0.0
        return _column_batch(lvm.anchor_bound(x), n_pts)

    def batch_bound(pts, dx):
        """Per-state bound on ``|margin_dtype - margin_exact|`` (N,), the
        candidate-value error (for the level margin) and the largest input
        shift fraction of a headroom-capped L model."""
        n_pts = pts.shape[0]
        shift = torch.zeros((), dtype=pts.dtype, device=pts.device)
        acts, du = pol_prog((pts, dx))
        q = torch.cat([pts, acts], dim=1)
        dq = torch.cat([dx, du], dim=1)

        if det_prog is not None:
            mu_hat, d_mu = det_prog((q, dq))
            err_hat = d_err = None
        else:
            parts = [_gp_terms(st, q, dq, u) for st in statics]
            mu_hat = torch.cat([p[0] for p in parts], dim=1)
            d_mu = torch.cat([p[1] for p in parts], dim=1)
            err_hat = torch.cat([p[2] for p in parts], dim=1)
            d_err = torch.cat([p[3] for p in parts], dim=1)

        # The candidate's values.
        d_mu_l1 = d_mu.sum(dim=1)
        v_next_mag, e_v_next = v_mag_err(mu_hat, mu_hat.abs(), d_mu)
        v_x_mag, e_v_x = v_mag_err(pts, pts.abs(), dx)

        # The L_v * error term (uncertain dynamics only).
        if err_hat is not None:
            lv_abs = _lv_at(mu_hat, n_pts).abs()
            if lv_abs.shape[1] == 1 and err_hat.shape[1] > 1:
                lv_abs = lv_abs.expand(n_pts, err_hat.shape[1])
            d_lv = (_lv_err_at(mu_hat, n_pts)
                    + 2.0 * lv_lip * d_mu_l1[:, None])
            lv_hi = lv_abs + d_lv + _lv_anchor_at(mu_hat, n_pts)
            if lvm.max_input_shift is not None:
                shift = torch.maximum(
                    shift, _shift_frac(d_mu, lvm.max_input_shift))
            errterm_anchor = (lv_hi * (err_hat + d_err)).sum(dim=1)
            d_errterm = ((lv_hi * d_err + d_lv * (err_hat + d_err))
                         .sum(dim=1)
                         + _gamma(lv_abs.shape[1] + 1, u) * errterm_anchor)
        else:
            errterm_anchor = 0.0
            d_errterm = 0.0

        # The threshold.
        if lv_trivial or tau == 0.0:
            # thr = -L_v (1 + L_f) * 0 == 0 in every realization.
            d_thr = 0.0
        else:
            lv_x = _lv_at(pts, n_pts)
            dx_l1 = dx.sum(dim=1)
            d_lv_x = _lv_err_at(pts, n_pts) + 2.0 * lv_lip * dx_l1[:, None]
            lv_x_hi = lv_x.abs() + d_lv_x + _lv_anchor_at(pts, n_pts)
            if lvm.max_input_shift is not None:
                shift = torch.maximum(
                    shift, _shift_frac(dx, lvm.max_input_shift))
            if lfm is None:
                lf_hi = lf
                d_lf = 0.0
            else:
                lf_val = _column_batch(lyapunov._lipschitz_dynamics(pts),
                                       n_pts)[:, :1]
                d_lf = (_column_batch(lfm.eval_bound(pts), n_pts)[:, :1]
                        + 2.0 * lf_lip * dx_l1[:, None])
                lf_anchor_x = (0.0 if lfm.anchor_bound is None
                               else _column_batch(lfm.anchor_bound(pts),
                                                  n_pts)[:, :1])
                lf_hi = lf_val.abs() + d_lf + lf_anchor_x
                if lfm.max_input_shift is not None:
                    shift = torch.maximum(
                        shift, _shift_frac(dx, lfm.max_input_shift))
            one_plus_lf_hi = 1.0 + lf_hi
            thr_mag = (lv_x_hi * one_plus_lf_hi).sum(dim=1) * tau
            if lfm is not None:
                d_thr_lin = ((d_lv_x * one_plus_lf_hi).sum(dim=1)
                             + (lv_x_hi * d_lf).sum(dim=1))
            else:
                d_thr_lin = d_lv_x.sum(dim=1) * (1.0 + lf)
            d_thr = (d_thr_lin * tau
                     + _gamma(lv_x.shape[1] + 4, u) * thr_mag)

        final_sums = _gamma(4, u) * (v_next_mag + v_x_mag + errterm_anchor)
        return (e_v_next + e_v_x + d_errterm + d_thr + final_sums,
                e_v_x, shift)

    refinement = int(refinement)
    if refinement < 1:
        raise ValueError("refinement must be >= 1")
    batch_size = int(batch_size)
    nindex = grid.nindex
    unit = np.asarray(grid.unit_maxes, dtype=np.float64)
    # The refined coordinates' construction (the unit cast, two half-width
    # multiplies and the add) rounds in float32 on |offset| or |result|:
    # 8 u32, two-sided, independent of fp_error_factor.
    u32 = float(np.finfo(config.np_dtype).eps) / 2.0
    zero = torch.zeros((), dtype=torch.float64, device=config.device)
    worst, worst_v, worst_shift, v_scale = zero, zero, zero, zero
    per_point_bounds = (torch.zeros(nindex, dtype=torch.float64,
                                    device=config.device)
                        if per_point else None)
    with torch.no_grad():
        for offset in _refinement_offsets(unit, refinement, d):
            off_dev = _tensor(offset)
            coord_rounding = float(np.any(offset != 0.0))
            off_abs = off_dev.abs()
            for start in range(0, nindex, batch_size):
                stop = min(start + batch_size, nindex)
                pts = grid.states_in_range(start, stop) + off_dev
                dx = coord_rounding * 8.0 * u32 * (pts.abs()
                                                   + off_abs[None, :])
                eps_b, ev_b, shift_b = batch_bound(pts, dx)
                eps_b = eps_b.double()
                worst = torch.maximum(worst, eps_b.max())
                worst_v = torch.maximum(worst_v, ev_b.max().double())
                worst_shift = torch.maximum(worst_shift, shift_b.double())
                if per_point_bounds is not None:
                    # Each offset pass visits the same slice of states.
                    per_point_bounds[start:stop] = torch.maximum(
                        per_point_bounds[start:stop], eps_b)
                vals = lyapunov.lyapunov_function(pts).abs().max()
                v_scale = torch.maximum(v_scale, vals.double())
    worst, worst_v, worst_shift, v_scale = torch.stack(
        [worst, worst_v, worst_shift, v_scale]).tolist()

    if worst_shift >= 1.0:
        raise RuntimeError(
            "the instance's input uncertainty exceeds the inflated L "
            "model's headroom (shift fraction {:.2f} >= 1) — use the "
            "empirical calibrator".format(worst_shift))
    if not np.isfinite(worst):
        raise RuntimeError(
            "the derived bound is infinite (a denominator interval "
            "reached zero in the dynamics' error propagation) — use the "
            "empirical calibrator")
    margin = _finalize_margin(
        per_point_bounds.cpu().numpy() if per_point_bounds is not None
        else worst, statics, d, u, safety)
    eps_dtype = float(np.finfo(config.np_dtype).eps)
    level_margin = max(2.0 * float(safety) * worst_v,
                       4.0 * eps_dtype * (v_scale or 1.0))
    if set_margin:
        lyapunov.certificate_margin = margin
        lyapunov.level_margin = level_margin
        # The unit the margin covers: a sweep at a coarser unit refuses it
        # (Lyapunov._require_f32_margin).
        lyapunov._certificate_margin_unit = u
    return margin


def analytic_exploration_margin(lyapunov, perturbations=None,
                                actions=None, limits=None, safety=1.0,
                                batch_size=2 ** 14, lipschitz_model=None,
                                unit_roundoff=None, set_margin=True,
                                candidates=None, per_candidate=False):
    """Derived conservative margin of the exploration certificate.

    ``get_safe_sample`` certifies a candidate by ``v(mu) + sum_j |L_v_j|
    (beta sigma_j) < c_max - margin`` (``explore._score_candidates``). This
    bounds ``|future_any(q) - future_exact(q)|`` with the model of
    :func:`analytic_certificate_margin` restricted to the future value,
    maximized over the given ``candidates`` rows (no construction
    uncertainty: they are the model's inputs), or over every candidate the
    sampler can build: all grid states with the explicit ``actions`` rows,
    or with the policy's actions plus ``perturbations``, clipped to
    ``limits``. Candidate construction rounds in float32 whatever the unit,
    at the float32 unit times ``config.fp_error_factor``.

    With ``set_margin`` it installs ``lyapunov.exploration_margin`` (which
    ``explore._margin_of`` prefers) and records the unit in
    ``_exploration_margin_unit``. ``per_candidate=True`` (which needs
    ``candidates`` and ``set_margin=False``) returns the ``(N,)`` margins of
    the rows instead of their maximum, as ``get_safe_sample`` derives them
    beside a per-point ``certificate_margin``.
    """
    u = _resolve_unit(unit_roundoff)
    if candidates is None and (perturbations is None) == (actions is None):
        raise ValueError("provide candidates, or exactly one of "
                         "perturbations/actions")
    if per_candidate and candidates is None:
        raise ValueError("per_candidate margins need the explicit "
                         "candidate rows")
    if per_candidate and set_margin:
        raise ValueError("a per-candidate margin is keyed to one "
                         "candidate matrix and cannot be installed as "
                         "instance state; pass set_margin=False")
    grid = lyapunov.discretization
    d = grid.ndim
    gp_list = _gp_members(lyapunov.dynamics)
    if gp_list is None:
        raise NotImplementedError(
            "exploration margin supports GaussianProcess / "
            "StackedGaussianProcess (or a FunctionStack of "
            "GaussianProcesses) dynamics; for anything else use the "
            "measurement-based oracle.calibrate_certificate_margin")
    v_mag_err = _candidate_model(lyapunov.lyapunov_function, d, u)
    lvm = _lv_model(lyapunov, lipschitz_model, u)
    lv_lip = _tensor(lvm.input_lipschitz)
    statics = [_gp_statics(gp, u) for gp in gp_list]
    lv_fun = lyapunov._lipschitz_lyapunov

    def future_bound(q, dq):
        """Per-candidate bound on ``|future_any - future_exact|`` (N,)."""
        n_pts = q.shape[0]
        shift = torch.zeros((), dtype=q.dtype, device=q.device)
        parts = [_gp_terms(st, q, dq, u) for st in statics]
        mu_hat = torch.cat([p[0] for p in parts], dim=1)
        d_mu = torch.cat([p[1] for p in parts], dim=1)
        err_hat = torch.cat([p[2] for p in parts], dim=1)
        d_err = torch.cat([p[3] for p in parts], dim=1)

        d_mu_l1 = d_mu.sum(dim=1)
        v_next_mag, e_v_next = v_mag_err(mu_hat, mu_hat.abs(), d_mu)

        lv_abs = _column_batch(lv_fun(mu_hat) if callable(lv_fun)
                               else lv_fun, n_pts).abs()
        if lv_abs.shape[1] == 1 and err_hat.shape[1] > 1:
            lv_abs = lv_abs.expand(n_pts, err_hat.shape[1])
        d_lv = (_column_batch(lvm.eval_bound(mu_hat), n_pts)
                + 2.0 * lv_lip * d_mu_l1[:, None])
        lv_hi = lv_abs + d_lv
        if lvm.anchor_bound is not None:
            lv_hi = lv_hi + _column_batch(lvm.anchor_bound(mu_hat), n_pts)
        if lvm.max_input_shift is not None:
            shift = torch.maximum(shift,
                                  _shift_frac(d_mu, lvm.max_input_shift))
        errterm_anchor = (lv_hi * (err_hat + d_err)).sum(dim=1)
        d_errterm = ((lv_hi * d_err + d_lv * (err_hat + d_err)).sum(dim=1)
                     + _gamma(lv_abs.shape[1] + 1, u) * errterm_anchor)
        # The final v + errterm add and the c_max comparison.
        final = _gamma(3, u) * (v_next_mag + errterm_anchor)
        return e_v_next + d_errterm + final, shift

    batch_size = int(batch_size)
    zero = torch.zeros((), dtype=torch.float64, device=config.device)
    worst, worst_shift = zero, zero
    eps_rows = []
    with torch.no_grad():
        if candidates is not None:
            cands = _tensor(candidates)
            for start in range(0, cands.shape[0], batch_size):
                q = cands[start:start + batch_size]
                eps_b, shift_b = future_bound(q, torch.zeros_like(q))
                eps_b = eps_b.double()
                if per_candidate:
                    eps_rows.append(eps_b)
                worst = torch.maximum(worst, eps_b.max())
                worst_shift = torch.maximum(worst_shift, shift_b.double())
        else:
            rows = np.atleast_2d(np.asarray(
                actions if actions is not None else perturbations,
                dtype=config.np_dtype))
            lim = (None if limits is None
                   else np.atleast_2d(np.asarray(limits, dtype=np.float64)))
            # Construction rounds in float32 whatever the scoring unit:
            # these terms must not shrink with unit_roundoff.
            u32s = (float(np.finfo(np.float32).eps) / 2.0
                    * float(config.fp_error_factor))
            u_con = max(u, u32s)
            pol_prog_con = (_policy_program(lyapunov.policy, u_con)
                            if actions is None else None)
            for start in range(0, grid.nindex, batch_size):
                pts = grid.states_in_range(
                    start, min(start + batch_size, grid.nindex))
                if actions is None:
                    acts0, du_pol = pol_prog_con((pts, torch.zeros_like(pts)))
                for j in range(rows.shape[0]):
                    row = _tensor(rows[j])
                    if actions is not None:
                        a = row[None, :].expand(pts.shape[0], rows.shape[1])
                        du = torch.zeros_like(a)
                    else:
                        a = acts0 + row[None, :]
                        if lim is not None:
                            a = torch.clamp(a, _tensor(lim[:, 0]),
                                            _tensor(lim[:, 1]))
                        du = du_pol + u_con * (a.abs() + row.abs()[None, :])
                    q = torch.cat([pts, a], dim=1)
                    dq = torch.cat([torch.zeros_like(pts), du], dim=1)
                    eps_b, shift_b = future_bound(q, dq)
                    worst = torch.maximum(worst, eps_b.max().double())
                    worst_shift = torch.maximum(worst_shift,
                                                shift_b.double())
    worst, worst_shift = torch.stack([worst, worst_shift]).tolist()

    if worst_shift >= 1.0:
        raise RuntimeError(
            "the instance's input uncertainty exceeds the inflated L "
            "model's headroom (shift fraction {:.2f} >= 1) — use the "
            "empirical calibrator".format(worst_shift))
    margin = _finalize_margin(
        torch.cat(eps_rows).cpu().numpy() if per_candidate else worst,
        statics, d, u, safety)
    if set_margin:
        lyapunov.exploration_margin = margin
        # The f32 scorer refuses a margin derived at a finer unit
        # (explore._margin_of).
        lyapunov._exploration_margin_unit = u
    return margin
