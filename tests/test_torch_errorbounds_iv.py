"""The port's ``_iv_*`` interval scaffolding: its contract and JAX parity.

``safe_learning_tpu_torch.errorbounds`` keeps the JAX package's contract
for its ``(value, error)`` pairs (``tests/test_errorbounds_iv.py:1-30``):
``e`` bounds ``|y_any - y_exact|`` for ANY realization rounding at ``u``
per op, at any input within the tracked uncertainty, against the exact
value of the stored parameters, and every rule keeps the anchor invariant
``|y_any| <= |v| + 2 e``. The fuzz below runs each chain in float64 twice,
once cleanly and once with per-op relative perturbations at the full
budget ``u = 2^-8`` (half of them on the budget's edge), and asserts that
the port's propagated ``e`` dominates the deviation; the directed corners
are the JAX suite's. Each rule is also held to the JAX package's on the
same inputs, to 1e-12 relative.
"""

import os
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

from safe_learning_tpu import errorbounds as jeb  # noqa: E402
from safe_learning_tpu_torch.errorbounds import (  # noqa: E402
    _gamma, _iv_activation, _iv_add, _iv_const_mul, _iv_cos, _iv_div,
    _iv_matmul, _iv_mul, _iv_sin)
from _torch_parity import working_dtype  # noqa: E402

U = 2.0 ** -8  #: per-op rounding budget of the fuzz (deliberately huge)


@pytest.fixture(autouse=True)
def float64_lane():
    with working_dtype("float64"):
        yield


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _rel(rng, shape):
    """A relative perturbation factor ``1 + d``, half of the draws on the
    budget's edge ``|d| = u``."""
    d = rng.uniform(-U, U, shape)
    edge = rng.random(shape) < 0.5
    return 1.0 + np.where(edge, np.sign(d + 1e-300) * U, d)


class _Chain:
    """Paired exact, perturbed-realization and interval evaluation."""

    def __init__(self, rng, x_exact, e0):
        self.rng = rng
        self.exact = x_exact
        # The realization and the anchor are both realizations: each may
        # sit anywhere within e0 of the exact input.
        self.any = x_exact + e0 * rng.uniform(-1, 1, x_exact.shape)
        anchor = x_exact + e0 * rng.uniform(-1, 1, x_exact.shape)
        self.iv = (_t(anchor), _t(np.full(x_exact.shape, e0)))

    def copy(self):
        new = _Chain.__new__(_Chain)
        new.rng, new.exact, new.any, new.iv = (
            self.rng, self.exact.copy(), self.any.copy(), self.iv)
        return new

    def _arg_reduction(self):
        """An argument reduction's absolute error, at most ``u / 2`` of
        ``|x|``."""
        cap = (U / 2.0) * np.abs(self.any)
        red = cap * self.rng.uniform(-1, 1, self.any.shape)
        edge = self.rng.random(self.any.shape) < 0.5
        return np.where(edge, np.sign(red + 1e-300) * cap, red)

    def sin(self):
        self.exact = np.sin(self.exact)
        self.any = (np.sin(self.any + self._arg_reduction())
                    * _rel(self.rng, self.any.shape))
        self.iv = _iv_sin(self.iv, U)
        return self

    def cos(self):
        self.exact = np.cos(self.exact)
        self.any = (np.cos(self.any + self._arg_reduction())
                    * _rel(self.rng, self.any.shape))
        self.iv = _iv_cos(self.iv, U)
        return self

    def act(self, name):
        fn = {"tanh": np.tanh, "relu": lambda x: np.maximum(x, 0.0),
              "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x))}[name]
        self.exact = fn(self.exact)
        rel = 1.0 if name == "relu" else _rel(self.rng, self.any.shape)
        self.any = fn(self.any) * rel
        self.iv = _iv_activation(self.iv, name, U)
        return self

    def const_mul(self, c):
        self.exact = self.exact * c
        self.any = self.any * c * _rel(self.rng, self.any.shape)
        self.iv = _iv_const_mul(self.iv, _t(c), U)
        return self

    def add(self, other):
        self.exact = self.exact + other.exact
        self.any = (self.any + other.any) * _rel(self.rng, self.any.shape)
        self.iv = _iv_add(self.iv, other.iv, U)
        return self

    def mul(self, other):
        self.exact = self.exact * other.exact
        self.any = (self.any * other.any) * _rel(self.rng, self.any.shape)
        self.iv = _iv_mul(self.iv, other.iv, U)
        return self

    def div(self, other):
        self.exact = self.exact / other.exact
        self.any = (self.any / other.any) * _rel(self.rng, self.any.shape)
        self.iv = _iv_div(self.iv, other.iv, U)
        return self

    def matmul(self, w, bias=None, dw=None):
        w = np.asarray(w, np.float64)
        self.exact = self.exact @ w + (0.0 if bias is None else bias)
        w_real = w if dw is None else (
            w + dw * self.rng.uniform(-1, 1, w.shape))
        anchor = np.abs(self.any) @ np.abs(w_real) + (
            0.0 if bias is None else np.abs(bias))
        g = _gamma(w.shape[0] + (2 if bias is not None else 1), U)
        theta = g * self.rng.uniform(-1, 1, anchor.shape)
        edge = self.rng.random(anchor.shape) < 0.5
        theta = np.where(edge, np.sign(theta + 1e-300) * g, theta)
        self.any = (self.any @ w_real + (0.0 if bias is None else bias)
                    + theta * anchor)
        self.iv = _iv_matmul(self.iv, _t(w), U,
                             bias=None if bias is None else _t(bias),
                             dw=None if dw is None else _t(dw))
        return self

    def check(self):
        v = self.iv[0].numpy()
        e = self.iv[1].numpy()
        slack = 1e-12 * (np.abs(self.exact) + e) + 1e-300
        dev = np.abs(self.any - self.exact)
        assert np.all(np.isfinite(e))
        assert np.all(dev <= e + slack), (
            "realization escaped the propagated bound by "
            f"{np.max(dev - e):.3e}")
        assert np.all(np.abs(self.any) <= np.abs(v) + 2.0 * e + slack)
        return self


@pytest.mark.parametrize("seed", range(8))
def test_mlp_chain_realizations_stay_inside_bound(seed):
    """matmul (bias, dw) / tanh / sigmoid / relu / const_mul chains."""
    rng = np.random.default_rng(seed)
    n, layers = 32, [3, 8, 8, 1]
    c = _Chain(rng, rng.uniform(-1.5, 1.5, (n, layers[0])), e0=1e-3)
    for i, (din, dout) in enumerate(zip(layers[:-1], layers[1:])):
        w = rng.normal(size=(din, dout)) / np.sqrt(din)
        bias = rng.normal(size=(dout,)) * 0.1 if i % 2 == 0 else None
        dw = np.full((din, dout), 1e-4) if i == 1 else None
        c.matmul(w, bias=bias, dw=dw).check()
        c.act(("tanh", "sigmoid", "relu")[i % 3]).check()
    c.const_mul(0.8).check()


@pytest.mark.parametrize("seed", range(8))
def test_dynamics_chain_realizations_stay_inside_bound(seed):
    """sin / cos / mul / add / div chains shaped like the ODE rules."""
    rng = np.random.default_rng(100 + seed)
    n = 64
    theta = _Chain(rng, rng.uniform(-2.0, 2.0, (n, 1)), e0=1e-3)
    omega = _Chain(rng, rng.uniform(-1.0, 1.0, (n, 1)), e0=1e-3)
    sin_t = theta.copy().sin().check()
    cos_t = theta.copy().cos().check()
    num = sin_t.const_mul(9.81).add(omega.mul(cos_t).check()).check()
    den = _Chain(rng, rng.uniform(2.0, 3.0, (n, 1)), e0=1e-3)
    num.div(den).check()


def test_div_reports_inf_when_denominator_can_vanish():
    rng = np.random.default_rng(0)
    a = _Chain(rng, np.ones((4, 1)), e0=1e-3)
    b = _Chain(rng, np.full((4, 1), 1e-4), e0=1e-3)
    _, e = _iv_div(a.iv, b.iv, U)
    assert torch.isinf(e).all()


def test_sin_bound_covers_argument_reduction_at_pi():
    """At ``x ~= pi`` the output-relative term alone collapses; the
    ``u * arg`` term covers a reduction error of ``|x| u / 2``."""
    x = np.pi
    _, e = _iv_sin((_t([[x]]), _t([[0.0]])), U)
    y_any = np.sin(x + (U / 2.0) * x) * (1.0 + U)
    dev = abs(y_any - np.sin(x))
    assert dev > U * abs(np.sin(x)) + U * 1e-10
    assert dev <= float(e[0, 0])
    _, ec = _iv_cos((_t([[np.pi / 2]]), _t([[0.0]])), U)
    y_any = np.cos(np.pi / 2 + (U / 2.0) * (np.pi / 2)) * (1.0 + U)
    assert abs(y_any - np.cos(np.pi / 2)) <= float(ec[0, 0])


@pytest.mark.parametrize("op", ["sin", "cos", "tanh", "sigmoid"])
def test_directed_corner_anchor_realization_split(op):
    """The anchor at the low edge of the input uncertainty, the realization
    at the high edge, own rounding coherently at ``+u``."""
    c, e0 = 0.01, 0.005
    fn = {"sin": np.sin, "cos": np.cos, "tanh": np.tanh,
          "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x))}[op]
    c0 = np.pi / 2 + c if op == "cos" else c
    iv = (_t([[c0 - e0]]), _t([[e0]]))
    if op == "sin":
        _, e = _iv_sin(iv, U)
    elif op == "cos":
        _, e = _iv_cos(iv, U)
    else:
        _, e = _iv_activation(iv, op, U)
    y_exact, y_any = fn(c0), fn(c0 + e0) * (1 + U)
    assert abs(y_any - y_exact) <= float(e[0, 0])


def _jax_pair(a):
    return (jnp.asarray(a[0].numpy()), jnp.asarray(a[1].numpy()))


@pytest.mark.parametrize("seed", range(3))
def test_rules_match_jax(seed):
    """Every rule against the JAX package's on the same inputs."""
    rng = np.random.default_rng(200 + seed)
    shape = (16, 4)
    a = (_t(rng.normal(size=shape)), _t(rng.uniform(0, 1e-3, shape)))
    b = (_t(rng.uniform(1.5, 3.0, shape)), _t(rng.uniform(0, 1e-3, shape)))
    w = rng.normal(size=(4, 3))
    bias = rng.normal(size=3)
    dw = rng.uniform(0, 1e-5, (4, 3))
    ja, jb = _jax_pair(a), _jax_pair(b)
    cases = [
        (_iv_add(a, b, U), jeb._iv_add(ja, jb, U)),
        (_iv_mul(a, b, U), jeb._iv_mul(ja, jb, U)),
        (_iv_div(a, b, U), jeb._iv_div(ja, jb, U)),
        (_iv_const_mul(a, _t(-1.7), U),
         jeb._iv_const_mul(ja, jnp.asarray(-1.7), U)),
        (_iv_sin(a, U), jeb._iv_sin(ja, U)),
        (_iv_cos(a, U), jeb._iv_cos(ja, U)),
        (_iv_matmul(a, _t(w), U, bias=_t(bias), dw=_t(dw)),
         jeb._iv_matmul(ja, jnp.asarray(w), U, bias=jnp.asarray(bias),
                        dw=jnp.asarray(dw))),
    ] + [(_iv_activation(a, name, U), jeb._iv_activation(ja, name, U))
         for name in ("relu", "tanh", "sigmoid", "linear", None)]
    for got, want in cases:
        for g, w_ in zip(got, want):
            assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-12,
                            atol=1e-300)


def test_unknown_activation_raises():
    a = (_t(np.zeros((2, 2))), _t(np.zeros((2, 2))))
    with pytest.raises(NotImplementedError, match="activations"):
        _iv_activation(a, "softplus", U)
