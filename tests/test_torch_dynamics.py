"""The inverted pendulum, the cart-pole, the Van der Pol oscillator, the
LQR solvers, ``Saturation`` and ``FunctionStack`` against the JAX
package."""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import convert

from _torch_parity import port_gp, to_numpy, working_dtype

GRAVITY, LENGTH = 9.81, 0.5
NORMS = ((np.deg2rad(30), np.sqrt(GRAVITY / LENGTH)),
         (GRAVITY * 0.15 * LENGTH * np.sin(np.deg2rad(30)),))

# float32: the same float32 operations in the same order on both sides,
# up to the libraries' sin and the reassociation of the ODE's terms.
TOL = {"float64": dict(rtol=1e-13, atol=1e-15),
       "float32": dict(rtol=2e-6, atol=2e-7)}


def _pendulums(normalized):
    norms = NORMS if normalized else None
    return (sl.InvertedPendulum(0.15, LENGTH, 0.1, 1 / 80,
                                normalization=norms),
            st.InvertedPendulum(0.15, LENGTH, 0.1, 1 / 80,
                                normalization=norms))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("normalized", [True, False])
def test_pendulum_evaluate_matches_jax(normalized, dtype):
    """Ten inner Euler steps of the ODE from states and actions."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(64, 2)).astype(dtype)
    u = rng.uniform(-1, 1, size=(64, 1)).astype(dtype)
    with working_dtype(dtype):
        jp, pp = _pendulums(normalized)
        want = np.asarray(jp(x, u))
        got = to_numpy(pp(x, u))
    assert got.shape == (64, 2) and got.dtype == np.dtype(dtype)
    assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("normalized", [True, False])
def test_linearize_matches_jax(normalized, dtype):
    """The zero-order-hold linearization from the ODE's Jacobian: the
    same Jacobian (autodiff in both packages) and the same scipy
    discretization."""
    with working_dtype(dtype):
        jp, pp = _pendulums(normalized)
        ja, jb = jp.linearize()
        pa, pb = pp.linearize()
    assert pa.dtype == np.dtype(dtype) and pb.shape == (2, 1)
    assert_allclose(pa, np.asarray(ja), **TOL[dtype])
    assert_allclose(pb, np.asarray(jb), **TOL[dtype])


def test_lqr_and_dlqr_match_jax():
    with working_dtype("float64"):
        a, b = st.InvertedPendulum(0.1, LENGTH, 0.0, 1 / 80,
                                   normalization=NORMS).linearize()
    q, r = np.diag([1.0, 2.0]), 1.2 * np.eye(1)
    for port, ref in ((st.utils.dlqr, sl.utils.dlqr),
                      (st.utils.lqr, sl.utils.lqr)):
        for got, want in zip(port(a, b, q, r), ref(a, b, q, r)):
            assert_array_equal(got, want)


def test_saturation_matches_jax_and_forwards_attributes():
    rng = np.random.default_rng(1)
    k = rng.normal(size=(1, 2)) * 3
    x = rng.uniform(-1, 1, size=(50, 2))
    with working_dtype("float64"):
        jsat = sl.Saturation(sl.LinearSystem(-k), -1.0, 1.0)
        psat = st.Saturation(st.LinearSystem(-k), -1.0, 1.0)
        conv = convert.saturation(convert.linear_system(-k),
                                  np.asarray(-1.0), np.asarray(1.0))
        got = to_numpy(psat(x))
        got_conv = to_numpy(conv(x))
        vec = st.Saturation(st.LinearSystem(-k), [-0.5], [0.25])
        clipped = to_numpy(vec(x))
    # A two-term dot product, rounded in either package's order.
    assert_allclose(got, np.asarray(jsat(x)), rtol=1e-15, atol=1e-15)
    assert_array_equal(got_conv, got)
    assert np.abs(got).max() == 1.0 and np.abs(got).min() < 1.0
    assert clipped.min() == -0.5 and clipped.max() == 0.25
    # Attributes the wrapper lacks are read from the wrapped function.
    assert psat.matrix is psat.fun.matrix and psat.input_dim == 2
    with pytest.raises(AttributeError):
        psat._private


def test_function_stack_matches_jax():
    """A ``FunctionStack`` of GPs concatenates its members' means and
    errors, as the JAX package's."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(12, 3))
    q = rng.uniform(-1, 1, size=(20, 3))
    with working_dtype("float64"):
        jgps = [sl.GaussianProcess(sl.Matern52(0.7 + 0.2 * s, [0.5, 0.8,
                                                             1.1],
                                               input_dim=3),
                                   x, np.sin(x[:, s:s + 1]), 1e-3)
                for s in range(2)]
        jstack = sl.FunctionStack(jgps)
        pstack = st.FunctionStack([port_gp(g) for g in jgps])
        got = [to_numpy(t) for t in pstack(q)]
    assert pstack.num_fun == 2 and pstack.output_dim == 2
    for g, w in zip(got, jstack(q)):
        assert g.shape == (20, 2)
        assert_allclose(g, np.asarray(w), rtol=1e-9, atol=1e-11)


def test_convert_inverted_pendulum():
    with working_dtype("float64"):
        jp, _ = _pendulums(True)
        pp = convert.inverted_pendulum(
            np.asarray(jp.mass), np.asarray(jp.length),
            np.asarray(jp.friction), jp.dt, np.asarray(jp.tx),
            np.asarray(jp.tu))
        x = np.random.default_rng(3).uniform(-1, 1, size=(8, 3))
        assert_allclose(to_numpy(pp(x)), np.asarray(jp(x)),
                        **TOL["float64"])
        assert pp.tx.dtype == torch.float64


# The cart-pole of ``examples/reinforcement_learning_cartpole.py`` (notebook
# cell 7) and the reverse-time Van der Pol oscillator.
CART = dict(pendulum_mass=0.175, cart_mass=1.732, length=0.28,
            rot_friction=0.01, dt=0.01)
CART_NORMS = ((0.5, np.deg2rad(30), 2.0, np.deg2rad(30)),
              ((0.175 + 1.732) * 2.0 ** 2 / 0.5,))
VDP_NORMS = (1.5, 2.5)


def _systems(name, normalized):
    """The JAX and the port's system, in the current working dtype."""
    if name == "cartpole":
        norms = CART_NORMS if normalized else None
        return (sl.CartPole(**CART, normalization=norms),
                st.CartPole(**CART, normalization=norms))
    norms = VDP_NORMS if normalized else None
    return (sl.VanDerPol(damping=0.9, dt=0.01, normalization=norms),
            st.VanDerPol(damping=0.9, dt=0.01, normalization=norms))


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("name", ["cartpole", "vanderpol"])
def test_ode_and_evaluate_match_jax(name, normalized):
    """The continuous ODE and ten inner Euler steps, float64 to 1e-12."""
    rng = np.random.default_rng(4)
    with working_dtype("float64"):
        jsys, psys = _systems(name, normalized)
        x = rng.uniform(-1, 1, size=(64, psys.state_dim))
        u = rng.uniform(-1, 1, size=(64, psys.action_dim))
        xu = np.hstack([x, u])
        want_ode = np.asarray(jsys.ode(x, u))
        got_ode = to_numpy(psys.ode(torch.as_tensor(x), torch.as_tensor(u)))
        want = np.asarray(jsys(xu))
        got = to_numpy(psys(xu))
    assert got.shape == (64, psys.state_dim)
    assert_allclose(got_ode, want_ode, rtol=1e-12, atol=1e-12)
    assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("name", ["cartpole", "vanderpol"])
def test_ode_linearize_matches_jax(name, normalized):
    """The zero-order-hold linearization, to 1e-9; without an action it
    is one matrix, as the JAX package returns."""
    with working_dtype("float64"):
        jsys, psys = _systems(name, normalized)
        want, got = jsys.linearize(), psys.linearize()
    if name == "vanderpol":
        assert isinstance(got, np.ndarray) and got.shape == (2, 2)
        want, got = (want,), (got,)
    else:
        assert got[1].shape == (4, 1)
    for g, w in zip(got, want):
        assert_allclose(g, np.asarray(w), rtol=1e-9, atol=1e-12)


def test_van_der_pol_roa_matches_jax():
    """The reverse-time Van der Pol's region of attraction on a 5x5 grid
    over 2000 steps: the same points converge in both packages."""
    with working_dtype("float64"):
        jsys, psys = _systems("vanderpol", True)
        jgrid = sl.GridWorld([[-1.0, 1.0]] * 2, 5)
        pgrid = st.GridWorld([[-1.0, 1.0]] * 2, 5)
        want = np.asarray(sl.compute_roa(jgrid, jsys, horizon=2000,
                                         tol=0.1))
        got = st.compute_roa(pgrid, psys, horizon=2000, tol=0.1)
    assert want.any() and not want.all()
    assert_array_equal(got, want)


def test_convert_cart_pole_and_van_der_pol():
    with working_dtype("float64"):
        jcart, _ = _systems("cartpole", True)
        jvdp, _ = _systems("vanderpol", True)
        pcart = convert.cart_pole(
            np.asarray(jcart.pendulum_mass), np.asarray(jcart.cart_mass),
            np.asarray(jcart.length), np.asarray(jcart.rot_friction),
            jcart.dt, np.asarray(jcart.tx), np.asarray(jcart.tu))
        pvdp = convert.van_der_pol(np.asarray(jvdp.damping), jvdp.dt,
                                   np.asarray(jvdp.tx))
        rng = np.random.default_rng(5)
        xu = rng.uniform(-1, 1, size=(8, 5))
        assert_allclose(to_numpy(pcart(xu)), np.asarray(jcart(xu)),
                        rtol=1e-12, atol=1e-12)
        assert_allclose(to_numpy(pvdp(xu[:, :2])), np.asarray(jvdp(xu[:, :2])),
                        rtol=1e-12, atol=1e-12)
