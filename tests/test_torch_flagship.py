"""The flagship verification, shrunk to 41x31, against the JAX package.

The instance of ``chip_smoke.build_flagship_instance`` (the inverted
pendulum with two composite-kernel GPs) on a 41x31 grid. The
discretization constant is the full 2001x1501 grid's, ``tau = 0.002``, so
that the decrease check does the work it does at full width (some points
pass it); at this grid's own ``tau = 0.1`` none would. In float64, by
both routes (the stacked GP and the fan-out of two GPs), the port's
sweep must give the JAX package's safe set and certified level, its
decrease margins the JAX oracle's, and its float64 oracle the JAX
oracle's safe set. In float32, the port passes ``bench.py``'s two gates
against its own oracle.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.lyapunov import _negative_batch

from _torch_parity import flagship_pair, working_dtype

POINTS = (41, 31)
TAU = 0.002
ROUTES = ("stacked", "fan_out")


@pytest.fixture(scope="module")
def pairs():
    """Both routes in both packages, float64, one update each."""
    out = {}
    with working_dtype("float64"):
        for route in ROUTES:
            lyap, jlyap, inst = flagship_pair(POINTS, route, tau=TAU)
            lyap.update_safe_set()
            jlyap.update_safe_set()
            out[route] = (lyap, jlyap, inst)
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_sweep_matches_jax(pairs, route):
    """The same safe set and ``c_max`` to rtol 1e-12 (two float64
    pipelines that differ by summation order)."""
    lyap, jlyap, inst = pairs[route]
    assert_array_equal(lyap.safe_set, jlyap.safe_set)
    assert_allclose(lyap.c_max, jlyap.c_max, rtol=1e-12)
    assert lyap.safe_set[inst["initial_set"]].all()
    assert_allclose(lyap.values.numpy(), np.asarray(jlyap.values),
                    rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("route", ROUTES)
def test_decrease_margins_match_jax_oracle(pairs, route):
    """Every grid point's float64 decrease margin from the port's sweep
    pipeline against the JAX oracle's; some points pass the check. The
    margins go through the GP posterior, whose condition number
    (noise 1e-6) amplifies f64 roundoff to about 1e-9 of the margins'
    scale."""
    lyap, jlyap, _ = pairs[route]
    points = lyap.discretization.all_points
    with working_dtype("float64"):
        negative, dec, thr = _negative_batch(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            torch.as_tensor(points))
    margins = (dec - thr).numpy()
    jmargins = sl.oracle.oracle_margins(jlyap, points)
    assert_allclose(margins, jmargins, rtol=0,
                    atol=1e-9 * np.abs(jmargins).max())
    assert_array_equal(negative.numpy(), jmargins < 0)
    assert 0 < negative.sum() < len(points)


@pytest.mark.parametrize("route", ROUTES)
def test_oracle_safe_set_matches_jax(pairs, route):
    lyap, jlyap, _ = pairs[route]
    safe, c_max = st.oracle.oracle_safe_set(lyap)
    jsafe, jc_max = sl.oracle.oracle_safe_set(jlyap)
    assert_array_equal(safe, jsafe)
    assert_allclose(c_max, jc_max, rtol=1e-12)
    assert_array_equal(safe, lyap.safe_set)


def test_routes_agree(pairs):
    """The stacked GP and the fan-out give one sweep in the port."""
    (s_lyap, _, _), (f_lyap, _, _) = pairs["stacked"], pairs["fan_out"]
    assert_array_equal(s_lyap.safe_set, f_lyap.safe_set)
    assert_allclose(s_lyap.c_max, f_lyap.c_max, rtol=1e-12)
    points = torch.as_tensor(s_lyap.discretization.all_points)
    with working_dtype("float64"):
        outs = [_negative_batch(l.policy, l.dynamics, l.lyapunov_function,
                                l._lipschitz_lyapunov,
                                l._lipschitz_dynamics, l.tau, points)
                for l in (s_lyap, f_lyap)]
    assert_allclose(outs[0][1].numpy(), outs[1][1].numpy(), rtol=1e-12,
                    atol=1e-12)


@pytest.mark.parametrize("route", ROUTES)
def test_float32_gates(route):
    """``bench.py``'s gates on the float32 port against its float64
    oracle, and the decrease verdicts on the oracle's side of the
    calibrated band."""
    with working_dtype("float32"):
        from chip_smoke import build_flagship_instance

        lyap, _ = build_flagship_instance(POINTS, route=route, tau=TAU)
        lyap.update_safe_set()
        c_dev = lyap.c_max
        safe, c_ref = st.oracle.oracle_safe_set(lyap)
        negative = _negative_batch(
            lyap.policy, lyap.dynamics, lyap.lyapunov_function,
            lyap._lipschitz_lyapunov, lyap._lipschitz_dynamics, lyap.tau,
            lyap._device_points())[0].numpy()
        margins64 = st.oracle.oracle_margins(
            lyap, lyap.discretization.all_points)
        margin = st.oracle.calibrate_certificate_margin(lyap, 4096)
        lyap.update_safe_set()
    assert lyap.values.dtype == torch.float32
    assert abs(c_dev - c_ref) <= 5e-4 * max(abs(c_ref), 1.0)
    assert lyap.c_max <= c_ref + 1e-7 * max(abs(c_ref), 1.0)
    assert 0.0 < margin < 1e-2
    outside = np.abs(margins64) > margin
    assert_array_equal(negative[outside], (margins64 < 0)[outside])
