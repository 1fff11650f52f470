"""The port's float64 oracle and margin calibration against the JAX package.

``bench.py``'s instance at 200x200: in float32 the port passes both bench
gates against its own oracle and against the JAX package's; in float64
the port's oracle margins and safe set equal the JAX oracle's.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st

from _torch_parity import (jax_bench_lyapunov, port_bench_lyapunov,
                           working_dtype)


@pytest.fixture(scope="module")
def jax_oracle():
    """The JAX package's float64 oracle on the 200x200 bench instance."""
    jlyap, data = jax_bench_lyapunov(200)
    safe, c_max = sl.oracle.oracle_safe_set(jlyap)
    return jlyap, data, safe, c_max


def test_float32_bench_gates(jax_oracle):
    """Both gates of ``bench.py:221-239`` on the float32 port, judged by the
    port's oracle and by the JAX package's."""
    from bench import _oracle_c_max

    jlyap, data, jsafe, c_jax = jax_oracle
    with working_dtype("float32"):
        lyap, inst = port_bench_lyapunov(200)
        lyap.update_safe_set()
        c_dev, frac = lyap.c_max, float(lyap.safe_set.mean())
        psafe, c_port = st.oracle.oracle_safe_set(lyap)
        margin = st.oracle.calibrate_certificate_margin(lyap, 4096)
        lyap.update_safe_set()
    c_numpy, _ = _oracle_c_max(jlyap.discretization, data["a"],
                               data["x_train"], data["y_train"],
                               data["params"], data["lf"], data["tau"],
                               data["initial_set"])
    assert lyap.values.dtype.itemsize == 4
    # The port's oracle lifts the float32-rounded model and grid, the JAX
    # oracle and bench.py's numpy oracle judge the float64 ones.
    assert_allclose(c_numpy, c_jax, rtol=0, atol=1e-12)
    assert_allclose(c_port, c_jax, rtol=0, atol=1e-6)
    assert 0.05 < frac < 0.95
    for c_ref in (c_port, c_jax):
        assert abs(c_dev - c_ref) <= 5e-4 * max(abs(c_ref), 1.0)
        assert lyap.c_max <= c_ref + 1e-7 * max(abs(c_ref), 1.0)
    assert 0.0 < margin < 1e-2
    # The margin-guarded set is inside the exact one.
    assert not (lyap.safe_set & ~jsafe).any()


def test_float64_oracle_matches_jax(jax_oracle):
    jlyap, _, jsafe, c_jax = jax_oracle
    with working_dtype("float64"):
        lyap, _ = port_bench_lyapunov(200)
        safe, c_max = st.oracle.oracle_safe_set(lyap)
        pts = lyap.discretization.all_points[::53]
        margins = st.oracle.oracle_margins(lyap, pts, tau=0.5 * lyap.tau)
    assert_array_equal(safe, jsafe)
    assert_allclose(c_max, c_jax, rtol=0, atol=1e-12)
    # Ulp-level differences of the two f64 kernel assemblies, amplified
    # by cond(K) ~ 6e5 (see test_torch_gp.test_host_island_matches_jax).
    assert_allclose(margins, sl.oracle.oracle_margins(jlyap, pts,
                                                      tau=0.5 * jlyap.tau),
                    rtol=0, atol=1e-11)


def test_calibrated_margins_match_jax(jax_oracle):
    """The same subsample (one numpy seed) and the same construction: in
    float64 both packages measure f64 roundoff and floor the level margin
    at ``4 eps max|v|``."""
    jlyap, _, _, _ = jax_oracle
    with working_dtype("float64"):
        lyap, _ = port_bench_lyapunov(200)
        margin = st.oracle.calibrate_certificate_margin(lyap, 1024)
    jmargin = sl.oracle.calibrate_certificate_margin(jlyap, 1024)
    assert 0.0 <= margin < 1e-12 and 0.0 <= jmargin < 1e-12
    assert lyap.certificate_margin == margin
    assert_allclose(lyap.level_margin, jlyap.level_margin, rtol=1e-12)
    assert lyap.level_margin == 4.0 * np.finfo(np.float64).eps * max(
        np.abs(st.oracle._oracle_values(
            lyap, lyap.discretization.all_points[
                np.sort(np.random.default_rng(0).choice(
                    lyap.discretization.nindex, 1024, replace=False))])))


def test_lift64_and_unported_options():
    with working_dtype("float32"):
        quad = st.QuadraticFunction(np.diag([1.0, 3.0]))
        scaled = 2.0 * quad + st.LinearSystem(np.ones((1, 2)))
    lifted = st.oracle.lift64(scaled)
    assert lifted.fun1.fun2.matrix.dtype.itemsize == 8
    assert quad.matrix.dtype.itemsize == 4  # the original is untouched
    x = np.array([[0.5, -1.0]])
    assert_allclose(lifted(x).numpy(), [[2.0 * 3.25 - 0.5]])
    with pytest.raises(TypeError):
        st.oracle.lift64(object())


class _Pair(st.DeterministicFunction):
    """A function holding its parts in a list attribute."""

    def __init__(self, parts):
        self.parts = list(parts)

    def evaluate(self, points):
        return sum(part.evaluate(points) for part in self.parts)


def test_lift64_lifts_containers_and_stacked_gps():
    """A ``FunctionStack`` of float32 GPs, a ``StackedGaussianProcess`` and
    a list attribute of functions all come out float64 on the CPU (before
    the repair, a tuple or list attribute passed through in float32); an
    attribute that cannot be widened raises instead of passing through."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(10, 3))
    y = np.column_stack([np.sin(x[:, 0]), np.cos(x[:, 1])])
    with working_dtype("float32"):
        kernel = (st.LinearKernel([0.3, 0.1, 0.5], input_dim=3)
                  + st.ActiveDims(st.Matern32(1.0, 0.8, input_dim=1), [0]))
        gps = [st.GaussianProcess(kernel, x, y[:, s:s + 1], 1e-4,
                                  mean_function=st.LinearSystem(
                                      np.ones((1, 3))))
               for s in range(2)]
        fan_out = st.FunctionStack(gps)
        stacked = st.StackedGaussianProcess.from_gps(gps)
        pair = _Pair([st.QuadraticFunction(np.eye(3)),
                      st.Saturation(st.LinearSystem(np.ones((1, 3))), -1.0,
                                    1.0)])
    lifted = st.oracle.lift64(fan_out)
    assert isinstance(lifted.functions, tuple)
    for member, orig in zip(lifted.functions, gps):
        assert member is not orig
        assert member.X_buf.dtype == torch.float64
        assert member.chol_inv.dtype == torch.float64
        assert member.kernel.k1.variances.dtype == torch.float64
        assert member.mean_function.matrix.dtype == torch.float64
        assert_array_equal(member._host_cache.chol_inv,
                           orig._host_cache.chol_inv)
    assert gps[0].X_buf.dtype == torch.float32  # the original is untouched
    lifted_stack = st.oracle.lift64(stacked)
    assert lifted_stack.chol_inv.dtype == torch.float64
    assert lifted_stack.kernels[1].k2.kernel.variance.dtype == torch.float64
    assert lifted_stack.mean_functions[0].matrix.dtype == torch.float64
    assert_allclose(lifted_stack.noise_variances.numpy(),
                    stacked.noise_variances.numpy())
    q = rng.uniform(-1, 1, size=(6, 3))
    for got, want in zip(lifted(q), lifted_stack(q)):
        assert got.dtype == torch.float64
        assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-14)
    lifted_pair = st.oracle.lift64(pair)
    assert isinstance(lifted_pair.parts, list)
    assert lifted_pair.parts[0].matrix.dtype == torch.float64
    assert lifted_pair.parts[1].fun.matrix.dtype == torch.float64
    assert lifted_pair(q).dtype == torch.float64

    for bad in ({"f": pair}, np.ones(3, dtype=np.float32)):
        holder = _Pair([])
        holder.extra = bad
        with pytest.raises(TypeError, match="cannot lift"):
            st.oracle.lift64(holder)
