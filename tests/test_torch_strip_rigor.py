"""Kernel 1 above the panel body's counts, and the rigor sweep there: the
port against the JAX package.

Kernel 1's plain twin, reached through the port's ``fused_gp_predict`` on
CPU tensors, against the JAX package's ``fused_gp_predict`` run with
``interpret=True`` on the JAX GP's own cache, at counts 600, 1,021 and
2,048 (the strip body's range on the card), float32 and float64, within
``chip_smoke.rounding_bounds`` (``tests/test_torch_strip_counts.py``
holds kernels 2 and 3 the same way). Then the extended sweep at count 600,
which the card refused above count 256 before the strip body: on
``test_torch_extended_verify.panel_limit_instance``'s 5x5 grid, the
port's float64 check against the JAX package's double-word one, state by
state within both packages' derived extended margins, the same verdict
wherever the two agree beyond them, and the same extended safe set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu.ops import extended_verify as jev
from safe_learning_tpu.ops.gp_kernel import fused_gp_predict as jax_predict
from safe_learning_tpu_torch.ops import extended_verify as ev
from safe_learning_tpu_torch.ops import gp_kernel

from _torch_parity import port_gp, to_numpy, working_dtype
from test_torch_extended_verify import LV_MAT, _abs_lv
from test_torch_program_counts import _data
from test_torch_strip_counts import CASES, QUERIES, _held


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("cap,count", CASES)
def test_stationary_plain_matches_pallas_above_the_panel(cap, count, dtype):
    """Kernel 1's twin: a Matern-3/2 GP with two outputs, scale 1.4, on
    pre-scaled inputs."""
    from chip_smoke import rounding_bounds

    with working_dtype(dtype):
        x, y, q = _data(count, 2, seed=cap + 3 * count)
        q = q[:QUERIES]
        gp = sl.GaussianProcess(sl.Matern32(1.2, [0.7, 0.9, 1.1],
                                            input_dim=3),
                                x, y, noise_variance=1e-2, scale=1.4,
                                capacity=cap)
        assert int(gp.count) == count
        ls = np.asarray(gp.kernel.lengthscales)
        var_s2 = float(gp.kernel.variance) * gp.scale ** 2
        want = jax_predict(jnp.asarray(q / ls, dtype=getattr(jnp, dtype)),
                           gp.X_buf / ls, gp.chol_inv, gp.alpha,
                           gp._mask(), var_s2, kind="matern32", tile=128,
                           interpret=True)
        pgp = port_gp(gp, adopt=True)
        tdtype = getattr(torch, dtype)
        pls = pgp.kernel.lengthscales
        inputs = ((torch.as_tensor(q, dtype=tdtype) / pls).contiguous(),
                  (pgp.X_buf / pls).contiguous(), pgp.chol_inv, pgp.alpha,
                  pgp._mask(), pgp.kernel.variance * pgp.scale ** 2)
        got = gp_kernel.fused_gp_predict(*inputs, kind="matern32",
                                         count=pgp.count)
        bounds = rounding_bounds(inputs, "matern32")
    assert got[0].shape == (QUERIES, 2) and got[1].shape == (QUERIES,)
    _held(got, want, bounds)



def _panel_limit_instance(pkg, n):
    """``test_torch_extended_verify.panel_limit_instance`` in ``pkg``: a
    stacked Matern-3/2 GP holding ``n`` data points on a 5x5 grid."""
    rng = np.random.default_rng(0)
    x = np.column_stack([rng.uniform(-1, 1, (n, 2)), np.zeros(n)])
    y = 0.5 * x[:, :2]
    gp = pkg.StackedGaussianProcess(
        [pkg.Matern32(0.5, [0.4] * 3, input_dim=3)] * 2, x, y, [1e-3] * 2)
    grid = pkg.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 5)
    return pkg.Lyapunov(grid, pkg.QuadraticFunction(np.eye(2)), gp, 0.5,
                        _abs_lv(pkg), 0.1,
                        pkg.LinearSystem(np.zeros((1, 2))),
                        initial_set=[12])


def test_extended_sweep_matches_jax_at_count_600():
    """The extended sweep at count 600 in both packages (float32 working
    dtype): each state's float64 margin within the sum of the two derived
    extended margins of the JAX package's double-word one, the same
    verdict at every state where both lie beyond it, and the same
    extended safe set and level."""
    with working_dtype("float32"):
        jlyap = _panel_limit_instance(sl, 600)
        lyap = _panel_limit_instance(st, 600)
        assert int(lyap.dynamics.count) == 600
        pts = lyap.discretization.all_points
        m_port = ev.extended_certificate_margin(lyap, lv_matrix=LV_MAT,
                                                set_margin=False)
        m_jax = jev.extended_certificate_margin(jlyap, lv_matrix=LV_MAT,
                                                set_margin=False)
        got = ev.ExtendedSweep(lyap, lv_matrix=LV_MAT).margins(pts)
        want = jev.ExtendedSweep(jlyap, lv_matrix=LV_MAT).margins(
            jnp.asarray(pts))
        band = m_port + float(m_jax)
        assert (np.abs(got - want) <= band).all()
        clear = np.abs(want) > band
        assert clear.any()
        np.testing.assert_array_equal(got[clear] < 0, want[clear] < 0)
        for pkg_lyap, mod in ((lyap, ev), (jlyap, jev)):
            mod.extended_certificate_margin(pkg_lyap, lv_matrix=LV_MAT)
            pkg_lyap.update_safe_set(extended=True)
        np.testing.assert_array_equal(np.asarray(lyap.safe_set),
                                      np.asarray(jlyap.safe_set))
        assert float(lyap.c_max) == float(jlyap.c_max)
