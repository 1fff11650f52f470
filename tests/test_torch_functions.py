"""The port's grids, function algebra and package boundary.

Grids and function objects are held against the JAX package's on the same
numpy inputs; the boundary checks are that the port loads no JAX, keeps
TF32 off, and that ``chip_smoke.py`` refuses to run without a GPU.
"""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import convert
from safe_learning_tpu_torch.functions.base import concatenate_inputs

from _torch_parity import to_numpy, working_dtype

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("limits,num_points", [
    ([[-1.0, 1.0], [-1.0, 1.0]], 7), ([[-0.3, 0.3], [-0.6, 0.6]], [5, 9]),
    ([[0.0, 2.0]], 11), ([[-1, 1], [0, 1], [-2, 3]], [3, 4, 5])])
def test_grid_matches_jax(dtype, limits, num_points):
    with working_dtype(dtype):
        jgrid = sl.GridWorld(limits, num_points)
        pgrid = st.GridWorld(limits, num_points)
        pts_j, pts_t = jgrid.all_points, pgrid.all_points
        assert pts_t.dtype == pts_j.dtype
        assert_array_equal(pts_t, pts_j)  # the same numpy code: bitwise
        assert_array_equal(pgrid.all_points_f64, jgrid.all_points_f64)
        assert_array_equal(pgrid.unit_maxes, jgrid.unit_maxes)
        assert pgrid.nindex == jgrid.nindex and pgrid.shape == jgrid.shape
        idx = np.arange(0, jgrid.nindex, 3)
        assert_allclose(to_numpy(pgrid.index_to_state(idx)),
                        np.asarray(jgrid.index_to_state(idx)), rtol=1e-6)
        rng = np.random.default_rng(0)
        lim = np.asarray(limits, dtype=float)
        states = rng.uniform(lim[:, 0] - 0.2, lim[:, 1] + 0.2,
                             size=(50, len(lim)))
        assert_array_equal(to_numpy(pgrid.state_to_index(states)),
                           np.asarray(jgrid.state_to_index(states)))
    assert pgrid == st.GridWorld(limits, num_points)
    with pytest.raises(st.DimensionError):
        pgrid.state_to_index(np.zeros((2, pgrid.ndim + 1)))


def test_grid_rejects_single_point_dimension():
    with pytest.raises(st.DimensionError):
        st.GridWorld([[0.0, 1.0]], 1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_linear_and_quadratic_match_jax(dtype):
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(3, 3)), rng.normal(size=(3, 2))
    p = rng.normal(size=(3, 3))
    # Inputs in the working dtype: JAX keeps a float64 input's dtype
    # under x64, the port casts numpy input to its working dtype.
    x = rng.normal(size=(40, 3)).astype(dtype)
    u = rng.normal(size=(40, 2)).astype(dtype)
    rtol = 1e-5 if dtype == "float32" else 1e-13
    with working_dtype(dtype):
        jlin, plin = sl.LinearSystem([a, b]), convert.linear_system(
            np.hstack([a, b]))
        jquad, pquad = sl.QuadraticFunction(p), convert.quadratic_function(p)
        assert plin.input_dim == 5 and plin.output_dim == 3
        assert pquad.input_dim == 3 and pquad.output_dim == 1
        pairs = [(plin(x, u), jlin(x, u)),
                 (st.LinearSystem([a, b])(x, u), jlin(x, u)),
                 (pquad(x), jquad(x)),
                 (pquad.gradient(x), jquad.gradient(x))]
        for got, want in pairs:
            got, want = to_numpy(got), np.asarray(want)
            assert got.dtype == want.dtype
            assert_allclose(got, want, rtol=rtol, atol=rtol)


def test_function_algebra_and_lambda_match_jax():
    rng = np.random.default_rng(2)
    m, p = rng.normal(size=(1, 2)), np.diag([1.0, 2.0])
    x = rng.normal(size=(25, 2))
    with working_dtype("float64"):
        jl, tl = sl.LinearSystem(m), st.LinearSystem(m)
        jq, tq = sl.QuadraticFunction(p), st.QuadraticFunction(p)
        jlam = sl.LambdaFunction(lambda z: jnp.sin(z[:, :1]))
        tlam = st.LambdaFunction(lambda z: torch.sin(z[:, :1]))
        pairs = [(tl + tq, jl + jq), (tl * tq, jl * jq), (-tq, -jq),
                 (tq - tl, jq - jl), (2.0 * tq, 2.0 * jq),
                 (1.5 + tl, 1.5 + jl),
                 (3.0 - tlam, 3.0 - jlam), (tlam, jlam)]
        for got, want in pairs:
            assert_allclose(to_numpy(got(x)), np.asarray(want(x)),
                            rtol=1e-14, atol=1e-15)
        const = st.ConstantFunction(np.array([[1.0, 2.0]]))
        assert_array_equal(to_numpy(const(x)), [[1.0, 2.0]])
    assert st.as_deterministic(tl) is tl
    wrapped = st.as_deterministic(lambda z: z * 2.0, input_dim=2,
                                  output_dim=2)
    assert isinstance(wrapped, st.LambdaFunction)
    assert wrapped.input_dim == 2
    assert_array_equal(to_numpy(wrapped(torch.ones(1, 2))), [[2.0, 2.0]])


def test_concatenate_inputs_and_device():
    with working_dtype("float32"):
        out = concatenate_inputs(np.zeros((4, 2)), np.ones((4, 1)))
    assert out.shape == (4, 3) and out.dtype == torch.float32
    assert out.device == st.config.device == torch.device("cpu")
    assert concatenate_inputs(np.array([1.0, 2.0])).shape == (1, 2)


def test_mean_function_of_gp():
    with working_dtype("float64"):
        gp = st.GaussianProcess(st.RBF(1.0, 0.5), np.array([[0.0], [1.0]]),
                                np.array([[0.0], [1.0]]), noise_variance=0.1)
        mean, _ = gp(np.array([[0.5]]))
        assert_array_equal(to_numpy(gp.to_mean_function()([[0.5]])),
                           to_numpy(mean))


def test_tracked_mask_counts_mutations_like_jax():
    from safe_learning_tpu.utils import tracked_mask as jax_tracked
    from safe_learning_tpu_torch.utils import tracked_mask

    counts = []
    for make in (jax_tracked, tracked_mask):
        base = np.zeros(6, dtype=bool)
        mask = make(base)
        mask[1] = True
        mask[2:4] = True
        view = mask[::2]
        view |= True
        mask &= np.array([1, 1, 1, 1, 0, 0], dtype=bool)
        counts.append((mask.mutations, mask.tolist(), base.any()))
        assert make(mask) is mask
    assert counts[0] == counts[1]
    assert counts[1][0] == 4 and not counts[1][2]


def test_config_keeps_tf32_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    with pytest.raises(ValueError):
        st.config.dtype = torch.float16
    assert st.config.np_dtype == np.float32


def test_port_imports_no_jax():
    """Run in a fresh interpreter: this test process already holds jax."""
    code = ("import sys, safe_learning_tpu_torch, "
            "safe_learning_tpu_torch.ops.gp_kernel, "
            "safe_learning_tpu_torch.ops.build; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'safe_learning_tpu.')) "
            "or m == 'safe_learning_tpu'); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """``chip_smoke.py`` exits non-zero with no result line when CUDA is
    missing (this machine), and when it stands alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    env = dict(os.environ, PYTHONPATH="")
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("outputs,k_ops", [(1, 24), (2, 44)])
def test_kernel_bound_counts_what_the_function_needs(outputs, k_ops):
    """``chip_smoke.program_ops`` on the flagship's program: the four
    column products and differences (x0 q0, x1 q1, x2 q2, x0 - q0) once
    across the outputs, then 20 operations per output. ``kernel_bound`` at
    the flagship's count 32: per output ``n^2`` for the solve and
    ``(p + 1) (2 n - 1)`` for the reductions, then ``n * k_ops``;
    FP32-bound at 10^6 queries."""
    from chip_smoke import (FP32_FLOPS, flagship_kernel, kernel_bound,
                            program_ops)
    from safe_learning_tpu_torch.ops.gp_kernel import compile_kernel_program

    programs = tuple(compile_kernel_program(flagship_kernel([v] * 3),
                                            input_dim=3)[0]
                     for v in (1.0, 2.0)[:outputs])
    # Per output: the 3-term linear sum 3 multiplies + 2 adds; the
    # Matern32 term 1 lengthscale multiply + 1 square + 7 + 1 variance;
    # the 1-term linear 1; the product and the sum 2; scale and mask 2.
    assert program_ops(programs) == k_ops == 4 + 20 * outputs
    n, p, n_q = 32, 1, 10 ** 6
    flops = outputs * (n * n + (p + 1) * (2 * n - 1)) + n * k_ops
    ms, by, kind = kernel_bound(n_q, 3, n, p, outputs, k_ops, 4)
    assert (by, kind) == ("operations", "fp32")
    assert ms == pytest.approx(n_q * flops / FP32_FLOPS * 1e3, rel=1e-12)


@pytest.mark.parametrize("count", [24, 128, 181])
def test_kernel_bound_of_a_float64_path(count):
    """``kernel_bound`` with 8-byte values: the same operations, the
    product ``L^-1 K`` over the H100's FP64 tensor-core peak
    (``FP64_TC_FLOPS``) and the rest over its FP64 peak without them
    (``FP64_FLOPS``), kind ``fp64``; the bytes twice a float32 path's, so
    one query stays bound by bytes."""
    from chip_smoke import (FP32_FLOPS, FP64_FLOPS, FP64_TC_FLOPS,
                            HBM_BYTES_PER_S, kernel_bound, stationary_ops)

    n_q, d, p = 10 ** 6, 3, 2
    k_ops = stationary_ops("rbf", d)
    product = n_q * count * count
    rest = n_q * ((p + 1) * (2 * count - 1) + count * k_ops)
    ms, by, kind = kernel_bound(n_q, d, count, p, 1, k_ops, 8)
    assert (by, kind) == ("operations", "fp64")
    assert ms == pytest.approx(
        (product / FP64_TC_FLOPS + rest / FP64_FLOPS) * 1e3, rel=1e-12)
    f32_ms = kernel_bound(n_q, d, count, p, 1, k_ops, 4)[0]
    assert f32_ms == pytest.approx((product + rest) / FP32_FLOPS * 1e3,
                                   rel=1e-12)
    assert f32_ms < ms < f32_ms * FP32_FLOPS / FP64_FLOPS
    values = d + count * d + count * (count + p) + count + (p + 1)
    ms, by, kind = kernel_bound(1, d, count, p, 1, k_ops, 8)
    assert (by, kind) == ("bytes", "hbm")
    assert ms == pytest.approx(values * 8 / HBM_BYTES_PER_S * 1e3,
                               rel=1e-12)


@pytest.mark.parametrize("count", [64, 128])
def test_kernel_bound_of_the_three_pass_tf32_body(count):
    """``kernel_bound(..., tf32x3=True)``, kernel 7's float32 tiled body:
    the product ``L^-1 K`` over a third of the H100's TF32 tensor-core peak
    (``TF32_TC_FLOPS / 3``, three passes) and the rest over ``FP32_FLOPS``,
    kind ``tf32x3``; below the FP32 bound of the same work, above the
    product's share of it at the TF32 rate, and the bytes as any float32
    path's."""
    from chip_smoke import (FP32_FLOPS, HBM_BYTES_PER_S, TF32_TC_FLOPS,
                            kernel_bound, stationary_ops)

    n_q, d, p = 6_765_201, 5, 4
    k_ops = stationary_ops("rbf", d)
    product = n_q * count * count
    rest = n_q * ((p + 1) * (2 * count - 1) + count * k_ops)
    ms, by, kind = kernel_bound(n_q, d, count, p, 1, k_ops, 4, tf32x3=True)
    assert (by, kind) == ("operations", "tf32x3")
    assert ms == pytest.approx(
        (3 * product / TF32_TC_FLOPS + rest / FP32_FLOPS) * 1e3, rel=1e-12)
    f32_ms = kernel_bound(n_q, d, count, p, 1, k_ops, 4)[0]
    assert rest / FP32_FLOPS * 1e3 < ms < f32_ms
    values = d + count * d + count * (count + p) + count + (p + 1)
    assert kernel_bound(1, d, count, p, 1, k_ops, 4, tf32x3=True) == (
        pytest.approx(values * 4 / HBM_BYTES_PER_S * 1e3, rel=1e-12),
        "bytes", "hbm")


@pytest.mark.parametrize("n_q, d, p", [(10 ** 6, 3, 2), (6_765_201, 5, 4)])
def test_folded_bound_leaves_out_the_scale_and_the_mask(n_q, d, p):
    """Kernel 6's bound counts its bare ``k_j`` (``folded_ops``): two
    operations a row and query fewer than kernel 1's, at every kind, so
    both its FP32 and its three-pass TF32 bound sit ``2 n_q count`` FP32
    operations below kernel 1's at the bench's and the cart-pole's
    shapes."""
    from chip_smoke import (COV_OPS, FP32_FLOPS, folded_ops, kernel_bound,
                            stationary_ops)

    for kind in COV_OPS:
        assert folded_ops(kind, d) == stationary_ops(kind, d) - 2
    count = 128
    for tf32x3 in (False, True):
        full = kernel_bound(n_q, d, count, p, 1, stationary_ops("rbf", d), 4,
                            tf32x3=tf32x3)
        folded = kernel_bound(n_q, d, count, p, 1, folded_ops("rbf", d), 4,
                              tf32x3=tf32x3)
        assert folded[1:] == full[1:] == ("operations", folded[2])
        assert full[0] - folded[0] == pytest.approx(
            2 * n_q * count / FP32_FLOPS * 1e3, rel=1e-9)
