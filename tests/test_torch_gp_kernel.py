"""The port's fused GP predict against the JAX package's Pallas kernel.

On the CPU, ``gp_predict_plain`` (the CUDA kernel's plain version) is held
against ``fused_gp_predict(..., interpret=True)``, the Pallas kernel run
under its interpreter as ``tests/test_ops_gp_kernel.py`` runs it. Both are
fed the same cache: the JAX GP's ``chol_inv``, ``alpha`` and buffers,
adopted by the port through ``convert``. The kernel itself runs only on a
GPU: its cases are in ``test_torch_cuda_kernel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safe_learning_tpu as sl
from safe_learning_tpu.ops.gp_kernel import fused_gp_predict as jax_fused
from safe_learning_tpu_torch.ops import gp_kernel

from _torch_parity import KINDS, port_gp, to_numpy, working_dtype

# float64: the tolerance of tests/test_ops_gp_kernel.py. float32: both
# sides round to float32 (different summation orders) on matrices with
# |L^-1| entries near 1e2 at noise 1e-4, so agreement is to about
# 1e2 * cap * eps32 relative to the outputs' scale.
TOL = {"float64": dict(rtol=1e-8, atol=1e-10),
       "float32": dict(rtol=2e-3, atol=2e-3)}


def _jax_gp(kind, n, cap, p, scale, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, size=(n, 2))
    y = np.column_stack([np.sin((j + 1) * x.sum(axis=1) + 0.3 * j)
                         for j in range(p)])
    kernel = KINDS[kind][0](variance=1.3, lengthscales=[0.7, 1.4],
                            input_dim=2)
    return sl.GaussianProcess(kernel, x, y, noise_variance=1e-4, beta=2.0,
                              capacity=cap, scale=scale)


def _both(kind, n, cap, p, scale, n_q, dtype="float64"):
    """JAX Pallas (interpret) and port plain outputs on one instance."""
    with working_dtype(dtype):
        gp = _jax_gp(kind, n, cap, p, scale)
        q = np.random.default_rng(1).uniform(-2.5, 2.5, size=(n_q, 2))
        q = q.astype(dtype)
        ls = gp.kernel.lengthscales
        s2 = gp.scale ** 2
        mean_j, var_j = jax_fused(
            jnp.asarray(q) / ls, gp.X_buf / ls, gp.chol_inv, gp.alpha,
            gp._mask(), gp.kernel.variance * s2, kind=kind, tile=128,
            interpret=True)
        pgp = port_gp(gp, adopt=True)
        pls = pgp.kernel.lengthscales
        mean_t, var_t = gp_kernel.gp_predict_plain(
            torch.as_tensor(q) / pls, pgp.X_buf / pls, pgp.chol_inv,
            pgp.alpha, pgp._mask(), pgp.kernel.variance * s2, kind=kind)
    return (np.asarray(mean_j), np.asarray(var_j), to_numpy(mean_t),
            to_numpy(var_t))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_matches_pallas_kernel(kind):
    mean_j, var_j, mean_t, var_t = _both(kind, n=17, cap=32, p=1,
                                         scale=1.0, n_q=301)
    assert_allclose(mean_t, mean_j, **TOL["float64"])
    assert_allclose(var_t, var_j, **TOL["float64"])


@pytest.mark.parametrize("cap,n,n_q", [(8, 5, 65), (32, 29, 129),
                                       (256, 200, 300)])
def test_plain_matches_pallas_scaled_multioutput_ragged(cap, n, n_q):
    mean_j, var_j, mean_t, var_t = _both("rbf", n=n, cap=cap, p=2,
                                         scale=25.0, n_q=n_q)
    assert mean_t.shape == (n_q, 2) and var_t.shape == (n_q,)
    assert_allclose(mean_t, mean_j, **TOL["float64"])
    assert_allclose(var_t, var_j, **TOL["float64"])


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_plain_matches_pallas_float32(kind):
    mean_j, var_j, mean_t, var_t = _both(kind, n=40, cap=64, p=2,
                                         scale=1.0, n_q=200,
                                         dtype="float32")
    assert mean_t.dtype == np.float32 and mean_j.dtype == np.float32
    assert_allclose(mean_t, mean_j, **TOL["float32"])
    assert_allclose(var_t, var_j, **TOL["float32"])


def test_gradient_matches_pallas_jvp():
    """The port's autograd (through the plain version) against the
    Pallas kernel's custom_jvp tangent (through its XLA twin)."""
    gp = _jax_gp("matern52", 12, 16, 2, 2.0)
    q = np.random.default_rng(3).uniform(-2.0, 2.0, size=(33, 2))
    ls = gp.kernel.lengthscales
    args = (gp.X_buf / ls, gp.chol_inv, gp.alpha, gp._mask(),
            gp.kernel.variance * gp.scale ** 2)

    def loss(qs):
        mean, var = jax_fused(qs, *args, kind="matern52", tile=128,
                              interpret=True)
        return jnp.sum(mean) + jnp.sum(var)

    grad_j = np.asarray(jax.grad(loss)(jnp.asarray(q) / ls))
    qs = torch.as_tensor(q / np.asarray(ls)).requires_grad_(True)
    mean, var = gp_kernel.fused_gp_predict(
        qs, *(torch.as_tensor(np.array(t)) for t in args),
        kind="matern52")
    (mean.sum() + var.sum()).backward()
    assert_allclose(qs.grad.numpy(), grad_j, rtol=1e-8, atol=1e-10)


def test_cpu_tensor_goes_to_plain_version():
    """A CPU tensor never reaches the CUDA wrapper or its counter."""
    before = gp_kernel.gp_predict_cuda.launches
    rng = np.random.default_rng(4)
    q = torch.as_tensor(rng.normal(size=(9, 3)))
    x = torch.as_tensor(rng.normal(size=(8, 3)))
    li = torch.eye(8, dtype=torch.float64)
    alpha = torch.as_tensor(rng.normal(size=(8, 2)))
    mask = torch.ones(8, dtype=torch.float64)
    out = gp_kernel.fused_gp_predict(q, x, li, alpha, mask, 1.0)
    plain = gp_kernel.gp_predict_plain(q, x, li, alpha, mask, 1.0)
    assert gp_kernel.gp_predict_cuda.launches == before
    for got, want in zip(out, plain):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        gp_kernel.gp_predict_cuda(q, x, li, alpha, mask, 1.0)

