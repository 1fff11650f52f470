"""Kernels 2 and 3 above 128 data points: the port's plain twins against
the JAX package's Pallas kernels.

Above count 128 the CUDA kernels 2 and 3 run their panel body, and on the
card ``chip_smoke.py`` and ``tests/test_torch_cuda_kernel.py`` hold it to
the plain twins ``gp_predict_stacked_plain`` and
``gp_predict_general_plain``. Here those twins meet
``fused_gp_predict_stacked`` and ``fused_gp_predict_general`` run with
``interpret=True`` (as ``tests/test_ops_gp_kernel.py:270,293`` run them)
on the JAX GP's own cache, adopted by the port, at the capacities the
panel body serves: the adaptive example's 181 and 256, at counts 129, 181
and 256. The other parity tests of these twins stop at capacity 16
(``tests/test_torch_stacked_gp.py``, ``tests/test_torch_gp_program.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safe_learning_tpu as sl
from safe_learning_tpu.functions.gp import ActiveDims, LinearKernel
from safe_learning_tpu.ops.gp_kernel import (compile_kernel_program as
                                             jax_compile,
                                             fused_gp_predict_general as
                                             jax_general,
                                             fused_gp_predict_stacked as
                                             jax_stacked)
from safe_learning_tpu_torch.ops import gp_kernel

from _torch_parity import (port_gp, port_stacked_gp, to_numpy,
                           working_dtype)

#: ``(capacity, count)``: above the tiled body's 128 rows, below and at
#: capacity.
CASES = [(181, 129), (181, 181), (256, 129), (256, 181), (256, 256)]

#: float64: both sides evaluate the same programs and differ by summation
#: order over up to 256 rows, amplified by |L^-1| (noise 1e-2 keeps its
#: entries below about 7 here); the numerators are 2 to 8 in size.
TOL64 = dict(rtol=1e-10, atol=1e-12)

#: float32: each side rounds k (about 20 operations a row) and sums
#: a = L^-1 k over up to 256 rows in its own order: with |L^-1| up to
#: about 7 and |k| up to about 2, below 256 * 7 * 2 * 6e-8 = 2.2e-4 of the
#: numerators' size. They are held to 5e-4 of the largest numerator.
REL32 = 5e-4

QUERIES = 301


def _composite(dim):
    """The adaptive example's kernel structure (``Linear + Matern32 x
    Linear`` on the first input), per output ``dim``."""
    return (LinearKernel(variances=[0.3, 0.1 + 0.1 * dim, 0.5], input_dim=3)
            + ActiveDims(sl.Matern32(variance=1.0,
                                     lengthscales=0.7 + 0.2 * dim,
                                     input_dim=1), dims=[0])
            * ActiveDims(LinearKernel(variances=0.4, input_dim=1),
                         dims=[0]))


def _data(count, width, seed):
    """``count`` training rows in [-1.5, 1.5]^3, ``width`` targets, and
    the queries, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, size=(count, 3))
    y = np.column_stack([np.sin((j + 1) * x.sum(axis=1) + 0.3 * j)
                         for j in range(width)])
    q = rng.uniform(-1.8, 1.8, size=(QUERIES, 3))
    return x, y, q


def _check(got, want, dtype):
    """Numerators of the port and the JAX package, as numpy arrays."""
    for g, w in zip(got, want):
        g, w = to_numpy(g), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        if dtype == "float64":
            assert_allclose(g, w, **TOL64)
        else:
            assert np.abs(g - w).max() <= REL32 * np.abs(w).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("cap,count", CASES)
def test_stacked_plain_matches_pallas_above_128(cap, count, dtype):
    """Kernel 3's twin: two outputs over shared inputs (the adaptive
    example's stacked GP), scale 1.4."""
    with working_dtype(dtype):
        x, y, q = _data(count, 2, seed=cap + count)
        stacked = sl.StackedGaussianProcess(
            [_composite(0), _composite(1)], x, y, [1e-2, 2e-2], scale=1.4,
            capacity=cap)
        assert int(stacked.count) == count
        params, programs = [], []
        for kernel in stacked.kernels:
            program, params = jax_compile(kernel, input_dim=3,
                                          params=params)
            programs.append(program)
        jparams = jnp.concatenate([jnp.asarray(p).reshape(-1)
                                   for p in params])
        s2 = stacked.scale ** 2
        want = jax_stacked(jnp.asarray(q, dtype=getattr(jnp, dtype)),
                           stacked.X_buf, jparams, stacked.chol_inv,
                           stacked.alpha[:, :, 0], stacked._mask(), s2,
                           tuple(programs), tile=128, interpret=True)
        pstack = port_stacked_gp(stacked, adopt=True)
        pprograms, pparams = pstack._programs()
        assert pprograms == tuple(programs)
        qt = torch.as_tensor(q, dtype=getattr(torch, dtype))
        got = gp_kernel.gp_predict_stacked_plain(
            qt, pstack.X_buf, gp_kernel.program_params(pparams, qt),
            pstack.chol_inv, pstack.alpha[:, :, 0], pstack._mask(), s2,
            pprograms, count=pstack.count)
    assert got[0].shape == (QUERIES, 2) and got[1].shape == (QUERIES, 2)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("cap,count", CASES)
def test_general_plain_matches_pallas_above_128(cap, count, dtype):
    """Kernel 2's twin: one composite-kernel GP with two outputs."""
    with working_dtype(dtype):
        x, y, q = _data(count, 2, seed=cap + 2 * count)
        gp = sl.GaussianProcess(_composite(1), x, y, noise_variance=1e-2,
                                scale=1.4, capacity=cap)
        assert int(gp.count) == count
        program, params = jax_compile(gp.kernel, input_dim=3)
        jparams = jnp.concatenate([jnp.asarray(p).reshape(-1)
                                   for p in params])
        want = jax_general(jnp.asarray(q, dtype=getattr(jnp, dtype)),
                           gp.X_buf, jparams, gp.chol_inv, gp.alpha,
                           gp._mask(), gp.scale ** 2, program, tile=128,
                           interpret=True)
        pgp = port_gp(gp, adopt=True)
        pprogram, pparams = gp_kernel.compile_kernel_program(pgp.kernel,
                                                             input_dim=3)
        assert pprogram == program
        qt = torch.as_tensor(q, dtype=getattr(torch, dtype))
        got = gp_kernel.gp_predict_general_plain(
            qt, pgp.X_buf, gp_kernel.program_params(pparams, qt),
            pgp.chol_inv, pgp.alpha, pgp._mask(), pgp.scale ** 2, pprogram,
            count=pgp.count)
    assert got[0].shape == (QUERIES, 2) and got[1].shape == (QUERIES,)
    _check(got, want, dtype)
