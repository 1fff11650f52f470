"""Kernels 2 and 3 above the panel body's counts: the port's plain twins
against the JAX package's Pallas kernels (kernel 1's and the rigor
sweep's: ``tests/test_torch_strip_rigor.py``).

Above the panel body's largest count (512 rows in float32, 256 in
float64) up to the 2,048 rows the GPs route to a kernel, the CUDA kernels
1-3 run their strip body, and on the card ``chip_smoke.py`` and
``tests/test_torch_cuda_kernel.py`` hold it to the plain twins. Here
those twins, reached through the port's ``fused_*`` entries on CPU
tensors, meet the JAX package's ``fused_gp_predict_general`` and
``fused_gp_predict_stacked`` run with
``interpret=True`` on the JAX GP's own cache, adopted by the port, at
counts 600, 1,021 and 2,048, float32 and float64, 64 queries. The
difference is held to the computed forward-error bounds the card's cases
use (``chip_smoke.rounding_bounds``, ``chip_smoke.program_bounds``: both
sides round, each counted): they grow with the count, where the fixed
tolerances of ``tests/test_torch_program_counts.py`` were set for 256
rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import safe_learning_tpu as sl
from safe_learning_tpu.ops.gp_kernel import (compile_kernel_program as
                                             jax_compile,
                                             fused_gp_predict_general as
                                             jax_general,
                                             fused_gp_predict_stacked as
                                             jax_stacked)
from safe_learning_tpu_torch.ops import gp_kernel

from _torch_parity import (port_gp, port_stacked_gp, to_numpy,
                           working_dtype)
from test_torch_program_counts import _composite, _data

#: ``(capacity, count)``: above both panel limits, the adaptive loop
#: grown to 1,024 points, and the largest count a GP routes to a kernel.
CASES = [(1024, 600), (1024, 1021), (2048, 2048)]

QUERIES = 64


def _held(got, want, bounds):
    """Port and JAX numerators within the elementwise bounds."""
    for g, w, b in zip(got, want, bounds):
        g, w = to_numpy(g).astype(np.float64), np.asarray(w, np.float64)
        b = to_numpy(b).reshape(g.shape)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert (np.abs(g - w) <= b).all(), float(np.max(np.abs(g - w) / b))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("cap,count", CASES)
def test_general_plain_matches_pallas_above_the_panel(cap, count, dtype):
    """Kernel 2's twin: one composite-kernel GP with two outputs."""
    from chip_smoke import program_bounds

    with working_dtype(dtype):
        x, y, q = _data(count, 2, seed=cap + 2 * count)
        q = q[:QUERIES]
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
        inputs = (qt, pgp.X_buf, gp_kernel.program_params(pparams, qt),
                  pgp.chol_inv, pgp.alpha, pgp._mask(), pgp.scale ** 2)
        got = gp_kernel.fused_gp_predict_general(*inputs, pprogram,
                                                 count=pgp.count)
        unit = torch.finfo(qt.dtype).eps / 2
        bounds = program_bounds(*inputs[:3], pgp.chol_inv[None],
                                pgp.alpha[None], *inputs[5:], (pprogram,),
                                unit)
    assert got[0].shape == (QUERIES, 2) and got[1].shape == (QUERIES,)
    _held(got, want, bounds)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("cap,count", CASES)
def test_stacked_plain_matches_pallas_above_the_panel(cap, count, dtype):
    """Kernel 3's twin: two outputs over shared inputs (the adaptive
    example's stacked GP structure), scale 1.4."""
    from chip_smoke import program_bounds

    with working_dtype(dtype):
        x, y, q = _data(count, 2, seed=cap + count)
        q = q[:QUERIES]
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
        inputs = (qt, pstack.X_buf, gp_kernel.program_params(pparams, qt),
                  pstack.chol_inv, pstack.alpha[:, :, 0].contiguous(),
                  pstack._mask(), s2)
        got = gp_kernel.fused_gp_predict_stacked(*inputs, pprograms,
                                                 count=pstack.count)
        unit = torch.finfo(qt.dtype).eps / 2
        bounds = program_bounds(*inputs[:4], inputs[4][:, :, None],
                                *inputs[5:], pprograms, unit)
    assert got[0].shape == (QUERIES, 2) and got[1].shape == (QUERIES, 2)
    _held(got, want, bounds)
