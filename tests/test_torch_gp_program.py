"""Covariance programs, composite kernels and the general predict's plain
twin against the JAX package.

The port's ``compile_kernel_program`` must give the JAX package's program
tuples and parameter vectors; the plain twin of the general kernel
(``gp_predict_general_plain``) must match the Pallas kernel
``fused_gp_predict_general(..., interpret=True)`` run as
``tests/test_ops_gp_kernel.py:146`` runs it, on the JAX GP's own cache;
composite kernels and a ``GaussianProcess`` built on one must match the
JAX package's. The CUDA kernel itself runs only on a GPU
(``test_torch_cuda_kernel.py``); here its source is rendered, not
compiled.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu.functions.gp import ActiveDims, LinearKernel
from safe_learning_tpu.ops.gp_kernel import (compile_kernel_program as
                                             jax_compile,
                                             fused_gp_predict_general as
                                             jax_general)
from safe_learning_tpu_torch.ops import gp_kernel

from _torch_parity import port_gp, port_kernel, to_numpy, working_dtype

# float64, as tests/test_torch_gp_kernel.py: both sides evaluate the same
# program in f64 and differ by summation order, amplified by |L^-1|.
TOL = dict(rtol=1e-8, atol=1e-10)


def _kernels():
    """name -> (JAX kernel, data dimension, input_dim passed to compile).

    The four programs ``chip_smoke.py`` holds the CUDA kernels to
    (``case_programs``), the composite families of
    ``tests/test_ops_gp_kernel.py:121-141`` and the structures of its
    ``:175`` and ``:348`` cases.
    """
    lin3 = LinearKernel(variances=[0.3, 0.1, 0.5], input_dim=3)
    return {
        "flagship": (lin3 + ActiveDims(sl.Matern32(lengthscales=1.0,
                                                   input_dim=1), dims=[0])
                     * ActiveDims(LinearKernel(variances=0.1, input_dim=1),
                                  dims=[0]), 3, 3),
        "ard_rbf": (sl.RBF(1.3, [0.7, 1.4, 0.9], input_dim=3), 3, 3),
        "product": (ActiveDims(sl.Matern52(0.9, [0.6, 1.1], input_dim=2),
                               dims=[0, 1])
                    * ActiveDims(sl.RBF(1.2, 0.8, input_dim=1), dims=[2]),
                    3, 3),
        "sum3": (sl.Matern12(0.5, [0.9, 0.7, 1.3], input_dim=3)
                 + sl.Matern52(0.8, [1.2, 0.5, 0.8], input_dim=3)
                 + LinearKernel(variances=[0.2, 0.4, 0.1], input_dim=3),
                 3, 3),
        "notebook3d": (lin3 + ActiveDims(sl.Matern32(
            variance=1.0, lengthscales=0.8, input_dim=1), dims=[0])
            * ActiveDims(LinearKernel(variances=0.4, input_dim=1),
                         dims=[0]), 3, None),
        "roa1d": (ActiveDims(sl.Matern32(variance=0.16, lengthscales=1.0,
                                         input_dim=1), dims=[0])
                  * ActiveDims(LinearKernel(variances=1.0, input_dim=1),
                               dims=[0]), 2, None),
        "one_d": (sl.Matern32(lengthscales=1.0, input_dim=2)
                  * LinearKernel(variances=[0.2, 1.0], input_dim=2), 2,
                  None),
        "ard_sum": (sl.RBF(variance=0.5, lengthscales=[0.4, 1.2],
                           input_dim=2)
                    + sl.Matern52(variance=0.2, lengthscales=[2.0, 0.6],
                                  input_dim=2), 2, None),
        "dims2": (ActiveDims(sl.Matern32(variance=1.0, lengthscales=1.0,
                                         input_dim=1), dims=[2])
                  * ActiveDims(LinearKernel(variances=1.0, input_dim=1),
                               dims=[2]), 3, None),
        "nested": (ActiveDims(ActiveDims(sl.RBF(1.0, 1.0, input_dim=1),
                                         dims=[0]), dims=[1]), 2, None),
        "broadcast": (sl.RBF(1.0, 0.5) + LinearKernel(0.3), 2, 2),
    }


def _flat(params):
    return np.concatenate([np.asarray(p).reshape(-1) for p in params])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(_kernels()))
def test_programs_equal_jax(name, dtype):
    """Equal program tuples, and parameter vectors equal to the last bit:
    both packages take the reciprocal of the lengthscales in the working
    dtype."""
    with working_dtype(dtype):
        kernel, _, input_dim = _kernels()[name]
        pkernel = port_kernel(kernel)
        jprog, jparams = jax_compile(kernel, input_dim=input_dim)
        pprog, pparams = gp_kernel.compile_kernel_program(
            pkernel, input_dim=input_dim)
        flat = gp_kernel.program_params(pparams, pkernel_like(dtype))
    assert pprog == jprog
    assert flat.dtype == getattr(torch, dtype)
    assert_array_equal(flat.numpy(), _flat(jparams).astype(dtype))


def pkernel_like(dtype):
    return torch.zeros(1, dtype=getattr(torch, dtype))


def test_stacked_programs_share_one_parameter_space():
    """Programs compiled into one parameter list, as the stacked GP does,
    carry the JAX package's offsets."""
    with working_dtype("float64"):
        names = ("ard_rbf", "product", "sum3")
        jparams, pparams, jprogs, pprogs = [], [], [], []
        for name in names:
            kernel, _, dim = _kernels()[name]
            prog, jparams = jax_compile(kernel, input_dim=dim,
                                        params=jparams)
            jprogs.append(prog)
            prog, pparams = gp_kernel.compile_kernel_program(
                port_kernel(kernel), input_dim=dim, params=pparams)
            pprogs.append(prog)
    assert pprogs == jprogs
    assert_array_equal(torch.cat([p.reshape(-1) for p in pparams]).numpy(),
                       _flat(jparams))


def test_kernels_that_do_not_compile():
    """A vector parameter that does not span the data, and a subclass of
    a stationary family, compile to ``None`` in both packages."""
    with working_dtype("float64"):
        bad = sl.RBF(1.0, [0.5, 0.7], input_dim=2)
        assert jax_compile(bad, input_dim=3) is None
        assert gp_kernel.compile_kernel_program(port_kernel(bad),
                                                input_dim=3) is None

        class Weird(st.Matern32):
            pass

        assert gp_kernel.compile_kernel_program(
            Weird(1.0, 1.0, input_dim=1)) is None


@pytest.mark.parametrize("name", ["flagship", "ard_rbf", "product", "sum3",
                                  "roa1d", "one_d", "ard_sum"])
def test_general_plain_matches_pallas_kernel(name):
    """The plain twin against the Pallas kernel in interpret mode, on the
    JAX GP's own cache (adopted by the port), in float64."""
    with working_dtype("float64"):
        kernel, d, _ = _kernels()[name]
        rng = np.random.default_rng(2)
        x = rng.uniform(-1.5, 1.5, size=(13, d))
        y = np.column_stack([np.sin(x.sum(axis=1)), np.cos(x[:, 0])])
        gp = sl.GaussianProcess(kernel, x, y, noise_variance=1e-4,
                                scale=1.5, capacity=16)
        q = rng.uniform(-2, 2, size=(301, d))
        program, params = jax_compile(gp.kernel, input_dim=d)
        jparams = jnp.asarray(_flat(params))
        mean_j, var_j = jax_general(
            jnp.asarray(q), gp.X_buf, jparams, gp.chol_inv, gp.alpha,
            gp._mask(), gp.scale ** 2, program, tile=128, interpret=True)
        pgp = port_gp(gp, adopt=True)
        pprog, pparams = gp_kernel.compile_kernel_program(pgp.kernel,
                                                          input_dim=d)
        qt = torch.as_tensor(q)
        mean_t, var_t = gp_kernel.gp_predict_general_plain(
            qt, pgp.X_buf, gp_kernel.program_params(pparams, qt),
            pgp.chol_inv, pgp.alpha, pgp._mask(), pgp.scale ** 2, pprog)
    assert mean_t.shape == (301, 2) and var_t.shape == (301,)
    assert_allclose(to_numpy(mean_t), np.asarray(mean_j), **TOL)
    assert_allclose(to_numpy(var_t), np.asarray(var_j), **TOL)


def test_general_gradient_matches_pallas_jvp():
    """Autograd through the twin (what the CUDA kernel's autograd rule
    differentiates) against ``jax.grad`` through the Pallas kernel's
    ``custom_jvp``, with respect to the query points."""
    with working_dtype("float64"):
        kernel, d, _ = _kernels()["flagship"]
        rng = np.random.default_rng(12)
        x = rng.uniform(-1.5, 1.5, size=(9, d))
        gp = sl.GaussianProcess(kernel, x, np.sin(x[:, :1]), 1e-4,
                                capacity=16)
        q = rng.uniform(-1, 1, size=(40, d))
        program, params = jax_compile(gp.kernel, input_dim=d)
        args = (gp.X_buf, jnp.asarray(_flat(params)), gp.chol_inv,
                gp.alpha, gp._mask(), 1.0)

        def loss(qs):
            mean, var = jax_general(qs, *args, program, tile=128,
                                    interpret=True)
            return jnp.sum(mean ** 2) + jnp.sum(var)

        grad_j = np.asarray(jax.grad(loss)(jnp.asarray(q)))
        pgp = port_gp(gp, adopt=True)
        pprog, pparams = gp_kernel.compile_kernel_program(pgp.kernel,
                                                          input_dim=d)
        qt = torch.as_tensor(q).requires_grad_(True)
        mean, var = gp_kernel.fused_gp_predict_general(
            qt, pgp.X_buf, gp_kernel.program_params(pparams, qt),
            pgp.chol_inv, pgp.alpha, pgp._mask(), 1.0, pprog)
        ((mean ** 2).sum() + var.sum()).backward()
    assert_allclose(qt.grad.numpy(), grad_j, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name", ["flagship", "product", "sum3", "one_d"])
def test_composite_kernel_matches_jax(name):
    """``__call__`` (both forms) and ``diag`` of the composite kernels."""
    with working_dtype("float64"):
        kernel, d, _ = _kernels()[name]
        rng = np.random.default_rng(3)
        x = rng.uniform(-1.5, 1.5, size=(11, d))
        z = rng.uniform(-1.5, 1.5, size=(7, d))
        pkernel = port_kernel(kernel)
        for got, want in ((pkernel(x, z), kernel(x, z)),
                          (pkernel(x), kernel(x)),
                          (pkernel.diag(x), kernel.diag(x))):
            assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-12,
                            atol=1e-14)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("name", ["flagship", "sum3"])
def test_composite_gp_predict_matches_jax(name, use_kernels):
    """A ``GaussianProcess`` with a composite kernel: the port's fused
    route (the general twin) and its matmul chain against the JAX GP, which
    takes its matmul chain on the CPU; ``full_cov`` too."""
    with working_dtype("float64"):
        kernel, d, _ = _kernels()[name]
        rng = np.random.default_rng(5)
        x = rng.uniform(-1.0, 1.0, size=(23, d))
        y = np.column_stack([np.sin(x.sum(axis=1)), np.cos(x[:, 0])])
        q = rng.uniform(-1.5, 1.5, size=(57, d))
        jgp = sl.GaussianProcess(kernel, x, y, noise_variance=1e-3,
                                 beta=2.5, scale=4.0)
        pgp = port_gp(jgp)
        old = st.config.use_kernels
        st.config.use_kernels = use_kernels
        try:
            mean_t, err_t = map(to_numpy, pgp(q))
            mean_c, cov_t = map(to_numpy, pgp.predict(q[:9], full_cov=True))
        finally:
            st.config.use_kernels = old
        mean_j, err_j = map(np.asarray, jgp(q))
        _, cov_j = map(np.asarray, jgp.predict(q[:9], full_cov=True))
    assert mean_t.shape == (57, 2) and err_t.shape == (57, 2)
    assert_allclose(mean_t, mean_j, rtol=1e-9, atol=1e-11)
    assert_allclose(err_t, err_j, rtol=1e-9, atol=1e-11)
    assert_allclose(mean_c, mean_j[:9], rtol=1e-9, atol=1e-11)
    assert_allclose(cov_t, cov_j, rtol=1e-9, atol=1e-11)


def _flagship_programs():
    with working_dtype("float32"):
        kernel = _kernels()["flagship"][0]
        params, programs = [], []
        for _ in range(2):
            program, params = gp_kernel.compile_kernel_program(
                port_kernel(kernel), input_dim=3, params=params)
            programs.append(program)
    return tuple(programs)


@pytest.mark.parametrize("n_out", [1, 2])
def test_rendered_source_names_every_parameter(n_out):
    """The CUDA text of the flagship's programs (general: one; stacked:
    two over one parameter space) reads every parameter offset, declares
    the counts, and bakes in no parameter value. It is not compiled
    here."""
    programs = _flagship_programs()[:n_out]
    text = gp_kernel.render_program_source(programs)
    n_params = 6 * n_out
    read = {int(i) for i in re.findall(r"pr\[(\d+)\]", text)}
    assert read == set(range(n_params))
    assert "NUM_OUT = {};".format(n_out) in text
    assert "NUM_PARAMS = {};".format(n_params) in text
    assert "MIN_D = 3;" in text
    assert text.count("cov_matern32<T>") == n_out
    assert '#include "gp_predict_program.cuh"' in text
    assert "GP_PROGRAM_EXPORTS(CovarianceProgram)" in text
    # Values stay runtime arguments: no literal of the flagship's
    # hyperparameters appears in the code.
    code = "\n".join(line for line in text.splitlines()
                     if not line.startswith("//"))
    assert not re.search(r"\d\.\d", code)


def test_render_limits():
    program = _flagship_programs()[0]
    with pytest.raises(ValueError, match="outputs"):
        gp_kernel.render_program_source(
            (program,) * (gp_kernel.PROGRAM_OUTPUTS_MAX + 1))
    with pytest.raises(ValueError, match="parameters"):
        gp_kernel.render_program_source(
            (("linear", (0,), gp_kernel.PROGRAM_PARAMS_MAX),))


def test_cpu_tensors_go_to_the_plain_versions():
    """A CPU tensor never reaches the CUDA wrappers or their counters; a
    CUDA wrapper given CPU tensors raises."""
    programs = _flagship_programs()
    rng = np.random.default_rng(4)
    q = torch.as_tensor(rng.normal(size=(9, 3)))
    x = torch.as_tensor(rng.normal(size=(8, 3)))
    params = torch.as_tensor(rng.uniform(0.5, 1.5, size=12))
    li = torch.eye(8, dtype=torch.float64)
    mask = torch.ones(8, dtype=torch.float64)
    alpha = torch.as_tensor(rng.normal(size=(8, 2)))
    before = (gp_kernel.gp_predict_general_cuda.launches,
              gp_kernel.gp_predict_stacked_cuda.launches)
    out = gp_kernel.fused_gp_predict_general(q, x, params, li, alpha, mask,
                                             1.0, programs[0])
    plain = gp_kernel.gp_predict_general_plain(q, x, params, li, alpha,
                                               mask, 1.0, programs[0])
    for got, want in zip(out, plain):
        assert torch.equal(got, want)
    li2, alpha_t = torch.stack([li, 2 * li]), alpha.T.contiguous()
    out = gp_kernel.fused_gp_predict_stacked(q, x, params, li2, alpha_t,
                                             mask, 1.0, programs)
    plain = gp_kernel.gp_predict_stacked_plain(q, x, params, li2, alpha_t,
                                               mask, 1.0, programs)
    for got, want in zip(out, plain):
        assert got.shape == (9, 2) and torch.equal(got, want)
    assert (gp_kernel.gp_predict_general_cuda.launches,
            gp_kernel.gp_predict_stacked_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        gp_kernel.gp_predict_general_cuda(q, x, params, li, alpha, mask,
                                          1.0, programs[0])
    with pytest.raises(ValueError, match="CUDA"):
        gp_kernel.gp_predict_stacked_cuda(q, x, params, li2, alpha_t, mask,
                                          1.0, programs)
