"""Parity of kernel 1 with the expanded squared distance
(``safe_learning_tpu_torch/benchmarks/distance_mxu_experiment.py``) with
the JAX script ``benchmarks/distance_mxu_experiment.py``.

The script runs its experiment when imported, so only its function
definitions are taken (``ast``) and executed with ``jax``, ``jnp``,
``functools`` and the JAX package's ``_covariance``; its
``fused_predict_mxu_dist`` runs under ``pltpu.force_tpu_interpret_mode``.
Inputs come from a numpy seed (``_torch_parity.variant_inputs``).

Tolerances, elementwise against the absolute sums behind each output
(``variant_scales``): float32 to 2e-5. The script's dots accumulate in
float32 whatever the input dtype, so a float64 case meets it to the same
2e-5; the float64 port is held to 1e-12 against the JAX package's kernel
1 (interpret mode, float64 throughout) for the kinds smooth at r = 0
(RBF, Matern 3/2 and 5/2), where the expanded form's cancellation error
(about (d + 3) u (xx + 2|x||q| + qq) in r^2) moves k by a relative 1e-14.
Matern 1/2 has slope 1 in r at r = 0, which turns that error into up to
its square root; it is held to the script only.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_within_scales, variant_inputs,
                           variant_scales)
from safe_learning_tpu.ops.gp_kernel import _covariance
from safe_learning_tpu.ops.gp_kernel import fused_gp_predict as jax_kernel1
from safe_learning_tpu_torch.benchmarks import distance_mxu_experiment as dm

_SCRIPT = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                       "distance_mxu_experiment.py")


@functools.lru_cache(maxsize=None)
def jax_script():
    """The script's functions, without running its experiment."""
    with open(_SCRIPT) as f:
        tree = ast.parse(f.read())
    tree.body = [node for node in tree.body
                 if isinstance(node, ast.FunctionDef)]
    namespace = dict(jax=jax, jnp=jnp, functools=functools,
                     _covariance=_covariance)
    exec(compile(tree, _SCRIPT, "exec"), namespace)
    return namespace


def jax_expanded(inputs, kind):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return jax_script()["fused_predict_mxu_dist"](*inputs, kind=kind,
                                                      tile=128)


KINDS = ("rbf", "matern12", "matern32", "matern52")
SMOOTH = ("rbf", "matern32", "matern52")
#: (capacity, active rows, d, p).
CASES = ((16, 16, 3, 1), (16, 11, 5, 3), (128, 128, 3, 2), (128, 97, 5, 4))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}


def both(case, dtype, seed):
    cap, n, d, p = case
    raw = variant_inputs(cap, n, d, p, seed)
    jdt, tdt = DTYPES[dtype]
    port = tuple(torch.as_tensor(np.asarray(a), dtype=tdt) for a in raw)
    jax_in = tuple(jnp.asarray(np.asarray(a), dtype=jdt) for a in raw)
    return raw, port, jax_in


@pytest.mark.parametrize("ci", range(len(CASES)))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_expanded_matches_jax_script(kind, dtype, ci):
    case = CASES[ci]
    raw, port, jax_in = both(case, dtype, seed=20 + ci)
    count = case[1] if ci % 2 else None
    got = dm.fused_predict_mxu_dist(*port, kind=kind, count=count)
    want = jax_expanded(jax_in, kind)
    assert got[0].shape == (517, case[3]) and got[1].shape == (517,)
    assert_within_scales(got, want, variant_scales(*raw, kind), 2e-5)


@pytest.mark.parametrize("ci", range(len(CASES)))
@pytest.mark.parametrize("kind", SMOOTH)
def test_float64_expanded_matches_jax_kernel1(kind, ci):
    case = CASES[ci]
    raw, port, jax_in = both(case, "float64", seed=30 + ci)
    got = dm.fused_predict_mxu_dist(*port, kind=kind, count=case[1])
    want = jax_kernel1(*jax_in, kind=kind, tile=128, interpret=True)
    assert_within_scales(got, want, variant_scales(*raw, kind), 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_expanded_distance_clamps_at_zero(dtype):
    """Queries equal to training points: the expanded form cancels to
    about (d + 3) u (xx + 2|x||q| + qq) around 0, below it for some rows,
    and the clamp returns 0 there; Matern 1/2's square root stays finite."""
    raw = variant_inputs(128, 128, 5, 2, seed=7)
    x = torch.as_tensor(raw[1], dtype=dtype)
    q = x[:64].clone()
    xx = (x * x).sum(1)
    raw_r2 = xx[:, None] - 2.0 * (x @ q.T) + xx[:64][None, :]
    assert (raw_r2.diagonal() < 0).any()
    r2 = dm.expanded_sq_dist(q, x)
    assert (r2 >= 0).all()
    u = torch.finfo(dtype).eps / 2
    assert (r2.diagonal() <= 8 * u * 4 * xx[:64]).all()
    inputs = (q,) + tuple(torch.as_tensor(a, dtype=dtype) for a in raw[1:])
    for kind in KINDS:
        mean, var = dm.fused_predict_mxu_dist_plain(*inputs, kind=kind)
        assert torch.isfinite(mean).all() and torch.isfinite(var).all()


def test_wrapper_contract():
    _, port, _ = both(CASES[0], "float32", seed=8)
    want = dm.fused_predict_mxu_dist_plain(*port)
    for precision in dm.PRECISIONS:
        got = dm.fused_predict_mxu_dist(*port, tile=256, precision=precision)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="precision"):
        dm.fused_predict_mxu_dist(*port, precision="default")
    with pytest.raises(RuntimeError, match="forward only"):
        dm.fused_predict_mxu_dist(port[0].clone().requires_grad_(True),
                                  *port[1:])
    with pytest.raises(RuntimeError, match="on the card"):
        dm.run(port)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dm.fused_predict_mxu_dist_cuda(*port)
    assert dm.fused_predict_mxu_dist_cuda.launches == 0


def test_oracle_is_float64_kernel1_on_the_first_queries():
    from safe_learning_tpu_torch.ops.gp_kernel import gp_predict_plain

    _, port, _ = both(CASES[2], "float32", seed=9)
    ref = dm.oracle_mean(port, kind="matern32", queries=100)
    assert ref.dtype == torch.float64 and ref.shape == (100, 2)
    want = gp_predict_plain(port[0][:100].double(),
                            *(t.double() for t in port[1:5]),
                            float(port[5]), kind="matern32")[0]
    torch.testing.assert_close(ref, want, rtol=0, atol=0)


def test_experiment_gp_is_the_scripts_instance():
    import safe_learning_tpu_torch as st

    old = st.config.dtype
    st.config.dtype = torch.float64
    try:
        gp, rng = dm.experiment_gp()
    finally:
        st.config.dtype = old
    x = np.random.default_rng(0).uniform(-1, 1, size=(128, 3))
    np.testing.assert_array_equal(gp.X, x)
    assert gp.count == gp.capacity == 128 and gp.output_dim == 2
    np.testing.assert_array_equal(
        rng.uniform(-1, 1, size=(2, 3)),
        np.random.default_rng(0).uniform(-1, 1, size=(130, 3))[128:])
