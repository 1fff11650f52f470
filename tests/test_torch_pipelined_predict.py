"""Parity of kernel 1's pipelined, interleaved and folded variants
(``safe_learning_tpu_torch/benchmarks/pipelined_predict.py``) with the JAX
script ``benchmarks/pipelined_predict.py``, run in Pallas interpret mode.

The script has a ``main()`` guard and its folder no ``__init__``, so it is
loaded from its file. Inputs come from a numpy seed: capacities 16 and
128, counts at and below capacity (identity-padded ``chol_inv``, a zero
mask tail), d = 3 and 5, p = 1 to 4, 517 queries (a ragged last tile at
the JAX ``tile=128``).

Tolerances, elementwise against the absolute sums behind each output
(``variant_scales``): float32 to 2e-5. The script's dots accumulate in
float32 whatever the input dtype (``preferred_element_type=jnp.float32``),
so a float64 case meets it to the same 2e-5; the float64 port is held to
1e-12 against the JAX package's kernel 1 (``fused_gp_predict`` in
interpret mode), which accumulates in float64 and computes the same
function.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_within_scales, variant_inputs,
                           variant_scales)
from safe_learning_tpu.ops.gp_kernel import fused_gp_predict as jax_kernel1
from safe_learning_tpu_torch.benchmarks import pipelined_predict as pp

_SCRIPT = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                       "pipelined_predict.py")


@functools.lru_cache(maxsize=None)
def jax_script():
    """The JAX script as a module (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location("jax_pipelined_predict",
                                                  _SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


KINDS = ("rbf", "matern12", "matern32", "matern52")
#: (capacity, active rows, d, p).
CASES = ((16, 16, 3, 1), (16, 11, 5, 3), (128, 128, 3, 2), (128, 97, 5, 4))
VARIANTS = ("pipelined", "interleaved2", "interleaved4", "folded")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}


def port_call(variant, inputs, kind, count):
    fn, kw = {"pipelined": (pp.pipelined_gp_predict, {}),
              "interleaved2": (pp.interleaved_gp_predict, {"halves": 2}),
              "interleaved4": (pp.interleaved_gp_predict, {"halves": 4}),
              "folded": (pp.folded_gp_predict, {})}[variant]
    return fn(*inputs, kind=kind, count=count, **kw)


def jax_call(variant, inputs, kind):
    script = jax_script()
    fn, kw = {"pipelined": (script.pipelined_gp_predict, {}),
              "interleaved2": (script.interleaved_gp_predict, {"halves": 2}),
              "interleaved4": (script.interleaved_gp_predict, {"halves": 4}),
              "folded": (script.folded_gp_predict, {})}[variant]
    return fn(*inputs, kind=kind, tile=128, interpret=True, **kw)


def both(case, dtype, seed):
    """The case's inputs as torch tensors and as JAX arrays."""
    cap, n, d, p = case
    raw = variant_inputs(cap, n, d, p, seed)
    jdt, tdt = DTYPES[dtype]
    port = tuple(torch.as_tensor(np.asarray(a), dtype=tdt) for a in raw)
    jax_in = tuple(jnp.asarray(np.asarray(a), dtype=jdt) for a in raw)
    return raw, port, jax_in


@pytest.mark.parametrize("ci", range(len(CASES)))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax_script(variant, dtype, ci):
    case = CASES[ci]
    kind = KINDS[ci]
    raw, port, jax_in = both(case, dtype, seed=ci)
    count = case[1] if ci % 2 else None
    got = port_call(variant, port, kind, count)
    want = jax_call(variant, jax_in, kind)
    assert got[0].shape == (517, case[3]) and got[1].shape == (517,)
    assert_within_scales(got, want, variant_scales(*raw, kind), 2e-5)


@pytest.mark.parametrize("ci", range(len(CASES)))
@pytest.mark.parametrize("variant", VARIANTS)
def test_float64_variant_matches_jax_kernel1(variant, ci):
    case = CASES[ci]
    kind = KINDS[(ci + 1) % len(KINDS)]
    raw, port, jax_in = both(case, "float64", seed=10 + ci)
    got = port_call(variant, port, kind, case[1])
    want = jax_kernel1(*jax_in, kind=kind, tile=128, interpret=True)
    assert_within_scales(got, want, variant_scales(*raw, kind), 1e-12)


def test_fold_is_the_jax_fold():
    raw, port, jax_in = both(CASES[1], "float64", seed=3)
    q, x, li, alpha, mask, var_s2 = jax_in
    want = li * (jnp.asarray(var_s2, dtype=li.dtype) * mask)[None, :]
    got = pp.fold_chol_inv(port[2], port[4], port[5])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The folded padding keeps kernel 1's precondition.
    assert not got[11:, :11].any() and not got[:, 11:].any()


@pytest.mark.parametrize("variant", VARIANTS)
def test_cpu_dispatch_is_the_plain_version(variant):
    """On CPU tensors each wrapper is its plain version, ``tile`` and
    ``interpret`` unused; the plain versions of the pipelined and
    interleaved schedules are kernel 1's function."""
    from safe_learning_tpu_torch.ops.gp_kernel import gp_predict_plain

    _, port, _ = both(CASES[3], "float64", seed=4)
    got = port_call(variant, port, "matern52", 97)
    if variant == "folded":
        folded = pp.fold_chol_inv(port[2], port[4], port[5])
        want = pp.folded_gp_predict_plain(port[0], port[1], folded, port[3],
                                          kind="matern52")
    else:
        want = gp_predict_plain(*port, kind="matern52")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    again = port_call(variant, port, "matern52", 97)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_wrappers_are_forward_only_and_check_their_arguments():
    _, port, _ = both(CASES[0], "float32", seed=5)
    q = port[0].clone().requires_grad_(True)
    for fn in (pp.pipelined_gp_predict, pp.interleaved_gp_predict,
               pp.folded_gp_predict):
        with pytest.raises(RuntimeError, match="forward only"):
            fn(q, *port[1:])
        with torch.no_grad():
            fn(q, *port[1:], tile=256, interpret=True)
    for halves in (1, 3, 8):
        with pytest.raises(ValueError, match="halves"):
            pp.interleaved_gp_predict(*port, halves=halves)
    with pytest.raises(RuntimeError, match="on the card"):
        pp.run(port)
    # A CUDA launch validates before it builds anything: CPU tensors raise.
    with pytest.raises(ValueError, match="CUDA tensors"):
        pp.pipelined_gp_predict_cuda(*port)
    assert pp.pipelined_gp_predict_cuda.launches == 0
