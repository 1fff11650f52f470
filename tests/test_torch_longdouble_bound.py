"""The float64 error model that ``chip_smoke.py`` holds the card's float64
kernels to, on the CPU.

``chip_smoke.longdouble_ratios`` measures a float64 predict's error
against ``numpy.longdouble`` over the bound the float64 margins assume
(every operation rounding by at most ``extended_verify.U_EFF``, carried
through the solve chain of ``errorbounds._gp_terms``). On the card it
holds the DMMA bodies of kernels 1-3; here the plain versions on the CPU,
rounded in float64, must fit the bound, and the same outputs rounded in
float32 must not, so the check can fail.
"""

import pytest
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.ops import gp_kernel


def _kernel1(kind, dtype):
    from chip_smoke import case_gp, case_inputs

    gp = case_gp(kind, 128, 2, 2.5, dtype, seed=1, n=100)
    inputs = case_inputs(gp, 1500, 2)
    return inputs, gp_kernel.gp_predict_plain(*inputs, kind=kind), 100


def _program(route, names, cap, count, dtype):
    from chip_smoke import case_queries, program_case

    inputs, programs = program_case(route, names, cap, 2, 2.5, dtype,
                                    seed=3, n=count)
    inputs = (case_queries(1500, inputs[0], 4),) + inputs
    plain = (gp_kernel.gp_predict_general_plain if route == "general"
             else gp_kernel.gp_predict_stacked_plain)
    outs = plain(*inputs, programs[0] if route == "general" else programs)
    return inputs, outs, programs


@pytest.fixture(autouse=True)
def _cpu():
    old = st.config.device
    st.config.device = "cpu"
    yield
    st.config.device = old


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_plain_float64_kernel1_fits_the_model(kind):
    from chip_smoke import longdouble_ratios

    inputs, outs, count = _kernel1(kind, torch.float64)
    ((_, _, rm, rv),) = longdouble_ratios(outs, inputs, count, kind=kind)
    assert 0.0 < rm <= 1.0 and 0.0 < rv <= 1.0


@pytest.mark.parametrize("route,names,cap,count", [
    ("stacked", ("flagship", "flagship"), 181, 181),
    ("general", ("sum3",), 64, 50)])
def test_plain_float64_programs_fit_the_model(route, names, cap, count):
    from chip_smoke import longdouble_ratios

    inputs, outs, programs = _program(route, names, cap, count,
                                      torch.float64)
    ratios = longdouble_ratios(outs, inputs, count, programs=programs)
    assert len(ratios) == len(names)
    assert all(0.0 < rm <= 1.0 and 0.0 < rv <= 1.0
               for _, _, rm, rv in ratios)


def test_float32_rounding_exceeds_the_model():
    """Outputs rounded in float32 are about 2^29 units of the float64 model
    off: the check refuses them."""
    from chip_smoke import longdouble_ratios

    inputs, outs, count = _kernel1("rbf", torch.float32)
    inputs = tuple(t.double() if torch.is_tensor(t) else t for t in inputs)
    ((_, _, rm, rv),) = longdouble_ratios(outs, inputs, count, kind="rbf")
    assert rm > 1e3 and rv > 1e3
