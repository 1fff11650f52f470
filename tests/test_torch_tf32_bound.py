"""The bounds that ``chip_smoke.py`` holds kernels 6 and 7's float32
bodies to, on the CPU.

Kernel 7's float32 tiled body (``csrc/gp_predict_variants.cu``,
``gp_expanded``) takes the expanded form's cross term ``x.q`` and the
product ``L^-1 K`` on the tensor cores in three TF32 passes;
kernel 6's (``gp_folded``) takes the folded form's product that way, its
``r^2`` by per-dimension differences in IEEE float32.
``chip_smoke.expanded_bounds(..., tf32x3=True)`` and
``chip_smoke.folded_bounds(..., tf32x3=True)`` bound their differences
from the plain float32 versions. Here the passes are emulated in torch:
``cvt.rna.tf32`` as "add ``0x1000`` to the float32 bit pattern, clear the
low 13 bits", each product's terms summed in float64 and rounded to
float32 toward zero (truncation's ``2u``). At cancellation-heavy inputs
(queries on training rows, so ``r^2 = 0`` there) the emulated predict
must fit the bound against a float64 reference, and a one-pass TF32
emulation must exceed it, so the check can fail.
"""

import pytest
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.benchmarks.pipelined_predict import (
    fold_chol_inv, folded_gp_predict_plain)
from safe_learning_tpu_torch.functions.gp import STATIONARY_COVARIANCES
from safe_learning_tpu_torch.ops import gp_kernel


@pytest.fixture(autouse=True)
def _cpu():
    old = st.config.device
    st.config.device = "cpu"
    yield
    st.config.device = old


def tf32_rna(v):
    """``cvt.rna.tf32.f32``: float32 to TF32, to nearest, ties away."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncated(v64):
    """Float64 to float32, rounded toward zero."""
    f = v64.float()
    over = f.double().abs() > v64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def tensor_core_product(a, b, passes):
    """``a @ b`` of float32 matrices as the tensor cores take it in TF32:
    three passes (``small big + big small + big big`` of the TF32 halves)
    or one (``big big``), the terms summed in float64 and rounded toward
    zero."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    terms = [(a_big, b_big)]
    if passes == 3:
        terms = [(tf32_rna(a - a_big), b_big),
                 (a_big, tf32_rna(b - b_big))] + terms
    return truncated(sum(x.double() @ y.double() for x, y in terms))


def emulated_predict(inputs, kind, passes):
    """Kernel 7's float32 body, emulated: the cross term and ``L^-1 K`` on
    the tensor cores (``tensor_core_product``), the rest in float32."""
    q, x, li, alpha, mask, var_s2 = inputs
    xx = (x * x).sum(1)
    qq = (q * q).sum(1)
    cross = tensor_core_product(x, q.T, passes)
    r2 = torch.clamp(xx[:, None] - 2.0 * cross + qq[None, :], min=0.0)
    k = STATIONARY_COVARIANCES[kind](r2) * var_s2 * mask[:, None]
    a = tensor_core_product(li, k, passes)
    return a.T @ alpha, (a * a).sum(0)


def adversarial_inputs(kind, count, d):
    """A float32 GP at capacity 128 holding ``count`` points in ``d``
    dimensions; its first ``count`` queries are its own (scaled) training
    rows, the rest random."""
    from chip_smoke import case_gp, case_inputs

    gp = case_gp(kind, 128, 2, 2.5, torch.float32, seed=count + d, n=count,
                 d=d)
    q, x, *rest = case_inputs(gp, 700, count)
    q = torch.cat([x[:count], q])
    return (q, x, *rest)


def ratio(inputs, kind, passes):
    """The emulated predict's largest error against the float64 function,
    over ``expanded_bounds(..., tf32x3=True)``."""
    from chip_smoke import expanded_bounds

    outs = emulated_predict(inputs, kind, passes)
    ref = gp_kernel.gp_predict_plain(*(t.double() for t in inputs),
                                     kind=kind)
    tols = expanded_bounds(inputs, kind, tf32x3=True)
    tiny = torch.finfo(torch.float64).tiny
    return max(float(((o.double() - r).abs() / t.clamp(min=tiny)).max())
               for o, r, t in zip(outs, ref, tols))


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
@pytest.mark.parametrize("count", [10, 128])
@pytest.mark.parametrize("d", [3, 5])
def test_three_pass_emulation_fits_the_bound(kind, count, d):
    got = ratio(adversarial_inputs(kind, count, d), kind, passes=3)
    assert 0.0 < got <= 1.0


@pytest.mark.parametrize("count", [10, 128])
@pytest.mark.parametrize("d", [3, 5])
def test_one_pass_emulation_exceeds_the_bound(count, d):
    assert ratio(adversarial_inputs("rbf", count, d), "rbf", passes=1) > 1.0


def emulated_folded(inputs, kind, passes):
    """Kernel 6's float32 body, emulated: ``r^2`` by per-dimension
    differences and the bare covariance in float32, ``L^-1 K`` (the folded
    ``chol_inv``) on the tensor cores (``tensor_core_product``), the
    reductions in float32."""
    q, x, li, alpha = inputs
    r2 = None
    for i in range(q.shape[1]):
        diff = x[:, i][:, None] - q[:, i][None, :]
        r2 = diff * diff if r2 is None else r2 + diff * diff
    a = tensor_core_product(li, STATIONARY_COVARIANCES[kind](r2), passes)
    return a.T @ alpha, (a * a).sum(0)


def folded_ratio(inputs, kind, passes):
    """The emulated folded predict's largest error against the float64
    function of the same (folded, float32) inputs, over
    ``folded_bounds(..., tf32x3=True)``."""
    from chip_smoke import folded_bounds

    q, x, li, alpha, mask, var_s2 = inputs
    folded = (q, x, fold_chol_inv(li, mask, var_s2), alpha)
    outs = emulated_folded(folded, kind, passes)
    ref = folded_gp_predict_plain(*(t.double() for t in folded), kind=kind)
    tols = folded_bounds(folded, kind, tf32x3=True)
    tiny = torch.finfo(torch.float64).tiny
    return max(float(((o.double() - r).abs() / t.clamp(min=tiny)).max())
               for o, r, t in zip(outs, ref, tols))


@pytest.mark.parametrize("kind", gp_kernel.KINDS)
@pytest.mark.parametrize("count", [10, 128])
@pytest.mark.parametrize("d", [3, 5])
def test_three_pass_folded_emulation_fits_the_bound(kind, count, d):
    got = folded_ratio(adversarial_inputs(kind, count, d), kind, passes=3)
    assert 0.0 < got <= 1.0


@pytest.mark.parametrize("kind", gp_kernel.KINDS)
@pytest.mark.parametrize("count", [10, 128])
@pytest.mark.parametrize("d", [3, 5])
def test_one_pass_folded_emulation_exceeds_the_bound(kind, count, d):
    got = folded_ratio(adversarial_inputs(kind, count, d), kind, passes=1)
    assert got > 1.0


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulated ``cvt.rna``: 10 mantissa bits kept, half an ulp of
    TF32 (``2^-11``) rounds away from zero in either sign."""
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10
    for sign in (1.0, -1.0):
        v = sign * torch.tensor([1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23,
                                 1.0 + ulp])
        assert tf32_rna(v).tolist() == (sign * torch.tensor(
            [1.0 + ulp, 1.0, 1.0 + ulp])).tolist()
    assert tf32_rna(one).tolist() == [1.0]
