"""The CUDA GP-predict kernels on the card (marked ``cuda``): the
stationary kernel, and the general and stacked covariance-program kernels.

These cases need an NVIDIA GPU and skip without one. They import no JAX,
so they also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py

(``--noconftest``: the repository's conftests set up JAX.)
"""

import pytest
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.ops import gp_kernel

KINDS = ("rbf", "matern12", "matern32", "matern52")


@pytest.fixture
def on_cuda():
    """Skip without a GPU; otherwise run with ``config.device = cuda:0``."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA GP-predict kernel needs an NVIDIA GPU")
    old = st.config.device
    st.config.device = "cuda:0"
    yield torch.device("cuda:0")
    st.config.device = old


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain(on_cuda, kind, dtype):
    """Ragged Q and a partly filled mask at capacities 8, 128 and 2048;
    the bound is ``chip_smoke.rounding_bounds``."""
    from chip_smoke import case_gp, case_inputs, compare

    for cap in (8, 128, 2048):
        gp = case_gp(kind, cap, 2, 2.5, dtype, seed=cap)
        _, _, ratio = compare(case_inputs(gp, 1001, cap), kind)
        assert ratio <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d,p,count,cap", [(5, 4, 128, 128),
                                           (16, 8, 129, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_at_wide_inputs_and_outputs(on_cuda, d, p, count, cap,
                                           dtype):
    """Kernel 1 past the 4 dimensions it unrolls from registers: the
    cart-pole's d = 5, p = 4 at count 128 (tiled body) and the
    ``D_MAX``/``P_MAX`` edge d = 16, p = 8 at count 129 (streamed body),
    within ``chip_smoke.rounding_bounds``."""
    from chip_smoke import case_gp, case_inputs, compare

    gp = case_gp("rbf", cap, p, 2.5, dtype, seed=d, n=count, d=d)
    _, _, ratio = compare(case_inputs(gp, 4099, d), "rbf", count=gp.count)
    assert ratio <= 1.0


@pytest.mark.cuda
def test_cuda_predict_goes_through_the_kernel(on_cuda):
    from chip_smoke import case_gp

    gp = case_gp("rbf", 16, 1, 1.0, torch.float32, seed=0)
    before = gp_kernel.gp_predict_cuda.launches
    mean, err = gp(torch.zeros(5, 3, device=on_cuda))
    assert gp_kernel.gp_predict_cuda.launches == before + 1
    assert mean.is_cuda and err.is_cuda and mean.shape == (5, 1)
    ls = gp.kernel.lengthscales
    args = (gp.X_buf / ls, gp.chol_inv, gp.alpha, gp._mask(), 1.0)
    with pytest.raises(ValueError, match="float64"):
        gp_kernel.gp_predict_cuda(torch.zeros(5, 3, device=on_cuda,
                                              dtype=torch.float64), *args)
    with pytest.raises(ValueError, match="d <= "):
        gp_kernel.gp_predict_cuda(
            torch.zeros(5, 17, device=on_cuda),
            torch.zeros(16, 17, device=on_cuda), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship", "ard_rbf", "product", "sum3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_general_kernel_matches_plain(on_cuda, name, dtype):
    """Kernel 2: ragged Q and a partly filled mask at capacities 8, 128
    and 2048; the bound is ``chip_smoke.program_bounds``."""
    from chip_smoke import case_queries, compare_program, program_case

    for cap in (8, 128, 2048):
        inputs, programs = program_case("general", (name,), cap, 2, 2.5,
                                        dtype, seed=cap)
        points = case_queries(1001, inputs[0], cap)
        before = gp_kernel.gp_predict_general_cuda.launches
        _, _, ratio = compare_program("general", (points,) + inputs,
                                      programs)
        assert gp_kernel.gp_predict_general_cuda.launches == before + 1
        assert ratio <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stacked_kernel_matches_plain(on_cuda, n_out, dtype):
    """Kernel 3 with 1 to 3 outputs at capacities 8, 128 and 1024."""
    from chip_smoke import (STACKED_SETS, case_queries, compare_program,
                            program_case)

    for cap in (8, 128, 1024):
        inputs, programs = program_case("stacked", STACKED_SETS[n_out], cap,
                                        1, 1.0, dtype, seed=cap)
        points = case_queries(1001, inputs[0], cap)
        before = gp_kernel.gp_predict_stacked_cuda.launches
        _, _, ratio = compare_program("stacked", (points,) + inputs,
                                      programs)
        assert gp_kernel.gp_predict_stacked_cuda.launches == before + 1
        assert ratio <= 1.0


@pytest.mark.cuda
def test_composite_predicts_go_through_the_program_kernels(on_cuda):
    """A composite-kernel GP launches kernel 2 once per predict, a stack
    of two kernel 3 once; both agree with the float64 host copies; and
    the wrappers raise on what they do not take."""
    import numpy as np

    from chip_smoke import flagship_kernel

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (20, 3))
    y = np.column_stack([np.sin(x[:, 0]), np.cos(x[:, 1])])
    kernels = [flagship_kernel(np.array([0.3, 0.1, 0.5])),
               flagship_kernel(np.array([0.2, 0.4, 0.1]))]
    gp = st.GaussianProcess(kernels[0], x, y[:, :1], 1e-4, capacity=32)
    stacked = st.StackedGaussianProcess(kernels, x, y, 1e-4, capacity=32)
    q = torch.as_tensor(rng.uniform(-1, 1, (77, 3)), dtype=torch.float32,
                        device=on_cuda)
    general = gp_kernel.gp_predict_general_cuda.launches
    mean, err = gp(q)
    assert gp_kernel.gp_predict_general_cuda.launches == general + 1
    stacked_before = gp_kernel.gp_predict_stacked_cuda.launches
    mean_s, err_s = stacked(q)
    assert gp_kernel.gp_predict_stacked_cuda.launches == stacked_before + 1
    assert mean.is_cuda and mean_s.shape == (77, 2)
    host = q.double().cpu()
    for got, want in ((mean, st.oracle.lift64(gp)(host)[0]),
                      (mean_s, st.oracle.lift64(stacked)(host)[0])):
        # float32 at noise 1e-4 (|L^-1| near 1e2) keeps about 3 digits.
        assert torch.allclose(got.double().cpu(), want, atol=1e-2)
    programs, params = stacked._programs()
    params = gp_kernel.program_params(params, q)
    args = (stacked.X_buf, params, stacked.chol_inv,
            stacked.alpha[:, :, 0].contiguous(), stacked._mask(), 1.0)
    with pytest.raises(ValueError, match="parameters"):
        gp_kernel.gp_predict_stacked_cuda(q, args[0], params[:-1],
                                          *args[2:], programs)
    with pytest.raises(ValueError, match="d="):
        gp_kernel.gp_predict_stacked_cuda(q[:, :2].contiguous(),
                                          args[0][:, :2].contiguous(),
                                          *args[1:], programs)


@pytest.mark.cuda
@pytest.mark.parametrize("count", [0, 1, 10])
def test_stacked_kernel_at_the_safe_learning_shapes(on_cuda, count):
    """Kernel 3 as the safe-learning loop feeds it: the example's stacked
    GP at capacity 64 with 0, 1 or 10 measurements (0: an all-zero mask,
    identity ``chol_inv`` and zero ``alpha``, so the numerators vanish),
    at the 3,000 candidate rows of one exploration step."""
    import numpy as np

    from chip_smoke import compare_program, flagship_kernel

    rng = np.random.default_rng(count)
    x = rng.uniform(-1, 1, (count, 3))
    y = 0.1 * np.column_stack([np.sin(x.sum(1)), np.cos(x[:, 0])])
    gp = st.StackedGaussianProcess(
        [flagship_kernel(np.array([0.3, 0.1, 0.5])),
         flagship_kernel(np.array([0.2, 0.4, 0.1]))], x, y, 1e-6,
        capacity=64)
    programs, params = gp._programs()
    q = torch.as_tensor(rng.uniform(-1, 1, (3000, 3)), dtype=torch.float32,
                        device=on_cuda)
    inputs = (q, gp.X_buf, gp_kernel.program_params(params, q),
              gp.chol_inv, gp.alpha[:, :, 0].contiguous(), gp._mask(), 1.0)
    before = gp_kernel.gp_predict_stacked_cuda.launches
    _, _, ratio = compare_program("stacked", inputs, programs)
    assert gp_kernel.gp_predict_stacked_cuda.launches == before + 1
    assert ratio <= 1.0
    if count == 0:
        mean_num, var_num = gp_kernel.gp_predict_stacked_cuda(*inputs,
                                                              programs)
        assert not mean_num.any() and not var_num.any()


@pytest.mark.cuda
@pytest.mark.parametrize("count", [0, 10, 50])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stacked_gradient_at_the_training_shapes(on_cuda, count, dtype):
    """Kernel 3's autograd rule as the policy ascent takes it: the
    example's stacked GP at capacity 64 with 0, 10 or 50 measurements, a
    minibatch of 1000 state-action rows, one launch per predict.

    float64: the GP's means, errors and the gradient of their sum with
    respect to the rows through the kernel, against the plain route
    (``config.use_kernels = False``), within 1e-9 relative (of the
    largest entry). float32 rounding on this GP (50 random points, noise
    1e-6) moves the plain route's gradient by up to a third from
    float64's, so the float32 case holds the rule itself on the GP's
    inputs: the kernel's numerators against its plain twin within
    ``program_bounds``, and the gradient of their sum through the rule
    (``fused_gp_predict_stacked``) against the twin's own, within 1e-6
    relative."""
    import numpy as np

    from chip_smoke import compare_program, flagship_kernel

    rng = np.random.default_rng(count)
    x = rng.uniform(-1, 1, (count, 3))
    y = 0.1 * np.column_stack([np.sin(x.sum(1)), np.cos(x[:, 0])])
    old = st.config.dtype
    st.config.dtype = dtype
    try:
        gp = st.StackedGaussianProcess(
            [flagship_kernel(np.array([0.3, 0.1, 0.5])),
             flagship_kernel(np.array([0.2, 0.4, 0.1]))], x, y, 1e-6,
            mean_functions=[st.LinearSystem([[1.0, 0.1, 0.0]]),
                            st.LinearSystem([[0.2, 0.9, 0.3]])],
            capacity=64)
    finally:
        st.config.dtype = old
    rows = torch.as_tensor(rng.uniform(-1, 1, (1000, 3)), dtype=dtype,
                           device=on_cuda)
    programs, params = gp._programs()
    inputs = (gp.X_buf, gp_kernel.program_params(params, rows), gp.chol_inv,
              gp.alpha[:, :, 0].contiguous(), gp._mask(),
              torch.tensor(gp.scale ** 2, dtype=dtype, device=on_cuda))

    def route(predict):
        """``(kernel launches, outputs and the gradient of their sum)`` of
        ``predict`` at the rows."""
        q = rows.clone().requires_grad_(True)
        before = gp_kernel.gp_predict_stacked_cuda.launches
        outputs = predict(q)
        launched = gp_kernel.gp_predict_stacked_cuda.launches - before
        (grad,) = torch.autograd.grad(sum(t.sum() for t in outputs), q)
        return launched, [t.detach() for t in outputs] + [grad]

    def public(use_kernels):
        st.config.use_kernels = use_kernels
        try:
            return route(gp)
        finally:
            st.config.use_kernels = True

    if dtype == torch.float64:
        (launched, got), (plain, want) = public(True), public(False)
        rtol = 1e-9
    else:
        assert compare_program("stacked", (rows,) + inputs, programs,
                               count=gp.count)[2] <= 1.0
        launched, got = route(lambda q: gp_kernel.fused_gp_predict_stacked(
            q, *inputs, programs, count=gp.count))
        plain, want = route(lambda q: gp_kernel.gp_predict_stacked_plain(
            q, *inputs, programs))
        got, want, rtol = got[-1:], want[-1:], 1e-6
    assert (launched, plain) == (1, 0)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= rtol * scale


@pytest.mark.cuda
def test_safe_sample_with_kernel_matches_plain_twin(on_cuda):
    """Three rounds of the safe-learning loop on a small instance: each
    pair chosen through kernel 3 equals the pair its plain twin chooses
    from the same RNG state (or their bounds agree within the computed
    bound), re-scores safe in float64, and the GP grows by one row
    (``chip_smoke.explore_step`` checks all of it)."""
    import numpy as np

    from chip_smoke import (bound_tolerance, build_safe_learning_instance,
                            explore_step)

    lyap, inst = build_safe_learning_instance(0, (101, 76), (11, 11),
                                              (2, 8, 8, 1))
    lyap.update_safe_set()
    rng = np.random.default_rng(0)
    for step in range(3):
        xu, _ = explore_step(lyap, inst, rng, step)
    assert lyap.dynamics.count == 3
    assert lyap.dynamics.X_buf.is_cuda
    before = gp_kernel.gp_predict_stacked_cuda.launches
    assert 0.0 < bound_tolerance(lyap, xu) < 1e-3
    assert gp_kernel.gp_predict_stacked_cuda.launches == before


#: ``(count, capacity)``: an all-zero mask, a small count, both sides of a
#: bucket edge of the tiled body, and the streamed body above it.
COUNT_CASES = [(0, 64), (10, 64), (16, 32), (17, 32), (129, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("count,cap", COUNT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_at_counts_below_capacity(on_cuda, count, cap, dtype):
    """Kernel 1 with its loops bounded by the count, against the plain
    version at full capacity within ``chip_smoke.rounding_bounds``; exact
    zeros at count 0."""
    from chip_smoke import case_gp, case_inputs, compare

    gp = case_gp("matern32", cap, 2, 2.5, dtype, seed=count, n=count)
    before = gp_kernel.gp_predict_cuda.launches
    em, ev, ratio = compare(case_inputs(gp, 1001, count), "matern32",
                            count=gp.count)
    assert gp_kernel.gp_predict_cuda.launches == before + 1
    assert ratio <= 1.0
    if count == 0:
        assert em == ev == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("count,cap", COUNT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stacked_kernel_at_counts_below_capacity(on_cuda, count, cap,
                                                 dtype):
    """Kernel 3 on two flagship programs with its loops bounded by the
    count, against the plain twin within ``chip_smoke.program_bounds``;
    exact zeros at count 0; the stacked GP's predict passes its count."""
    from chip_smoke import (STACKED_SETS, case_queries, compare_program,
                            program_case)

    inputs, programs = program_case("stacked", STACKED_SETS[2], cap, 1, 1.0,
                                    dtype, seed=count, n=count)
    points = case_queries(1001, inputs[0], count)
    before = gp_kernel.gp_predict_stacked_cuda.launches
    em, ev, ratio = compare_program("stacked", (points,) + inputs, programs,
                                    count=count)
    assert gp_kernel.gp_predict_stacked_cuda.launches == before + 1
    assert ratio <= 1.0
    if count == 0:
        assert em == ev == 0.0


#: Counts on both sides of the tiled body's last bucket edge, the panel
#: body's counts (the adaptive example's 181 among them) and both sides of
#: 256 and of the panel body's largest count in float32 (512; 256 in
#: float64), above which the streamed body runs.
PANEL_COUNTS = [1, 128, 129, 136, 181, 192, 255, 256, 257, 512, 513]


def panel_capacity(count):
    """The adaptive example's capacity, 181, up to it; else the next of
    256, 512 and 1024."""
    from chip_smoke import ADAPTIVE_CAPACITY

    if count <= ADAPTIVE_CAPACITY:
        return ADAPTIVE_CAPACITY
    return next(c for c in (256, 512, 1024) if c >= count)


def body_of(programs, count, dtype, p=1, d=3):
    """The body a launch takes, and the one its count selects."""
    from chip_smoke import expected_body

    n_panel = gp_kernel.program_panel_max(programs, dtype)
    return (gp_kernel.program_body(programs, count, dtype, p, d),
            expected_body(count, n_panel))


@pytest.mark.cuda
@pytest.mark.parametrize("count", PANEL_COUNTS)
@pytest.mark.parametrize("n_out", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stacked_kernel_at_the_adaptive_capacity(on_cuda, count, n_out,
                                                 dtype):
    """Kernel 3 at the adaptive example's GP capacity, 181 (not a power
    of two; ``S cap^2`` float32 values exceed one SM's shared memory), and
    above it: counts on both sides of the tiled body's last bucket edge,
    through the panel body to the streamed body above its largest count,
    1 to 3 outputs, against the plain twin within
    ``chip_smoke.program_bounds``; each launch takes the body its count
    selects."""
    from chip_smoke import (STACKED_SETS, case_queries, compare_program,
                            program_case)

    inputs, programs = program_case("stacked", STACKED_SETS[n_out],
                                    panel_capacity(count), 1, 1.0, dtype,
                                    seed=count, n=count)
    points = case_queries(4099, inputs[0], count)
    before = gp_kernel.gp_predict_stacked_cuda.launches
    _, _, ratio = compare_program("stacked", (points,) + inputs, programs,
                                  count=count)
    assert gp_kernel.gp_predict_stacked_cuda.launches == before + 1
    assert ratio <= 1.0
    got, want = body_of(programs, count, dtype)
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("count", PANEL_COUNTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_general_kernel_above_128_rows(on_cuda, count, dtype):
    """Kernel 2 (the ``product`` program, whose ``ActiveDims`` read 3 of
    the inputs' columns) at the panel body's counts, with p = 8 outputs
    and d = 16 input dimensions (``P_MAX``, ``D_MAX``) at odd counts and
    p = 2, d = 3 at even ones, against the plain twin within
    ``chip_smoke.program_bounds``; each launch takes the body its count
    selects."""
    from chip_smoke import case_queries, compare_program, program_case

    p, d = (8, 16) if count % 2 else (2, 3)
    inputs, programs = program_case("general", ("product",),
                                    panel_capacity(count), p, 2.5, dtype,
                                    seed=count, n=count, d=d)
    points = case_queries(1001, inputs[0], count)
    before = gp_kernel.gp_predict_general_cuda.launches
    _, _, ratio = compare_program("general", (points,) + inputs, programs,
                                  count=count)
    assert gp_kernel.gp_predict_general_cuda.launches == before + 1
    assert ratio <= 1.0
    got, want = body_of(programs, count, dtype, p, d)
    assert got == want


@pytest.mark.cuda
def test_adaptive_shapes_take_the_panel_body(on_cuda):
    """The body query: the adaptive example's stacked GP (S = 2, p = 1,
    d = 3) takes the tiled body up to count 128 and the panel body from
    129 to its capacity 181 in both dtypes; one past the panel body's
    largest count takes the streamed body, which its own entry also
    reaches at count 181 with the same results within the bound."""
    from chip_smoke import (ADAPTIVE_CAPACITY, STACKED_SETS, case_queries,
                            compare_program, program_case)

    inputs, programs = program_case("stacked", STACKED_SETS[2],
                                    ADAPTIVE_CAPACITY, 1, 1.0,
                                    torch.float32, seed=5,
                                    n=ADAPTIVE_CAPACITY)
    for dtype in (torch.float32, torch.float64):
        n_panel = gp_kernel.program_panel_max(programs, dtype)
        assert n_panel >= 256
        assert gp_kernel.program_body(programs, 128, dtype) == "tiled"
        for count in range(129, ADAPTIVE_CAPACITY + 1):
            assert gp_kernel.program_body(programs, count, dtype) == "panel"
        assert gp_kernel.program_body(programs, n_panel, dtype) == "panel"
        assert gp_kernel.program_body(programs, n_panel + 1,
                                      dtype) == "streamed"
    points = case_queries(2000, inputs[0], 5)
    before = gp_kernel.gp_predict_stacked_streamed_cuda.launches
    _, _, ratio = compare_program("streamed", (points,) + inputs, programs,
                                  count=ADAPTIVE_CAPACITY)
    assert gp_kernel.gp_predict_stacked_streamed_cuda.launches == before + 1
    assert ratio <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("count", [129, 181])
def test_stacked_gradient_at_the_adaptive_capacity(on_cuda, count):
    """Kernel 3's autograd rule on the panel body: the adaptive example's
    stacked GP structure (two flagship programs, linear prior means) at
    capacity 181 with ``count`` points, float64, 2,000 rows, one launch a
    predict; the GP's means, errors and the gradient of their sum with
    respect to the rows against the plain route (``config.use_kernels =
    False``) within 1e-9 relative (of the largest entry)."""
    import numpy as np

    from chip_smoke import ADAPTIVE_CAPACITY, flagship_kernel

    rng = np.random.default_rng(count)
    x = rng.uniform(-1, 1, (count, 3))
    y = 0.1 * np.column_stack([np.sin(x.sum(1)), np.cos(x[:, 0])])
    old = st.config.dtype
    st.config.dtype = torch.float64
    try:
        gp = st.StackedGaussianProcess(
            [flagship_kernel(np.array([0.3, 0.1, 0.5])),
             flagship_kernel(np.array([0.2, 0.4, 0.1]))], x, y, 1e-4,
            mean_functions=[st.LinearSystem([[1.0, 0.1, 0.0]]),
                            st.LinearSystem([[0.2, 0.9, 0.3]])],
            capacity=ADAPTIVE_CAPACITY)
    finally:
        st.config.dtype = old
    rows = torch.as_tensor(rng.uniform(-1, 1, (2000, 3)),
                           dtype=torch.float64, device=on_cuda)
    programs, _ = gp._programs()
    assert gp_kernel.program_body(programs, gp.count,
                                  torch.float64) == "panel"

    def route(use_kernels):
        st.config.use_kernels = use_kernels
        try:
            q = rows.clone().requires_grad_(True)
            before = gp_kernel.gp_predict_stacked_cuda.launches
            outputs = gp(q)
            launched = gp_kernel.gp_predict_stacked_cuda.launches - before
            (grad,) = torch.autograd.grad(sum(t.sum() for t in outputs), q)
        finally:
            st.config.use_kernels = True
        return launched, [t.detach() for t in outputs] + [grad]

    (launched, got), (plain, want) = route(True), route(False)
    assert (launched, plain) == (1, 0)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 1e-9 * float(w.abs().max())


@pytest.mark.cuda
def test_sample_batch_on_the_card_matches_the_cpu_plain_route(on_cuda):
    """``get_safe_sample_batch`` at a small size of the adaptive example
    (41x41 grid, capacity 64, k = 6) on the card through kernel 3, and on
    the CPU through the plain twin, both in float64: the same pairs, the
    measurements and bounds to 1e-9, one kernel launch a step."""
    import numpy as np

    from chip_smoke import build_adaptive_instance

    def batch(device):
        old = st.config.device, st.config.dtype
        st.config.device, st.config.dtype = device, torch.float64
        try:
            lyap, inst = build_adaptive_instance(41, 64)
            lyap.update_safe_set(can_shrink=False, max_refinement=4)
            before = gp_kernel.gp_predict_stacked_cuda.launches
            out = st.get_safe_sample_batch(
                lyap, inst["measure"], 6, np.array([[0.0]]),
                np.array([[-1.0, 1.0]]), positive=True, num_samples=1000,
                rng=np.random.default_rng(0))
            return out, gp_kernel.gp_predict_stacked_cuda.launches - before
        finally:
            st.config.device, st.config.dtype = old

    (sas, ys, bounds, safes), launched = batch("cuda:0")
    (want_sas, want_ys, want_bounds, want_safes), plain = batch("cpu")
    assert (launched, plain) == (6, 0)
    assert np.array_equal(sas, want_sas)
    assert np.array_equal(safes, want_safes) and safes.all()
    assert np.allclose(ys, want_ys, rtol=0, atol=1e-9)
    assert np.allclose(bounds, want_bounds, rtol=0, atol=1e-9)


VARIANT_NAMES = ("pipelined", "interleaved2", "interleaved4", "folded",
                 "expanded")


@pytest.mark.cuda
@pytest.mark.parametrize("name", VARIANT_NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_variant_matches_plain(on_cuda, name, dtype):
    """Each of kernel 1's variants against its plain version at the
    cart-pole's d = 5, p = 4 (count 96 of capacity 128, the tiled body)
    and at capacity 256 (the streamed body), within
    ``chip_smoke.rounding_bounds``, ``folded_bounds`` or
    ``expanded_bounds``."""
    from chip_smoke import case_gp, case_inputs, check_variants

    for cap, d, p, n_q in ((128, 5, 4, 20011), (256, 3, 2, 4099)):
        gp = case_gp("matern32", cap, p, 2.5, dtype, seed=cap, d=d)
        errors = check_variants(case_inputs(gp, n_q, cap), "matern32",
                                gp.count)
        assert errors[name][2] <= 1.0


@pytest.mark.cuda
def test_kernel_variants_launch_their_kernels(on_cuda):
    """A variant on CUDA tensors launches its kernel (its counter moves),
    never the plain route, raises on inputs that require a gradient, and
    the GP's own predict launches none of them."""
    from chip_smoke import case_gp, case_inputs
    from safe_learning_tpu_torch.benchmarks import (
        distance_mxu_experiment as dm, pipelined_predict as pp)

    gp = case_gp("rbf", 128, 2, 1.0, torch.float32, seed=1)
    inputs = case_inputs(gp, 1001, 1)
    wrappers = ((pp.pipelined_gp_predict, pp.pipelined_gp_predict_cuda, {}),
                (pp.interleaved_gp_predict, pp.interleaved_gp_predict_cuda,
                 {"halves": 4}),
                (pp.folded_gp_predict, pp.folded_gp_predict_cuda, {}),
                (dm.fused_predict_mxu_dist, dm.fused_predict_mxu_dist_cuda,
                 {}))
    plain_before = gp_kernel.gp_predict_cuda.launches
    for fn, cuda_fn, kw in wrappers:
        before = cuda_fn.launches
        mean, var = fn(*inputs, kind="rbf", count=gp.count, **kw)
        assert cuda_fn.launches == before + 1
        assert mean.is_cuda and mean.shape == (1001, 2) and var.is_cuda
        q = inputs[0].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward only"):
            fn(q, *inputs[1:], kind="rbf", **kw)
    counts = [cuda_fn.launches for _, cuda_fn, _ in wrappers]
    gp(torch.zeros(5, 3, device=on_cuda))
    assert gp_kernel.gp_predict_cuda.launches == plain_before + 1
    assert [cuda_fn.launches for _, cuda_fn, _ in wrappers] == counts
