"""The rigor mode's float64 GP predicts on the card (marked ``cuda``;
skipped without a GPU).

Kernels 1-3 run their float64 panel body up to the count the built
library reports (``gp_kernel.program_panel_max``) and the strip body
above it, at any count a GP routes to a kernel, as the JAX package does:
the extended sweep refuses no count. No JAX is imported:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_extended.py
"""

import numpy as np
import pytest
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.ops import extended_verify as ev
from safe_learning_tpu_torch.ops import gp_kernel


@pytest.fixture
def on_cuda():
    """Skip without a GPU; otherwise run with ``config.device = cuda:0``
    in float32."""
    if not torch.cuda.is_available():
        pytest.skip("the float64 kernels' bodies are read from the built "
                    "CUDA library, which needs an NVIDIA GPU")
    old = st.config.device, st.config.dtype
    st.config.device, st.config.dtype = "cuda:0", torch.float32
    yield
    st.config.device, st.config.dtype = old


def stacked_instance(n):
    """A stacked Matern-3/2 GP holding ``n`` data points on a 5x5 grid,
    ``L_v = 2 |x|`` elementwise, with its matrix ``2 I``."""
    rng = np.random.default_rng(0)
    x = np.column_stack([rng.uniform(-1, 1, (n, 2)), np.zeros(n)])
    y = 0.5 * x[:, :2]
    gp = st.StackedGaussianProcess(
        [st.Matern32(0.5, [0.4] * 3, input_dim=3)] * 2, x, y, [1e-3] * 2)
    grid = st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 5)
    lv = st.LambdaFunction(lambda points: 2.0 * torch.abs(points))
    return st.Lyapunov(grid, st.QuadraticFunction(np.eye(2)), gp, 0.5, lv,
                       0.1, st.LinearSystem(np.zeros((1, 2))),
                       initial_set=[12])


@pytest.mark.cuda
def test_float64_sweep_runs_above_the_panel(on_cuda):
    """One data point past the float64 panel body's largest count (257)
    and at the adaptive loop's 1,021 the extended sweep runs on kernel 3's
    strip body, launches it, and its float64 margins lie within the
    derived extended margin of the float64 oracle's at every grid
    state; no count is refused."""
    from safe_learning_tpu_torch.oracle import oracle_margins

    lyap = stacked_instance(8)
    programs = lyap.dynamics._programs()[0]
    limit = gp_kernel.program_panel_max(programs, torch.float64)
    assert limit == 256
    for count in (limit + 1, 1021):
        lyap = stacked_instance(count)
        assert gp_kernel.program_body(programs, count,
                                      torch.float64) == "strip"
        margin = ev.extended_certificate_margin(
            lyap, lv_matrix=2.0 * np.eye(2), set_margin=False)
        sweep = ev.ExtendedSweep(lyap, lv_matrix=2.0 * np.eye(2))
        pts = lyap.discretization.all_points
        before = gp_kernel.gp_predict_stacked_cuda.launches
        got = sweep.margins(pts)
        assert gp_kernel.gp_predict_stacked_cuda.launches > before
        assert np.isfinite(got).all()
        assert (np.abs(got - oracle_margins(lyap, pts)) <= margin).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,count", [(1, 10), (1, 128), (1, 200),
                                          (1, 600), (2, 136), (2, 600),
                                          (3, 17), (3, 181), (3, 250),
                                          (3, 300), (3, 1021)])
def test_float64_outputs_do_not_depend_on_position(on_cuda, kernel, count):
    """The hybrid sweep checks only the band's states in float64 and must
    equal the extended sweep over all of them, bit for bit, as must the
    sharded sweeps: each query's float64 outputs are the same wherever it
    lies in a launch, shifted by 1 to the query tile - 1, reversed and
    alone (``chip_smoke.position_check``), through the DMMA tiled body
    (counts 10 to 128), chol_inv resident (136, 181), streamed through
    the panel body (200, 250) and the strip body (300 to 1,021)."""
    from chip_smoke import (STACKED_SETS, case_gp, case_inputs,
                            case_queries, dmma_query_tile, position_check,
                            program_case)

    if kernel == 1:
        gp = case_gp("matern32", max(128, count), 2, 2.5, torch.float64,
                     seed=count, n=count)
        inputs = case_inputs(gp, 1000, count)

        def fn(q):
            return gp_kernel.gp_predict_cuda(q, *inputs[1:], kind="matern32",
                                             count=count)
        queries = inputs[0]
    else:
        route = "general" if kernel == 2 else "stacked"
        names = ("product",) if kernel == 2 else STACKED_SETS[
            1 if count < 100 else 2]
        inputs, programs = program_case(route, names, max(181, count), 2,
                                        2.5, torch.float64, seed=count,
                                        n=count)
        cuda = (gp_kernel.gp_predict_general_cuda if kernel == 2
                else gp_kernel.gp_predict_stacked_cuda)
        arg = programs[0] if kernel == 2 else programs

        def fn(q):
            return cuda(q, *inputs, arg, count=count)
        queries = case_queries(1000, inputs[0], count)
    assert position_check(fn, queries, dmma_query_tile(count)) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,count", [(1, 2048), (2, 1025), (3, 1021)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_strip_outputs_do_not_depend_on_position_or_launch_size(
        on_cuda, kernel, count, dtype):
    """The strip body, in both dtypes: each query's outputs are the same,
    bit for bit, wherever it lies in a launch (``chip_smoke.
    position_check``: shifted by 1 to 63, reversed, alone) and whatever
    the launch's size (``chip_smoke.launch_size_check``: alone, in a
    launch of 2,000 and in one of 2^20): the order of every sum is fixed
    by the count."""
    from chip_smoke import (STACKED_SETS, case_gp, case_inputs,
                            case_queries, launch_size_check, position_check,
                            program_case)

    cap = 1024 if count <= 1024 else 2048
    if kernel == 1:
        gp = case_gp("matern32", cap, 2, 2.5, dtype, seed=count, n=count)
        inputs = case_inputs(gp, 2 ** 20, count)

        def fn(q):
            return gp_kernel.gp_predict_cuda(q, *inputs[1:], kind="matern32",
                                             count=count)
        queries = inputs[0]
    else:
        route = "general" if kernel == 2 else "stacked"
        names = ("product",) if kernel == 2 else STACKED_SETS[2]
        inputs, programs = program_case(route, names, cap, 2, 2.5, dtype,
                                        seed=count, n=count)
        cuda = (gp_kernel.gp_predict_general_cuda if kernel == 2
                else gp_kernel.gp_predict_stacked_cuda)
        arg = programs[0] if kernel == 2 else programs

        def fn(q):
            return cuda(q, *inputs, arg, count=count)
        queries = case_queries(2 ** 20, inputs[0], count)
    assert position_check(fn, queries[:1000].contiguous(), 64) > 1
    assert launch_size_check(fn, queries) > 2


def grown_instance(n, capacity):
    """``stacked_instance``'s models on ``n`` data points at ``capacity``
    in ``config.dtype``, refining where the coarse check fails."""
    rng = np.random.default_rng(0)
    x = np.column_stack([rng.uniform(-1, 1, (n, 2)), np.zeros(n)])
    gp = st.StackedGaussianProcess(
        [st.Matern32(0.5, [0.4] * 3, input_dim=3)] * 2, x, 0.5 * x[:, :2],
        [1e-3] * 2, capacity=capacity)
    grid = st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 5)
    lv = st.LambdaFunction(lambda points: 2.0 * torch.abs(points))
    return st.Lyapunov(grid, st.QuadraticFunction(np.eye(2)), gp, 0.5, lv,
                       0.1, st.LinearSystem(np.zeros((1, 2))),
                       initial_set=[12], adaptive=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_strip_body_launches_once_a_pass_chunk_and_step(on_cuda, dtype):
    """At count 1,021 (the adaptive loop grown, the strip body) kernel 3
    launches once per coarse pass and refinement chunk of an adaptive
    certify and once per sampler step of ``get_safe_sample_batch``, as
    its launch counter shows."""
    st.config.dtype = dtype
    lyap = grown_instance(1021, 1024)
    programs = lyap.dynamics._programs()[0]
    assert gp_kernel.program_body(programs, 1021, dtype) == "strip"
    cuda = gp_kernel.gp_predict_stacked_cuda
    before = cuda.launches
    lyap.update_safe_set(can_shrink=False, max_refinement=4)
    counts = lyap.last_sweep_counts
    assert counts["coarse_batches"] >= 1
    assert cuda.launches - before == (counts["coarse_batches"]
                                      + counts["refinement_chunks"])
    before = cuda.launches
    st.get_safe_sample_batch(
        lyap, st.LambdaFunction(lambda sa: 0.5 * sa[:, :2]), 3,
        np.array([[0.0], [0.1]]), np.array([[-1.0, 1.0]]), num_samples=10,
        rng=np.random.default_rng(0))
    assert cuda.launches - before == 3
    assert lyap.dynamics.count == 1024


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [1, 3])
def test_float64_error_within_the_margin_model(on_cuda, kernel):
    """The float64 kernel's error against ``numpy.longdouble`` stays
    within the bound the float64 margins assume (``U_EFF`` a rounding,
    ``chip_smoke.longdouble_ratios``): kernel 1 at 128 rows (tiled body),
    kernel 3 at 181 (panel body)."""
    from chip_smoke import (STACKED_SETS, case_gp, case_inputs,
                            case_queries, longdouble_ratios, program_case)

    if kernel == 1:
        gp = case_gp("rbf", 128, 2, 2.5, torch.float64, seed=1, n=128)
        inputs = case_inputs(gp, 2000, 1)
        outs = gp_kernel.gp_predict_cuda(*inputs, kind="rbf", count=128)
        ratios = longdouble_ratios(outs, inputs, 128, kind="rbf")
    else:
        inputs, programs = program_case("stacked", STACKED_SETS[2], 181, 1,
                                        2.5, torch.float64, seed=2, n=181)
        inputs = (case_queries(2000, inputs[0], 2),) + inputs
        outs = gp_kernel.gp_predict_stacked_cuda(*inputs, programs,
                                                 count=181)
        ratios = longdouble_ratios(outs, inputs, 181, programs=programs)
    assert all(rm <= 1.0 and rv <= 1.0 for _, _, rm, rv in ratios)
