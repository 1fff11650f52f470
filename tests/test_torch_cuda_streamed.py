"""The streamed sweep on the card (marked ``cuda``; skipped without a GPU).

``bench.py``'s instance at 1024x1024 = 2^20 points with the fused limit
lowered to 2^16, so ``update_safe_set`` streams 16 batches of states made
on the card: kernel 1 launches once a batch, and the safe set and
``c_max`` equal the JAX package's sorted-prefix rule over the sweep's own
values and verdicts, exactly. The states of flat indices above 2^24 made
on the card are the host grid's, bit for bit. No JAX is imported:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_streamed.py
"""

import numpy as np
import pytest
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.ops import gp_kernel


@pytest.fixture
def on_cuda():
    """Skip without a GPU; otherwise run with ``config.device = cuda:0``."""
    if not torch.cuda.is_available():
        pytest.skip("the streamed sweep's kernel needs an NVIDIA GPU")
    old = st.config.device
    st.config.device = "cuda:0"
    yield torch.device("cuda:0")
    st.config.device = old


@pytest.fixture
def streamed_limits():
    old = st.config.fused_sweep_limit, st.config.gp_batch_size
    st.config.fused_sweep_limit = st.config.gp_batch_size = 2 ** 16
    yield 2 ** 16
    st.config.fused_sweep_limit, st.config.gp_batch_size = old


@pytest.mark.cuda
@pytest.mark.parametrize("calibrated", [False, True])
def test_streamed_sweep_is_the_sorted_prefix(on_cuda, streamed_limits,
                                             calibrated):
    from chip_smoke import (build_bench_instance, check_streamed,
                            uncounted)

    inst = build_bench_instance(1024)
    lyap = st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                       inst["lv"], inst["tau"], inst["policy"],
                       initial_set=inst["initial_set"])
    if calibrated:
        st.oracle.calibrate_certificate_margin(lyap, num_samples=4096)
        assert lyap.level_margin > 0.0
    before = gp_kernel.gp_predict_cuda.launches
    lyap.update_safe_set()
    assert gp_kernel.gp_predict_cuda.launches == before + 16
    assert lyap.last_sweep_counts["coarse_batches"] == 16
    assert lyap.values.is_cuda
    assert 0.05 < lyap.safe_set.mean() < 0.95
    with uncounted():
        check_streamed(lyap, streamed_limits, "2^20 streamed sweep")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_states_in_range_exact_past_2_to_the_24(on_cuda, dtype):
    old = st.config.dtype
    st.config.dtype = dtype
    try:
        grid = st.GridWorld([[-1.0, 1.0], [-2.0, 3.0]], [5003, 4001])
        start = 2 ** 24 + 3
        states = grid.states_in_range(start, start + 100_000)
        assert states.is_cuda and states.dtype == dtype
        flat = np.arange(start, start + 100_000)
        assert np.array_equal(states.cpu().numpy(), grid.points_at(flat))
        last = grid.states_in_range(grid.nindex - 5, grid.nindex)
        assert np.array_equal(last.cpu().numpy(),
                              grid.points_at(np.arange(grid.nindex - 5,
                                                       grid.nindex)))
    finally:
        st.config.dtype = old
