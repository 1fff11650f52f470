"""The CUDA GP-predict kernel on the card (marked ``cuda``).

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
