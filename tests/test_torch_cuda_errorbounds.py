"""The derived margins against the H100's kernels (marked ``cuda``; skipped
without a GPU).

On ``bench.py``'s instance at 201x201 in float32 on the card, the
per-point bound of ``errorbounds.analytic_certificate_margin`` (the
default unit, ``config.fp_error_factor``) dominates the error of the
sweep's decrease margin through kernel 1 against the float64 oracle at
every grid point, and ``get_safe_sample`` beside that per-point margin
takes the per-candidate path. No JAX is imported:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_errorbounds.py
"""

import numpy as np
import pytest
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import errorbounds
from safe_learning_tpu_torch import explore as explore_mod
from safe_learning_tpu_torch.ops import gp_kernel


@pytest.fixture
def bench_on_cuda():
    """``bench.py``'s instance at 201x201 on ``cuda:0`` in float32."""
    if not torch.cuda.is_available():
        pytest.skip("the derived margins are checked against kernel 1, "
                    "which needs an NVIDIA GPU")
    from chip_smoke import build_bench_instance

    old = st.config.device, st.config.dtype
    st.config.device, st.config.dtype = "cuda:0", torch.float32
    inst = build_bench_instance(201)
    yield st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                      inst["lv"], inst["tau"], inst["policy"],
                      initial_set=inst["initial_set"])
    st.config.device, st.config.dtype = old


@pytest.mark.cuda
def test_per_point_bound_dominates_kernel1_error(bench_on_cuda):
    from chip_smoke import float32_margins

    lyap = bench_on_cuda
    bound = errorbounds.analytic_certificate_margin(lyap, per_point=True,
                                                    set_margin=False)
    before = gp_kernel.gp_predict_cuda.launches
    m32 = float32_margins(lyap, lyap._device_points(), lyap.tau)
    assert gp_kernel.gp_predict_cuda.launches == before + 1
    m64 = st.oracle.oracle_margins(lyap, lyap.discretization.all_points)
    err = np.abs(m32 - m64)
    assert np.all(err <= bound), float(np.max(err / bound))


@pytest.mark.cuda
def test_get_safe_sample_takes_per_candidate_margins(bench_on_cuda,
                                                     monkeypatch):
    lyap = bench_on_cuda
    st.oracle.calibrate_certificate_margin(lyap)
    lyap.update_safe_set()
    lyap.certificate_margin = errorbounds.analytic_certificate_margin(
        lyap, per_point=True, set_margin=False)
    derived = []
    real = explore_mod._per_candidate_margin

    def spy(lyapunov, candidates):
        out = real(lyapunov, candidates)
        derived.append(out)
        return out
    monkeypatch.setattr(explore_mod, "_per_candidate_margin", spy)
    pair, _ = st.get_safe_sample(
        lyap, perturbations=np.linspace(-0.1, 0.1, 5)[:, None],
        limits=[[-1.0, 1.0]], num_samples=200, rng=np.random.default_rng(0))
    assert len(derived) == 1 and derived[0] is not None
    assert pair.shape == (1, 3) and np.all(np.isfinite(pair))
