"""The kernels' count contract, on the CPU.

The CUDA kernels bound their loops by the GP's count instead of its
capacity. That skips only exact zeros when ``mask[count:] == 0`` and
``chol_inv[count:, :count] == 0``, which the host factorization and the
bordered append produce. These tests hold that precondition on GPs the
port builds, hold the plain twins on inputs cut to the count against the
full-capacity twins, check that both GP routes pass their count to the
fused entry points, and check that the port's default device is the GPU.
"""

import numpy as np
import pytest
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.config import Configuration
from safe_learning_tpu_torch.ops import gp_kernel

from _torch_parity import working_dtype

#: Counts 0, 1, 10 and ``cap - cap / 4``, as ``(kind, capacity, count)``.
CASES = [(kind, cap, count)
         for kind, cap in (("stationary", 128), ("stacked", 64))
         for count in (0, 1, 10, cap - cap // 4)]

#: The plain twins on cut inputs against the full-capacity twins, float64:
#: both are the same sums less exact zeros, so only the matmul's blocking
#: may reorder them.
TOL = 1e-12


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3))
    y = np.column_stack([np.sin(x.sum(axis=1)), np.cos(x[:, 0])])
    return x, y


def _build(kind, x, y, cap):
    if kind == "stationary":
        return st.GaussianProcess(st.RBF(1.3, [0.7, 1.4, 0.9], input_dim=3),
                                  x, y[:, :1], noise_variance=1e-3,
                                  capacity=cap)
    from chip_smoke import flagship_kernel

    return st.StackedGaussianProcess(
        [flagship_kernel(np.array([0.3, 0.1, 0.5])),
         flagship_kernel(np.array([0.2, 0.4, 0.1]))], x, y,
        noise_variances=1e-3, capacity=cap)


def _grown(kind, cap, count, appended=3):
    """A GP at ``count`` points, the last ``appended`` of them added by
    bordered appends."""
    x, y = _data(count, seed=count)
    start = max(count - appended, 0)
    gp = _build(kind, x[:start], y[:start], cap)
    for i in range(start, count):
        gp = gp.add_data_point(x[i:i + 1],
                               y[i:i + 1, :gp.output_dim])
    return gp


def _assert_contract(gp):
    n = gp.count
    li = gp.chol_inv if gp.chol_inv.dim() == 3 else gp.chol_inv[None]
    assert not gp._mask()[n:].any()
    assert bool((gp._mask()[:n] == 1).all())
    assert not li[:, n:, :n].any()
    # Lower-triangular: the kernels skip the upper part too.
    assert not torch.triu(li, diagonal=1).any()


@pytest.mark.parametrize("kind,cap,count", CASES)
def test_factors_vanish_past_the_count(kind, cap, count):
    """``mask[count:] == 0`` and ``chol_inv[count:, :count] == 0`` exactly,
    after bordered appends."""
    with working_dtype("float32"):
        gp = _grown(kind, cap, count)
    assert (gp.count, gp.capacity) == (count, cap)
    if count >= 3:
        hosts = getattr(gp, "_host_caches", None) or [gp._host_cache]
        assert not any(h.fresh for h in hosts)
    _assert_contract(gp)


@pytest.mark.parametrize("kind,cap", [("stationary", 128), ("stacked", 64)])
def test_factors_vanish_after_a_rebuild_past_capacity(kind, cap):
    with working_dtype("float32"):
        x, y = _data(cap + 1, seed=7)
        gp = _build(kind, x[:cap], y[:cap], cap)
        gp = gp.add_data_point(x[cap:], y[cap:, :gp.output_dim])
    assert (gp.count, gp.capacity) == (cap + 1, 2 * cap)
    _assert_contract(gp)


def _queries(n_q=37, seed=11):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-1.2, 1.2, (n_q, 3)))


@pytest.mark.parametrize("kind,cap,count", CASES)
def test_plain_twin_cut_to_the_count(kind, cap, count):
    """The plain twin on inputs cut to ``count`` rows equals the twin at
    full capacity to ``TOL`` in float64."""
    with working_dtype("float64"):
        gp = _grown(kind, cap, count)
        q = _queries()
        n = count
        if kind == "stationary":
            ls = gp.kernel.lengthscales
            args = ((q / ls), gp.X_buf / ls, gp.chol_inv, gp.alpha,
                    gp._mask(), gp.kernel.variance * gp.scale ** 2)
            full = gp_kernel.gp_predict_plain(*args, kind="rbf")
            cut = gp_kernel.gp_predict_plain(
                args[0], args[1][:n], args[2][:n, :n], args[3][:n],
                args[4][:n], args[5], kind="rbf", count=n)
        else:
            programs, params = gp._programs()
            params = gp_kernel.program_params(params, q)
            alpha_t = gp.alpha[:, :, 0]
            full = gp_kernel.gp_predict_stacked_plain(
                q, gp.X_buf, params, gp.chol_inv, alpha_t, gp._mask(), 1.0,
                programs)
            cut = gp_kernel.gp_predict_stacked_plain(
                q, gp.X_buf[:n], params, gp.chol_inv[:, :n, :n],
                alpha_t[:, :n], gp._mask()[:n], 1.0, programs, count=n)
    for got, want in zip(cut, full):
        assert got.shape == want.shape
        assert torch.allclose(got, want, rtol=TOL, atol=TOL)
    if count == 0:
        assert not any(t.any() for t in full)


@pytest.mark.parametrize("kernel", ["stationary", "composite", "stacked"])
def test_predicts_pass_the_count(monkeypatch, kernel):
    """Both GP routes hand their host count to the fused entry points."""
    seen = []
    names = {"stationary": "fused_gp_predict",
             "composite": "fused_gp_predict_general",
             "stacked": "fused_gp_predict_stacked"}
    real = getattr(gp_kernel, names[kernel])

    def spy(*args, **kwargs):
        seen.append(kwargs.get("count"))
        return real(*args, **kwargs)

    monkeypatch.setattr(gp_kernel, names[kernel], spy)
    with working_dtype("float32"):
        x, y = _data(10, seed=3)
        if kernel == "composite":
            from chip_smoke import flagship_kernel

            gp = st.GaussianProcess(flagship_kernel(np.array([0.3, 0.1,
                                                              0.5])),
                                    x, y[:, :1], 1e-3, capacity=64)
        else:
            gp = _build(kernel, x, y, 64)
        gp.predict(_queries().float())
        gp = gp.add_data_point(x[:1] + 0.05, y[:1, :gp.output_dim])
        gp.predict(_queries().float())
    assert seen == [10, 11]


def test_default_device_is_the_gpu():
    """``Configuration()`` defaults to ``cuda:0``. A GP built there on a
    PyTorch without CUDA raises instead of running on the CPU; with a
    card it lives on it."""
    assert Configuration().device == torch.device("cuda:0")
    old = st.config.device
    st.config.device = Configuration().device
    try:
        x, y = _data(4, seed=5)
        if torch.cuda.is_available():
            gp = _build("stationary", x, y, 8)
            assert gp.X_buf.is_cuda and gp.chol_inv.is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                _build("stationary", x, y, 8)
    finally:
        st.config.device = old
    assert st.config.device == torch.device("cpu")


@pytest.mark.parametrize("count", [-1, 9])
def test_wrappers_refuse_a_count_outside_the_capacity(count):
    """``count`` must lie in ``[0, cap]``; checked before any launch."""
    with pytest.raises(ValueError, match="count"):
        gp_kernel._active_rows(count, 8)
    assert gp_kernel._active_rows(None, 8) == 8
