"""The port's ``profiling`` module against the JAX package's.

The same ``__all__``; ``MetricsRecorder``'s series, names and summary
equal the JAX package's for the same records, an unrecorded name adding
no series; ``Timer``'s contract (``name``, ``metrics``, ``elapsed``);
``enable_nan_debugging`` raising at the operation that makes a NaN
(``0.0 / 0.0`` on tensors) until its mode is left; ``show_program`` of a
small sweep listing its operators and the hand-written kernels the call
launched, inline and to a file; ``trace`` writing a Chrome trace that
holds a ``named_scope``.
"""

import json

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import safe_learning_tpu_torch as st
from safe_learning_tpu import profiling as jprofiling
from safe_learning_tpu_torch import profiling
from safe_learning_tpu_torch.ops import gp_kernel

import _torch_parity  # noqa: F401  (the CPU device)

RECORDS = [("loss", 1.0), ("loss", 0.5), ("c_max", 2.0), ("frac", 0.25),
           ("loss", np.float32(0.125)), ("c_max", np.float64(3.0))]


def test_all_matches_jax():
    assert profiling.__all__ == jprofiling.__all__


def test_metrics_recorder_matches_jax():
    port, jax_side = profiling.MetricsRecorder(), jprofiling.MetricsRecorder()
    for metrics in (port, jax_side):
        for name, value in RECORDS[:2]:
            metrics.record(name, value)
        metrics.record_many(c_max=2.0, frac=0.25)
        for name, value in RECORDS[4:]:
            metrics.record(name, value)
        # Probing an unrecorded name adds no series.
        assert metrics["missing"].shape == (0,)
    assert port.names() == jax_side.names() == ["c_max", "frac", "loss"]
    for name in port.names():
        assert_array_equal(port[name], jax_side[name])
        assert port[name].dtype == jax_side[name].dtype
    assert port.summary() == jax_side.summary()
    assert port.summary()["loss"] == {"last": 0.125, "count": 3}


def test_timer_contract():
    for module in (profiling, jprofiling):
        metrics = module.MetricsRecorder()
        with module.Timer("step", metrics) as t:
            sum(range(1000))
        assert t.name == "step" and t.metrics is metrics
        assert t.elapsed > 0
        assert_array_equal(metrics["step"], [t.elapsed])
        with module.Timer() as bare:
            pass
        assert bare.name == "timer" and bare.elapsed >= 0


def test_nan_debugging_raises_at_the_operation():
    zero = torch.tensor(0.0)
    mode = profiling.enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
        assert (zero + 1.0).item() == 1.0
        with pytest.raises(FloatingPointError, match="div"):
            zero / zero
        # Integer outputs are not checked.
        assert int(torch.tensor(3) // 2) == 1
    finally:
        mode.disable()
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(zero / zero)


def test_show_program_lists_a_sweeps_operations(tmp_path, monkeypatch):
    grid = st.GridWorld([[-1.0, 1.0]] * 2, 21)
    lyap = st.Lyapunov(grid, st.QuadraticFunction(np.eye(2)),
                       st.LinearSystem(0.5 * np.eye(2)), 0.5, 1.0, 1e-4,
                       st.LambdaFunction(lambda x: x[:, :0]),
                       initial_set=[220])
    out = tmp_path / "sweep.html"
    prog = profiling.show_program(lyap.update_safe_set, file=str(out))
    html = prog._repr_html_()
    assert html == prog.html and "<details" in html
    assert "operators" in html and "hand-written kernels launched" in html
    assert "aten::" in prog.text and repr(prog) == prog.text
    assert "=== hand-written kernels launched ===\nnone" in prog.text
    assert out.stat().st_size > 100
    assert lyap.safe_set.sum() > 1

    # A kernel the call launches is named with its launches and source.
    def launch_twice():
        gp_kernel.gp_predict_stacked_cuda.launches += 2
        return torch.ones(3).sum()

    monkeypatch.setattr(gp_kernel.gp_predict_stacked_cuda, "launches", 0)
    prog = profiling.show_program(launch_twice)
    assert ("gp_predict_stacked: 2 launches "
            "(safe_learning_tpu_torch/csrc/gp_predict_program.cuh)"
            in prog.text)
    assert "gp_predict_program.cuh" in prog.html


def test_kernel_registry_names_each_wrapper_source_and_pallas_body():
    """``gp_kernel.kernels()``, the one registry that ``show_program`` and
    ``chip_smoke.py`` read: every wrapper counts its launches, every
    source is a file of the repository, and every replaced line is the
    ``def`` of a Pallas kernel body in the JAX package or its benchmarks."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    table = gp_kernel.kernels()
    assert table["gp_predict"][0] is gp_kernel.gp_predict_cuda
    assert table["gp_predict_streamed"][0] is \
        gp_kernel.gp_predict_streamed_cuda
    assert len(table) == 9
    for name, (wrapper, source, replaces) in table.items():
        assert isinstance(wrapper.launches, int), name
        assert os.path.isfile(os.path.join(root, source)), source
        path, line = replaces.rsplit(":", 1)
        with open(os.path.join(root, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        assert text.startswith("def _") and "kernel" in text, replaces


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with profiling.trace(str(log_dir)) as prof:
        with profiling.named_scope("matmul scope"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(log_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "matmul scope" for e in events)
    assert any("matmul scope" == e.key for e in prof.key_averages())
