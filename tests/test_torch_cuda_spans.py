"""The port's spans on the card (marked ``cuda``; skipped without a GPU).

Each ``lyapunov.read`` span, kept in memory on the profiler's clock, ends
no earlier than 0.1 ms before the copy to the host it waited for (the
last device-to-host copy that began before the span ended) ends, as the
profiler's device trace times it: the spans and the device's events share
a clock. No JAX is imported:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_spans.py
"""

import numpy as np
import pytest
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import profiling


@pytest.fixture
def on_cuda():
    """Skip without a GPU; otherwise run with ``config.device = cuda:0``."""
    if not torch.cuda.is_available():
        pytest.skip("the device trace needs an NVIDIA GPU")
    old = st.config.device
    st.config.device = "cuda:0"
    yield torch.device("cuda:0")
    st.config.device = old


def instance(kind):
    """A fused 501x501 quadratic instance, or the adaptive nonlinear
    201x201 one whose sorted sweep refines."""
    if kind == "fused":
        grid = st.GridWorld([[-1.0, 1.0]] * 2, 501)
        return st.Lyapunov(grid, st.QuadraticFunction(np.eye(2)),
                           st.LinearSystem(0.5 * np.eye(2)), 0.5, 1.0, 1e-4,
                           st.LambdaFunction(lambda x: x[:, :0]),
                           initial_set=[grid.nindex // 2]), {}
    grid = st.GridWorld([[-1, 1], [-1, 1]], 201)

    def f(xu):
        x = xu[:, :2]
        return x * (0.25 + 0.9 * (x ** 2).sum(dim=1, keepdim=True))

    initial = np.where(np.linalg.norm(grid.all_points, axis=1) <= 0.1)[0]
    return st.Lyapunov(
        grid, st.QuadraticFunction(np.eye(2)),
        st.LambdaFunction(f, input_dim=3, output_dim=2), 2.05,
        st.LambdaFunction(lambda x: 2.0 * torch.abs(x)),
        float(np.min(grid.unit_maxes)),
        st.LambdaFunction(lambda x: 0.0 * x[:, :1]), initial_set=initial,
        adaptive=True), dict(max_refinement=8)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fused", "sorted"])
def test_each_read_ends_after_what_it_waited_for(on_cuda, kind):
    from torch.profiler import ProfilerActivity, profile

    lyap, kwargs = instance(kind)
    lyap.update_safe_set(**kwargs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lyap.update_safe_set(**kwargs)
        torch.cuda.synchronize()
    copies = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CUDA")
              and "DtoH" in e.name()]
    reads = [r for r in profiling.spans()
             if isinstance(r, profiling.SpanRecord)
             and r.name == "lyapunov.read"]
    assert copies and len(reads) >= 3 * 2
    margins = []
    for r in reads:
        waited = max(end for start, end in copies if start < r.end_ns)
        margins.append(r.end_ns - waited)
    print("read end less the end of the copy it waited for, us: "
          "min {:.1f}, median {:.1f}, max {:.1f}".format(
              min(margins) / 1e3, float(np.median(margins)) / 1e3,
              max(margins) / 1e3))
    assert min(margins) > -100_000
