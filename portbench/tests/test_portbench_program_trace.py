"""The readers of the port's spans and counts (``program_trace`` and the
metrics that use it) on a hand-made run, where every value is worked out
by hand, and on a small traced cell on the CPU."""

from __future__ import annotations

import time
import types

import pytest
import torch

from portbench import program_trace, registry, run

MS = 1_000_000  # ns

#: Device operations (ns): busy [10, 30], [50, 60], [90, 95] ms of a
#: window [0, 100] ms; idle [0, 10], [30, 50], [60, 90], [95, 100].
DEVICE = [("k", 10 * MS, 20 * MS), ("k", 15 * MS, 30 * MS),
          ("k", 50 * MS, 60 * MS), ("k", 90 * MS, 95 * MS)]


def _span(name, index, parent, call, start, end):
    return (name, index, parent, call, start * MS, end * MS)


#: Two requests' spans and counts, and some outside the window.
RECORDS = [
    _span("gp.add_data_point", 0, -1, 0, 0, 8),
    _span("gp.append.buffers", 1, 0, 0, 0.5, 1),
    _span("gp.append.border", 2, 0, 0, 1, 3),
    _span("gp.append.border", 3, 0, 0, 3, 6),
    _span("gp.append.upload", 4, 0, 0, 6, 7),
    _span("lyapunov.update_safe_set", 5, -1, 5, 8, 70),
    _span("lyapunov.masks", 6, 5, 5, 8, 12),
    _span("lyapunov.read", 7, 5, 5, 25, 40),
    ("lyapunov.host_reads", 1, 25 * MS),
    ("lyapunov.refined_points", 4096, 41 * MS),
    _span("gp.add_data_point", 10, -1, 10, 70, 75),
    _span("gp.append.border", 11, 10, 10, 71, 72),
    _span("lyapunov.update_safe_set", 12, -1, 12, 75, 88),
    ("lyapunov.host_reads", 1, 80 * MS),
    ("lyapunov.host_reads", 1, 85 * MS),
    ("lyapunov.refined_points", 0, 86 * MS),
    # After the window: left out.
    _span("gp.add_data_point", 16, -1, 16, 120, 130),
    _span("gp.append.border", 17, 16, 16, 121, 129),
    ("lyapunov.host_reads", 1, 150 * MS),
    ("lyapunov.refined_points", 512, 150 * MS),
]


def _run(records, monkeypatch):
    """A run of two requests over ``DEVICE`` whose port recorded
    ``records``."""
    from safe_learning_tpu_torch import profiling

    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    trace = types.SimpleNamespace(lo=0, hi=100 * MS, device=DEVICE)
    return types.SimpleNamespace(requests=[(0, 1, 0, True)] * 2,
                                 window_s=0.1, trace=trace)


@pytest.mark.parametrize("name, value", [
    # Idle inside update_safe_set: [8, 10] + [30, 50] + [60, 70] and
    # [75, 88]; not [0, 8] or [70, 75] (the appends), nor [88, 90] and
    # [95, 100] (no port span). 45 ms over 2 requests.
    ("certify_host_idle_ms", 22.5),
    # The two calls in the window: 2 + 3 ms and 1 ms; the median.
    ("border_ms", 3.0),
    ("host_reads_per_certify", 1.5),
    ("refined_points_per_certify", 2048.0),
])
def test_readers_on_a_hand_made_run(monkeypatch, name, value):
    got = registry.reader(name)(_run(RECORDS, monkeypatch))
    assert got == pytest.approx(value, rel=1e-12)


def test_idle_by_innermost_span(monkeypatch):
    got = program_trace.idle_by_span(_run(RECORDS, monkeypatch))
    want = {"gp.add_data_point": 1.5 + 4, "gp.append.buffers": 0.5,
            "gp.append.border": 2 + 3 + 1, "gp.append.upload": 1,
            "lyapunov.update_safe_set": 20 + 13, "lyapunov.masks": 2,
            "lyapunov.read": 10}
    assert set(got) == set(want)
    for key, ms in want.items():
        assert got[key] == pytest.approx(ms / 1e3, abs=1e-12), key
    # The window's 65 ms of idle time less the 7 outside every span.
    assert sum(got.values()) == pytest.approx(0.058, abs=1e-12)


@pytest.mark.parametrize("name", ["certify_host_idle_ms", "border_ms",
                                  "host_reads_per_certify",
                                  "refined_points_per_certify"])
def test_readers_find_nothing_in_a_port_without_spans(monkeypatch, name):
    from safe_learning_tpu_torch import profiling

    traced = _run(RECORDS, monkeypatch)
    monkeypatch.delattr(profiling, "spans")
    assert registry.reader(name)(traced) is None
    untraced = types.SimpleNamespace(requests=[(0, 1, 0, True)],
                                     window_s=0.1, trace=None)
    assert registry.reader(name)(untraced) is None


@pytest.mark.parametrize("name", ["certify_host_idle_ms", "border_ms",
                                  "host_reads_per_certify",
                                  "refined_points_per_certify"])
def test_readers_leave_out_a_run_whose_buffer_overflowed(monkeypatch, name):
    from safe_learning_tpu_torch import profiling

    traced = _run(RECORDS, monkeypatch)
    assert registry.reader(name)(traced) is not None
    monkeypatch.setattr(profiling, "dropped", lambda: 1)
    assert registry.reader(name)(traced) is None
    assert program_trace.idle_by_span(traced) is None


@pytest.mark.parametrize("cell", ["adaptive.tiny", "cartpole.tiny"])
def test_small_traced_cell_reads_the_ports_spans(tiny_tree, monkeypatch,
                                                 cell):
    """On the CPU no device operation runs, so ``certify_host_idle_ms``
    is left out; the others are there, and the refined points are the
    window's ``last_sweep_counts``."""
    from safe_learning_tpu_torch import lyapunov

    refined = []
    real = lyapunov.Lyapunov.update_safe_set

    def counted(self, *args, **kwargs):
        real(self, *args, **kwargs)
        if self.adaptive and torch.autograd._profiler_enabled():
            refined.append(self.last_sweep_counts["refined_points"])

    monkeypatch.setattr(lyapunov.Lyapunov, "update_safe_set", counted)
    path, bench = tiny_tree
    c = registry.Cell(cell, benchmark=bench, root=path)
    res = run.run_cell(c, 2 ** 31 + 23, 0.5, True, "cpu",
                       time.perf_counter())
    metrics = res["metrics"]
    assert res["correct"]
    assert "certify_host_idle_ms" not in metrics
    assert metrics["border_ms"]["value"] > 0
    if cell == "adaptive.tiny":
        # The nonzero, c_max and the two masks, and a read a chunk.
        assert metrics["host_reads_per_certify"]["value"] >= 4
        assert metrics["refined_points_per_certify"]["value"] == \
            pytest.approx(sum(refined) / res["attempted"])
    else:
        assert "refined_points_per_certify" not in metrics
        # The fused sweep's two reads: the safe mask and c_max.
        assert metrics["host_reads_per_certify"]["value"] == 2
