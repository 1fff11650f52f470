"""The port's spans and counts (``profiling.named_scope``, ``count``).

With no profiler running a sweep or an append enters no
``record_function`` and leaves the buffer empty; under a profiler the
sweep's counts are the reads that wait for the device and the refined
points of ``last_sweep_counts``. Under ``profiling.trace`` the sweeps and
the GP appends give their named spans under the right parents, one call
id a public call, self times equal to the durations less the children's,
on the profiler's own clock (each span within 1 ms of the profiler's
event for it, the Chrome trace naming them). A full buffer drops later
records, counts them and keeps the spans it holds whole.
"""

import gc
import json

import numpy as np
import pytest
import torch

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import profiling

import _torch_parity  # noqa: F401  (the CPU device)


def fused_instance():
    """A 21x21 quadratic instance; the fused sweep."""
    grid = st.GridWorld([[-1.0, 1.0]] * 2, 21)
    return st.Lyapunov(grid, st.QuadraticFunction(np.eye(2)),
                       st.LinearSystem(0.5 * np.eye(2)), 0.5, 1.0, 1e-4,
                       st.LambdaFunction(lambda x: x[:, :0]),
                       initial_set=[220])


def sorted_instance():
    """``tests/test_lyapunov.py:281-308``'s 41x41 instance, unstable outside
    |x| ~ 0.73: the sorted sweep rescues states by refinement."""
    grid = st.GridWorld([[-1, 1], [-1, 1]], 41)

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
        adaptive=True)


def sweep(kind):
    """A sweep of ``kind`` and the host reads its code makes."""
    if kind == "fused":
        lyap = fused_instance()

        def run():
            lyap.update_safe_set()
            # The levels and c_max.
            return 2
    else:
        lyap = sorted_instance()

        def run():
            lyap.update_safe_set(max_refinement=8)
            # The failing states' nonzero, a read a chunk, c_max and the
            # levels (no level margin: no searchsorted).
            return 1 + lyap.last_sweep_counts["refinement_chunks"] + 2
    return lyap, run


def gp_append(kind):
    """A call appending a row to a GP of ``kind``; ``refuse`` makes the row
    a copy of one a noiseless GP holds, whose pivot the bordered append
    refuses."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (12, 2))
    y = rng.normal(size=(12, 2))

    def make(noise):
        kernel = st.RBF(1.0, [0.2, 0.2], 2)
        if kind == "stacked":
            return st.StackedGaussianProcess([kernel] * 2, x, y, [noise] * 2,
                                             capacity=16)
        return st.GaussianProcess(kernel, x, y, noise, capacity=16)

    def run(refuse=False):
        gp = make(0.0 if refuse else 1e-3)
        row = x[:1] if refuse else rng.uniform(-1, 1, (1, 2))
        return gp.add_data_point(row, rng.normal(size=(1, 2)))
    return run


@pytest.fixture
def empty_buffer(tmp_path):
    """An empty span buffer (a profiler session that recorded nothing)."""
    with profiling.trace(str(tmp_path / "empty")):
        pass
    assert profiling.spans() == []


def window_counts():
    """The buffer's counts, summed by name."""
    out = {}
    for r in profiling.spans():
        if isinstance(r, profiling.CountRecord):
            out[r.name] = out.get(r.name, 0) + r.n
    return out


@pytest.mark.parametrize("kind", ["fused", "sorted", "append"])
def test_no_profiler_no_record_but_the_counters_add(empty_buffer, tmp_path,
                                                    monkeypatch, kind):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        if kind == "append":
            gp_append("stacked")(refuse=True)
        else:
            lyap, run = sweep(kind)
            run()
        assert profiling.spans() == []
        assert profiling.dropped() == 0
    if kind == "append":
        return
    with profiling.trace(str(tmp_path)):
        reads = run()
    expected = {"lyapunov.host_reads": reads}
    if kind == "sorted":
        counts = lyap.last_sweep_counts
        assert counts["refinement_chunks"] >= 1
        expected["lyapunov.refined_points"] = counts["refined_points"]
    assert window_counts() == expected


#: The parent of each span of a certify and of an append.
PARENTS = {"lyapunov.masks": {"lyapunov.update_safe_set"},
           "lyapunov.values": {"lyapunov.update_safe_set"},
           "lyapunov.fused": {"lyapunov.update_safe_set"},
           "lyapunov.sort": {"lyapunov.update_safe_set"},
           "lyapunov.coarse": {"lyapunov.update_safe_set"},
           "lyapunov.walk": {"lyapunov.update_safe_set"},
           "lyapunov.cut": {"lyapunov.update_safe_set"},
           "lyapunov.walk.chunk": {"lyapunov.walk"},
           "lyapunov.read": {"lyapunov.update_safe_set", "lyapunov.walk",
                             "lyapunov.walk.chunk", "lyapunov.cut"},
           "gp.append.buffers": {"gp.add_data_point"},
           "gp.append.border": {"gp.add_data_point"},
           "gp.append.refactor": {"gp.add_data_point"},
           "gp.append.upload": {"gp.add_data_point"}}

#: The spans each call gives (the sorted sweep's walk runs chunks).
NAMES = {
    "fused": {"lyapunov.update_safe_set", "lyapunov.masks", "lyapunov.fused",
              "lyapunov.read"},
    "sorted": {"lyapunov.update_safe_set", "lyapunov.masks",
               "lyapunov.values", "lyapunov.sort", "lyapunov.coarse",
               "lyapunov.walk", "lyapunov.walk.chunk", "lyapunov.cut",
               "lyapunov.read"},
    "plain": {"gp.add_data_point", "gp.append.buffers", "gp.append.border",
              "gp.append.upload"},
    "stacked": {"gp.add_data_point", "gp.append.buffers",
                "gp.append.border", "gp.append.upload"},
    "refused": {"gp.add_data_point", "gp.append.buffers",
                "gp.append.border", "gp.append.refactor"},
    "predict": {"gp.predict"}}


@pytest.mark.parametrize("kind", sorted(NAMES))
def test_spans_nest_under_one_call(tmp_path, kind):
    if kind in ("fused", "sorted"):
        _, run = sweep(kind)
    elif kind == "predict":
        gp = gp_append("plain")()

        def run():
            gp.evaluate(torch.zeros(5, 2, dtype=st.config.dtype))
    else:
        append = gp_append("stacked" if kind != "plain" else "plain")

        def run():
            append(refuse=kind == "refused")
    with profiling.trace(str(tmp_path)):
        run()
        run()
    records = profiling.spans()
    spans = [r for r in records if isinstance(r, profiling.SpanRecord)]
    assert {r.name for r in spans} == NAMES[kind]
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns
               for r in spans)
    assert all(records[r.index] is r for r in spans)
    roots = [r for r in spans if r.parent == -1]
    assert len(roots) == 2 and all(r.call == r.index for r in roots)
    for r in spans:
        if r.parent == -1:
            continue
        parent = records[r.parent]
        assert parent.name in PARENTS[r.name], (r.name, parent.name)
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        assert r.call == parent.call
    # One call id a public call: every span of a call lies inside its root.
    for root in roots:
        inside = [r for r in spans
                  if root.start_ns <= r.start_ns <= root.end_ns]
        assert {r.call for r in inside} == {root.index}
    if kind == "stacked":
        borders = [r for r in spans if r.name == "gp.append.border"]
        assert len(borders) == 2 * 2
    table = profiling.span_table()
    for name in NAMES[kind]:
        mine = [r for r in spans if r.name == name]
        total = sum(r.end_ns - r.start_ns for r in mine)
        children = sum(c.end_ns - c.start_ns for c in spans
                       if c.parent >= 0 and records[c.parent].name == name)
        assert table[name]["count"] == len(mine)
        assert table[name]["total_s"] == pytest.approx(total / 1e9,
                                                       abs=1e-9)
        assert table[name]["self_s"] == pytest.approx(
            (total - children) / 1e9, abs=1e-9)


def test_spans_share_the_profilers_clock(tmp_path):
    _, run = sweep("sorted")
    append = gp_append("stacked")
    log_dir = tmp_path / "prof"
    # A collection between the profiler's stamp and the span's would read
    # as a disagreement of the clocks.
    gc.disable()
    try:
        with profiling.trace(str(log_dir)) as prof:
            run()
            append()
    finally:
        gc.enable()
    spans = [r for r in profiling.spans()
             if isinstance(r, profiling.SpanRecord)]
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and not str(
                e.device_type()).endswith("CUDA"):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in {r.name for r in spans}:
        mine = sorted((r.start_ns, r.end_ns) for r in spans
                      if r.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (s, e), (ps, pe) in zip(mine, theirs):
            assert abs(s - ps) < 1e6 and abs(e - pe) < 1e6, name
    files = list(log_dir.iterdir())
    names = {e.get("name") for e in json.loads(
        files[0].read_text())["traceEvents"]}
    assert {r.name for r in spans} <= names


@pytest.mark.parametrize("fill", ["spans", "counts"])
def test_a_full_buffer_drops_and_counts_later_records(tmp_path, monkeypatch,
                                                      fill):
    monkeypatch.setattr(profiling, "BUFFER_LIMIT", 6)
    with profiling.trace(str(tmp_path)):
        with profiling.named_scope("outer"):
            for _ in range(9):
                if fill == "spans":
                    with profiling.named_scope("inner"):
                        pass
                else:
                    profiling.count("c", 2)
        with profiling.named_scope("after"):
            profiling.count("c")
    records = profiling.spans()
    assert len(records) == 6
    # The root, five of the nine, and the two records after them.
    assert profiling.dropped() == 9 - 5 + 2
    assert records[0].name == "outer" and records[0].end_ns is not None
    kept = records[1:]
    if fill == "spans":
        assert all(isinstance(r, profiling.SpanRecord) and r.parent == 0
                   and r.call == 0 and r.end_ns >= r.start_ns
                   for r in kept)
    else:
        assert [tuple(r[:2]) for r in kept] == [("c", 2)] * 5
    # The next session starts empty, with nothing dropped.
    with profiling.trace(str(tmp_path)):
        with profiling.named_scope("outer"):
            pass
    assert [r.name for r in profiling.spans()] == ["outer"]
    assert profiling.dropped() == 0
