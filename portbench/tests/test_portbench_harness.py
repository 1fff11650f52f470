"""The harness on the CPU: its metric arithmetic, its registry of files,
the modules it may not load, whole runs of small cells, the control, and
runs with the port broken underneath, each of which must come out not
correct. The cells themselves run only on the card (the ``cuda`` case at
the end)."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

import portbench.metrics
from portbench import control, registry, run, trace
from portbench.roofline import kernel_bound, stationary_ops

from .conftest import REPO, ROOT, load

FORBIDDEN = {"jax", "jaxlib", "flax", "safe_learning_tpu"}


def _run(requests, window_s=2.0, nindex=1000, tr=None, workload=None):
    return types.SimpleNamespace(requests=requests, window_s=window_s,
                                 setup_s=3.0, nindex=nindex, trace=tr,
                                 workload=workload or {}, config={})


def test_rate_is_over_the_whole_window():
    reqs = [(0.0, 0.5, 0.01, True), (0.5, 1.0, 0.01, True),
            (1.0, 1.9, 0.02, False)]
    rate = registry.reader("checks_per_s")(_run(reqs, window_s=2.0))
    assert rate == 1000 * 2 / 2.0


def test_p95_is_over_all_requests():
    reqs = [(0.0, t / 1000.0, 0.0, True) for t in range(1, 101)]
    assert registry.reader("certify_p95_ms")(_run(reqs)) == pytest.approx(95)
    reqs.append((0.0, 1.0, 0.0, False))
    assert registry.reader("certify_p95_ms")(_run(reqs)) == pytest.approx(96)


def test_a_request_row_does_not_depend_on_what_was_drawn_before():
    """Request ``i``'s row is the same whether set-up drew many rows or
    none (a run of any ``--seconds``, or the control)."""
    from portbench.traffic import BLOCK, Traffic

    cell = registry.Cell("adaptive1021.certify")
    reference = cell.module("reference")
    seed = 2 ** 32 + 5
    many = Traffic(cell.config, cell.workload, reference, seed)
    many.prepare(3 * BLOCK + 7)
    few = Traffic(cell.config, cell.workload, reference, seed)
    for i in (2 * BLOCK + 3, 0, BLOCK - 1, 3 * BLOCK + 6):
        np.testing.assert_array_equal(few.pair(i)[0], many.pair(i)[0])
        np.testing.assert_array_equal(few.pair(i)[1], many.pair(i)[1])
    rows = np.vstack([many.pair(i)[0] for i in range(2 * BLOCK)])
    assert len(np.unique(rows, axis=0)) == 2 * BLOCK
    np.testing.assert_array_equal(few.base_x, many.base_x)


def test_append_is_the_median_span():
    reqs = [(0, 1, 0.001, True), (0, 1, 0.003, True), (0, 1, 0.1, True)]
    assert registry.reader("append_ms")(_run(reqs)) == pytest.approx(3.0)


class _FakeTrace(trace.Trace):
    def __init__(self, device, lo, hi):
        self.lo, self.hi, self.device = lo, hi, device
        busy = trace.union([(s, e) for _, s, e in device], lo, hi)
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.window_s = (hi - lo) / 1e9


def test_idle_is_the_union_of_intervals():
    # Two overlapping kernels and a copy: busy 0.3 + 0.1 s of 1 s.
    ns = 10 ** 9
    device = [("gp_predict_tiled<float>", 0, int(0.2 * ns)),
              ("other", int(0.1 * ns), int(0.3 * ns)),
              ("Memcpy DtoH", int(0.9 * ns), int(1.2 * ns))]
    tr = _FakeTrace(device, 0, ns)
    run_ = _run([(0, 1, 0, True)] * 2, tr=tr)
    assert registry.reader("device_idle_pct")(run_) == pytest.approx(60.0)
    assert registry.reader("gp_kernel_ms")(run_) == pytest.approx(100.0)
    assert registry.reader("other_device_ms")(run_) == pytest.approx(250.0)
    assert registry.reader("device_ops_per_certify")(run_) == 1.5


def test_idle_gaps_are_named_by_host_activity():
    busy = [[10, 20], [40, 50]]
    host = [("aten::nonzero", 0, 30), ("aten::copy_", 5, 8),
            ("aten::sort", 55, 70)]
    spans = [("portbench.window", 0, 100), ("portbench.certify", 0, 60)]
    gaps = trace.gaps_by_host(busy, 0, 100, host, spans)
    assert gaps == pytest.approx({"certify/aten::nonzero": 10e-9,
                                  "certify/python": 20e-9,
                                  "window/python": 50e-9})


def test_kernel_bound_copy_gives_the_cartpole_bound():
    ms, by = kernel_bound(6765201, 5, 128, 4, 1, stationary_ops("rbf", 5),
                          4)
    assert round(ms, 3) == 2.016 and by == "operations"


def test_roofline_reads_the_workload_shape():
    shape = dict(queries=6765201, d=5, count=128, p=4, n_out=1, kind="rbf",
                 itemsize=4)
    ns = 10 ** 9
    device = [("void gp_predict_tiled<float, 128>(...)", 0,
               int(0.0040315 * ns))]
    tr = _FakeTrace(device, 0, ns)
    value = registry.reader("kernel1_roofline")(
        _run([(0, 1, 0, True)], tr=tr, workload=dict(kernel1=shape)))
    assert value == pytest.approx(50.0, rel=1e-3)
    assert registry.reader("kernel1_roofline")(
        _run([(0, 1, 0, True)], tr=tr)) is None


def test_benchmark_names_a_reader_for_every_metric_and_its_files():
    bench = load(REPO, "BENCHMARK.json")
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(metric["name"]))
    for cell in bench["workloads"]:
        c = registry.Cell(cell["name"])
        for kind in ("program", "reference", "request"):
            assert c.module(kind) is not None
    for config in bench["configs"]:
        assert os.path.exists(os.path.join(REPO, config["file"]))


def test_new_files_register_without_edits(tmp_path, monkeypatch):
    """A new configuration, cell and metric are files and entries: the
    registry finds them with no other file changed."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "workloads").mkdir()
    (tmp_path / "metrics").mkdir()
    config = load(ROOT, "configs", "pendulum_adaptive.json")
    config.update(grid_points=301, family="pendulum_adaptive")
    (tmp_path / "configs" / "pendulum_301.json").write_text(
        json.dumps(config))
    workload = load(ROOT, "workloads", "adaptive181.certify.json")
    workload.update(config="pendulum_301", traffic="append90", base_count=90)
    (tmp_path / "workloads" / "adaptive91.certify.json").write_text(
        json.dumps(workload))
    (tmp_path / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return len(run.requests)\n")
    bench = load(REPO, "BENCHMARK.json")
    bench["workloads"].append(dict(name="adaptive91.certify",
                                   config="pendulum_301",
                                   traffic="append90", chips=1, why="new"))
    bench["per_layer"].append(dict(
        name="requests_done", unit="requests", better="higher",
        source="host_clock", layer="lyapunov", moves="checks_per_s",
        workloads=["adaptive91.certify"]))
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    # Only for this test: the new reader lies outside the package.
    monkeypatch.setattr(portbench.metrics, "__path__",
                        [str(tmp_path / "metrics")]
                        + list(portbench.metrics.__path__))
    cell = registry.Cell("adaptive91.certify", benchmark=str(path),
                         root=str(tmp_path))
    assert cell.config["grid_points"] == 301
    assert cell.module("program").__name__.endswith("pendulum_adaptive")
    assert [m["name"] for m in cell.per_layer][-1] == "requests_done"
    assert registry.reader("requests_done")(_run([1, 2, 3])) == 3
    old = registry.Cell("adaptive181.certify", benchmark=str(path))
    assert "requests_done" not in [m["name"] for m in old.per_layer]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    top = os.path.join(ROOT, sub)
    for dirpath, _, files in os.walk(top):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not (_imports(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "safe_learning_tpu_torch" not in _imports(path), path
        with open(path) as f:
            text = f.read()
        assert "safe_learning_tpu_torch" not in text, path


def test_a_run_loads_no_forbidden_module(tiny_tree):
    """A whole run of a small cell in a fresh process, then the harness's
    own look at ``sys.modules``."""
    path, bench = tiny_tree
    code = (
        "import sys, time, json\n"
        "from portbench import registry, run\n"
        "cell = registry.Cell('adaptive.tiny', benchmark={!r}, root={!r})\n"
        "res = run.run_cell(cell, 5, 0.5, False, 'cpu', time.perf_counter())\n"
        "print(json.dumps(dict(found=run.forbidden_modules(),"
        " correct=res['correct'])))\n").format(bench, path)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == dict(found=[], correct=True)
    assert run.forbidden_modules({"jax.numpy": 1, "safe_learning_tpu": 1,
                                  "safe_learning_tpu_torch": 1}) == [
        "jax", "safe_learning_tpu"]


def test_no_cuda_exits_without_a_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "cartpole51x4.certify", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_a_directory_with_only_the_benchmark_fails(tmp_path):
    """Without the port beside it, the command exits with another code
    than 0 and prints no result."""
    import shutil

    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "-P", "-m", "portbench.run", "--workload",
         "cartpole51x4.certify", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["adaptive.tiny", "cartpole.tiny"])
@pytest.mark.parametrize("traced", [False, True])
def test_small_cell_runs_and_is_correct(tiny_tree, cell, traced):
    path, bench = tiny_tree
    c = registry.Cell(cell, benchmark=bench, root=path)
    res = run.run_cell(c, 2 ** 31 + 11, 0.5, traced, "cpu",
                       time.perf_counter())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "check"
    names = set(res["metrics"])
    if traced:
        assert "append_ms" in names and "breakdown" in res
        assert res["device"]["window_s"] > 0
    else:
        assert {"checks_per_s", "setup_s"} <= names


def _broken(monkeypatch, fault):
    """Break the port underneath the harness."""
    import safe_learning_tpu_torch as st
    from safe_learning_tpu_torch import lyapunov

    real = lyapunov.Lyapunov.update_safe_set
    if fault == "state_unchanged":
        monkeypatch.setattr(lyapunov.Lyapunov, "update_safe_set",
                            lambda self, *a, **k: None)
    elif fault == "half_the_data":
        # Half of the GP's rows left out; the posterior over the rest.
        for cls in (st.GaussianProcess, st.StackedGaussianProcess):
            real_mask = cls._mask

            def half(self, real_mask=real_mask):
                mask = real_mask(self).clone()
                mask[self.count // 2:] = 0
                return mask

            monkeypatch.setattr(cls, "_mask", half)
    elif fault == "answer_altered":
        def altered(self, *a, **k):
            real(self, *a, **k)
            self.c_max = self.c_max * (1 + 1e-3)
            safe = np.array(self.safe_set)
            outside = np.nonzero(~safe)[0]
            safe[outside[np.argmin(np.asarray(
                self.values.cpu())[outside])]] = True
            self.safe_set = safe

        monkeypatch.setattr(lyapunov.Lyapunov, "update_safe_set", altered)
    elif fault == "threshold_scaled":
        # The decrease check's threshold -L_v (1 + L_f) tau a tenth of
        # what it is: the sweep certifies states that fail.
        real_threshold = lyapunov._threshold
        monkeypatch.setattr(lyapunov, "_threshold",
                            lambda *a: real_threshold(*a) * 0.1)


@pytest.mark.parametrize("cell", ["adaptive.tiny", "cartpole.tiny"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_data",
                                   "answer_altered", "threshold_scaled"])
def test_a_broken_port_is_not_correct(tiny_tree, monkeypatch, cell, fault):
    """The rest of a run with the timed path broken underneath: a certify
    that leaves its state unchanged, a GP that leaves out half of its
    rows, an answer altered where it is produced, a decrease check whose
    threshold is scaled wrong. (One card: no exchange between chips to
    leave out.)"""
    path, bench = tiny_tree
    c = registry.Cell(cell, benchmark=bench, root=path)
    c.workload["limits"] = _real_limits(cell)
    _broken(monkeypatch, fault)
    res = run.run_cell(c, 77, 0.3, False, "cpu", time.perf_counter())
    assert res["correct"] is False, res["check"]


def _real_limits(cell):
    from .conftest import TINY_CELLS

    return load(ROOT, "workloads", TINY_CELLS[cell][0] + ".json")["limits"]


@pytest.mark.parametrize("cell", ["adaptive.tiny", "cartpole.tiny"])
def test_the_control_is_not_correct(tiny_tree, cell):
    """The reference in TF32 in the program's place fails a limit of the
    cell it stands for, on three seeds."""
    path, bench = tiny_tree
    c = registry.Cell(cell, benchmark=bench, root=path)
    limits = _real_limits(cell)
    for seed in (1, 2, 3):
        numbers = control.run_control(c, seed, "cpu")
        assert any(numbers[k] > v for k, v in limits.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["adaptive181.certify",
                                  "cartpole51x4.certify"])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
