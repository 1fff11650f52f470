"""Shared pieces of the benchmark's tests: small copies of the cells.

The tests run on the CPU at sizes a test run holds; the cells run on the
card. ``tiny_tree`` writes a ``BENCHMARK.json``, configurations and
workloads at small sizes into a temporary directory; their modules are
the real configurations'.
"""

from __future__ import annotations

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)


def load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


#: Small sizes of each configuration: grid points, refinement, capacity.
TINY = {"pendulum_adaptive_181": dict(grid_points=41, max_refinement=4,
                                      capacity=64),
        "cartpole_51x4": dict(grid_points=7, capacity=32,
                              initial_quantile=0.01)}

#: Small cells: the real cell each stands for and its base count.
TINY_CELLS = {"adaptive.tiny": ("adaptive181.certify", 30),
              "cartpole.tiny": ("cartpole51x4.certify", 20)}


def write_tiny_tree(path):
    """A tree of small cells under ``path``; returns the path of its
    ``BENCHMARK.json``."""
    os.makedirs(os.path.join(path, "configs"), exist_ok=True)
    os.makedirs(os.path.join(path, "workloads"), exist_ok=True)
    bench = load(REPO, "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    cells = []
    for name, (real, base) in TINY_CELLS.items():
        entry = dict(entries[real])
        config = load(ROOT, "configs", entry["config"] + ".json")
        config.update(TINY[entry["config"]],
                      family=config.get("family", entry["config"]))
        tiny_config = entry["config"] + "_tiny"
        with open(os.path.join(path, "configs", tiny_config + ".json"),
                  "w") as f:
            json.dump(config, f)
        workload = load(ROOT, "workloads", real + ".json")
        workload.update(config=tiny_config, base_count=base,
                        warmup_requests=1, checked_requests=2)
        if "kernel1" in workload:
            workload["kernel1"].update(
                queries=config["grid_points"] ** 4, count=base + 1)
        with open(os.path.join(path, "workloads", name + ".json"),
                  "w") as f:
            json.dump(workload, f)
        cells.append(dict(entry, name=name, config=tiny_config))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [
                n for n, (real, _) in TINY_CELLS.items()
                if real in metric["workloads"]]
    bench["workloads"] = cells
    target = os.path.join(path, "BENCHMARK.json")
    with open(target, "w") as f:
        json.dump(bench, f)
    return target


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny"))
    return path, write_tiny_tree(path)


@pytest.fixture(scope="module", autouse=True)
def port_on_cpu():
    """The port's objects on the CPU (its kernels' plain versions)."""
    import safe_learning_tpu_torch as st

    st.config.device = "cpu"
    yield
