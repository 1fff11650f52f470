"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A cell ``<cell>`` of ``BENCHMARK.json`` names its configuration and its
traffic; ``workloads/<cell>.json`` holds the traffic's parameters and the
request kind, ``configs/<config>.json`` the configuration, and the
modules ``programs/<config>``, ``reference/models/<config>``,
``requests/<request>`` and ``metrics/<metric>`` the code of each (a
configuration may name another's modules as its ``family``: a new
configuration of a system the benchmark builds is then a file of
numbers). A new
cell, configuration, request kind or metric is a new file; no file here
lists them.
"""

from __future__ import annotations

import importlib
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCHMARK = os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """Everything one cell needs: its ``BENCHMARK.json`` entry
    (``entry``), the metric entries it reports (``end_to_end``,
    ``per_layer``), its ``workload`` and ``config`` dictionaries, and the
    modules that build, serve and judge it."""

    def __init__(self, name, benchmark=None, root=ROOT):
        bench = load_json(benchmark or BENCHMARK)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError("no cell {!r} in BENCHMARK.json".format(name))
        self.name = name
        self.entry = entries[name]
        self.workload = load_json(os.path.join(root, "workloads",
                                               name + ".json"))
        for key in ("config", "traffic"):
            if self.workload[key] != self.entry[key]:
                raise ValueError("workloads/{}.json names {} {!r}, "
                                 "BENCHMARK.json {!r}".format(
                                     name, key, self.workload[key],
                                     self.entry[key]))
        self.config = load_json(os.path.join(root, "configs",
                                             self.entry["config"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if reports(m, name)]

    def module(self, kind):
        """``program``, ``reference`` or ``request`` module of the cell."""
        family = self.config.get("family", self.entry["config"])
        name = {"program": "portbench.programs." + family,
                "reference": "portbench.reference.models." + family,
                "request": "portbench.requests."
                           + self.workload["request"]}[kind]
        return importlib.import_module(name)


def reports(metric, cell):
    """Whether ``cell`` reports ``metric`` (an entry of ``end_to_end`` or
    ``per_layer``): every cell, unless the entry lists its cells."""
    return "workloads" not in metric or cell in metric["workloads"]


def reader(metric_name):
    """The reader ``metrics/<name>.py``'s ``read(run)``."""
    return importlib.import_module("portbench.metrics."
                                   + metric_name).read
