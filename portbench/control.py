"""The control: the reference put in the program's place, one precision
down.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

The configurations state float32 with TF32 off (the port turns it off), so
the control computes every matrix product of the reference in TF32
(``reference.gp.Precision("tf32")``, emulated: the operands rounded to
10 mantissa bits, so it runs alike on the CPU) and the rest in float32:
the policy, the candidate's values, the GP's covariances and posterior,
the decrease margins, the walk and the cut. For each seed it certifies
set-up's data and the first ``checked_requests`` requests' data exactly
as a run of the cell does (the same traffic, the same kept safe set),
and ``reference.judge`` compares its outputs with the float64 reference.
It prints one JSON line a seed with the numbers a run compares, each the
widest over the certifies: their smallest over the seeds is the upper
reading of each limit. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import registry
from .reference import judge
from .reference.certify import certify, grid_points
from .reference.gp import Precision
from .traffic import Traffic


def run_control(cell, seed, device):
    """The judge's numbers of the control on ``cell`` at ``seed``."""
    cfg, workload = cell.config, cell.workload
    reference = cell.module("reference")
    traffic = Traffic(cfg, workload, reference, seed)
    points = grid_points(cfg["grid_limits"],
                         [cfg["grid_points"]] * len(cfg["grid_limits"]))
    initial = reference.initial_set(cfg, points)
    keep_set = not cfg["can_shrink"]
    low, exact = Precision("tf32", device), Precision("float64", device)
    warmup = int(workload["warmup_requests"])

    def one(x, y, previous):
        control = reference.model(cfg, x, y, low)
        safe, c_max, levels = certify(control, initial, previous)
        outputs = dict(safe=safe, c_max=c_max, levels=levels,
                       values=control.grid_values())
        model = reference.model(cfg, x, y, exact)
        gaps = judge.certify_gaps(model, outputs, initial, previous)

        def evaluate(z):
            return control.gp.evaluate(low.tensor(z))

        gaps["posterior_gap"] = judge.posterior_gap(model, evaluate)
        return safe, gaps

    x, y = traffic.base_x, traffic.base_y
    start, numbers = one(x, y, initial.copy() if keep_set else None)
    for i in range(warmup, warmup + int(workload["checked_requests"])):
        px, py = traffic.pair(i)
        _, gaps = one(np.vstack([x, px]), np.vstack([y, py]),
                      start if keep_set else None)
        numbers = {k: max(v, gaps[k]) for k, v in numbers.items()}
    return numbers


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    cell = registry.Cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = run_control(cell, seed, args.device)
        print(json.dumps(dict(cell=cell.name, seed=seed, control="tf32",
                              seconds=time.perf_counter() - t, **numbers)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
