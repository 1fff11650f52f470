"""The fused sweep's time against the number of shards.

Counterpart of ``benchmarks/mesh_scaling.py``: the same instance (a
1024x1024 grid, a stacked GP of two RBF outputs on 64 measurements, the
quadratic candidate; kernel 3 on the card) swept by the fused
``update_safe_set`` over meshes of 1, 2, 4 and 8 entries
(``parallel.make_mesh(devices=[device] * k)``), each checked equal to the
sweep without a mesh, bit for bit. Every entry of such a mesh is the same
device, so the shards run one after another on it: the times show what
sharding costs on one card (a launch and two reductions a shard), not
scaling across cards. Each mesh size prints one JSON line: milliseconds a
sweep by the wall clock and by CUDA events (the median of ``--iters``
sweeps after one warm-up), checks per second, kernel 3's launches a sweep;
the first line has the card's name and power limit::

    python -m safe_learning_tpu_torch.benchmarks.mesh_scaling \\
        [--device cuda:0] [--max-shards 8] [--iters 10]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..config import config
from ..functions.base import LambdaFunction
from ..functions.gp import RBF, StackedGaussianProcess
from ..functions.linear import LinearSystem, QuadraticFunction
from ..grids import GridWorld
from ..lyapunov import Lyapunov
from ..ops import gp_kernel
from ..parallel import make_mesh, sharded_safe_set_update
from .giant_sweep_1e8 import card

__all__ = ["build_instance", "run", "main"]


def build_instance(points=1024):
    """The JAX script's instance (``benchmarks/mesh_scaling.py:35-56``) on
    a ``points``^2 grid, as a fresh ``Lyapunov``."""
    rng = np.random.default_rng(0)
    grid = GridWorld([[-1.0, 1.0], [-1.0, 1.0]], [points, points])
    av = np.array([[0.25, 0.05], [0.0, 0.3]])
    x_inner = np.column_stack([rng.uniform(-0.4, 0.4, 64),
                               rng.uniform(-0.4, 0.4, 64), np.zeros(64)])
    gp = StackedGaussianProcess(
        [RBF(1.0, [0.3] * 3, input_dim=3),
         RBF(1.0, [0.35] * 3, input_dim=3)],
        x_inner, x_inner[:, :2] @ av.T, noise_variances=1e-4,
        mean_functions=[LinearSystem([av[[d]], np.zeros((1, 1))])
                        for d in range(2)])
    vvals = np.sum(grid.all_points ** 2, axis=1)
    return Lyapunov(grid, QuadraticFunction(np.eye(2)), gp,
                    float(np.linalg.norm(av, 2)),
                    LambdaFunction(lambda x: 2.0 * torch.abs(x)),
                    float(np.min(grid.unit_maxes)),
                    LinearSystem(np.zeros((1, 2))),
                    initial_set=np.where(vvals <= 0.02)[0])


def _sync():
    if config.device.type == "cuda":
        torch.cuda.synchronize(config.device)


def _timed(fn, iters):
    """Median wall ms and CUDA-event ms (``None`` off the card) of
    ``fn()`` over ``iters`` calls after one warm-up."""
    fn()
    wall, device = [], []
    for _ in range(iters):
        events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if config.device.type == "cuda" else None)
        _sync()
        start = time.perf_counter()
        if events:
            events[0].record()
        fn()
        if events:
            events[1].record()
        _sync()
        wall.append((time.perf_counter() - start) * 1e3)
        if events:
            device.append(events[0].elapsed_time(events[1]))
    return (statistics.median(wall),
            statistics.median(device) if device else None)


def run(max_shards=8, iters=10, points=1024, emit=print):
    """Sweep over meshes of 1, 2, 4, ... up to ``max_shards`` entries of
    ``config.device``; raise if a sweep differs from the one without a
    mesh. Returns one dict per mesh size (``shards``, ``ms``,
    ``device_ms``, ``checks_per_sec``, ``launches``)."""
    emit(json.dumps({"section": "backend", "device": str(config.device),
                     "card": card(), "grid": [points, points]}))
    base = build_instance(points)
    base.update_safe_set()
    ref_safe, ref_cmax = np.array(base.safe_set), base.c_max
    rows = []
    shards = 1
    while shards <= max_shards:
        lyap = build_instance(points)
        mesh = make_mesh(devices=[config.device] * shards)
        safe, c_max = sharded_safe_set_update(lyap, mesh)
        if not (np.array_equal(safe, ref_safe) and c_max == ref_cmax):
            raise AssertionError("the sweep over {} shards differs from the "
                                 "sweep without a mesh".format(shards))
        before = gp_kernel.gp_predict_stacked_cuda.launches
        ms, device_ms = _timed(lambda: sharded_safe_set_update(lyap, mesh),
                               iters)
        launches = (gp_kernel.gp_predict_stacked_cuda.launches
                    - before) / (iters + 1)
        rows.append(dict(shards=shards, ms=ms, device_ms=device_ms,
                         checks_per_sec=lyap.discretization.nindex
                         / (ms / 1e3), launches=launches,
                         safe_fraction=float(safe.mean()), c_max=c_max))
        emit(json.dumps(dict(section="mesh", **rows[-1])))
        shards *= 2
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--max-shards", type=int, default=8)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--points", type=int, default=1024)
    args = parser.parse_args(argv)
    config.device = args.device
    return run(args.max_shards, args.iters, args.points)


if __name__ == "__main__":
    main()
