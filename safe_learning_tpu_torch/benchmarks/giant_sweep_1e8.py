"""A certified sweep at 10^8 grid points, streamed through kernel 1.

Counterpart of ``benchmarks/giant_sweep_1e8.py``: ``bench.py``'s
verification instance (a 2-D pendulum-shaped system, an RBF GP on 128
points, the quadratic candidate) on a 10001 x 10001 grid, 100,020,001
points, 11 times the reference's 9.0M-point envelope, through the margin-
guarded ``Lyapunov.update_safe_set``. The grid lies above
``config.fused_sweep_limit``, so the sweep streams: batches of
``--batch`` states made on the card (``GridWorld.states_in_range``), one
launch of kernel 1 (``ops/gp_kernel.py::gp_predict_cuda``) a batch, and
the first failing state in value order kept on the card
(``Lyapunov._update_safe_set_streamed``). The flow is the JAX script's:

1. build the instance (the values stream at construction);
2. ``calibrate_certificate_margin(num_samples=4096)``;
3. two sweeps from the initial set, which must certify the same set
   (between 5 % and 95 % of the grid): seconds, checks per second, device
   milliseconds by CUDA events, kernel-1 launches, peak device memory;
4. the float64 oracle on ``--oracle-samples`` states drawn with
   ``numpy.random.default_rng(7)``: no certified sampled state fails it,
   and ``c_max`` is at most the smallest oracle value of a failing
   non-exempt sampled state (plus 1e-6).

Each stage prints one JSON line, the first with the card's name and
power limit. On a machine with the card::

    python -m safe_learning_tpu_torch.benchmarks.giant_sweep_1e8 \
        [--points 10001 --batch 2097152 --oracle-samples 400000]
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import time

import numpy as np
import torch

from ..config import config
from ..functions.base import LambdaFunction
from ..functions.linear import LinearSystem, QuadraticFunction
from ..grids import GridWorld
from ..lyapunov import Lyapunov
from ..ops import gp_kernel
from ..oracle import (_oracle_values, calibrate_certificate_margin,
                      oracle_margins)
from .pipelined_predict import bench_gp

__all__ = ["bench_instance", "run", "main"]

#: The JAX script's sizes (``benchmarks/giant_sweep_1e8.py:51-56``).
POINTS, BATCH, ORACLE_SAMPLES = 10001, 2 ** 21, 400_000


def card():
    """``nvidia-smi``'s name and power limit of the card, or ``None``."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def _rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _sync():
    if config.device.type == "cuda":
        torch.cuda.synchronize(config.device)


def bench_instance(n_points, batch=BATCH):
    """``bench.py``'s instance (``bench.py:38-79``) on an ``n_points``^2
    grid: the grid, the zero policy, ``v = |x|^2``, its local Lipschitz
    constant ``2|x|``, ``L_f = ||A||_2``, the GP of
    :func:`~.pipelined_predict.bench_gp`, ``tau`` the cell width, and the
    initial set ``v <= 0.01``, found on the device in batches of
    ``batch`` states."""
    grid = GridWorld([[-1.0, 1.0], [-1.0, 1.0]], n_points)
    a = np.array([[0.25, 0.05], [0.0, 0.3]])
    v = QuadraticFunction(np.eye(2))
    initial = []
    for start in range(0, grid.nindex, batch):
        stop = min(start + batch, grid.nindex)
        with torch.no_grad():
            inside = v(grid.states_in_range(start, stop)).reshape(-1) <= 0.01
        initial.append(torch.nonzero(inside).reshape(-1).cpu().numpy()
                       + start)
    return dict(grid=grid, policy=LinearSystem(np.zeros((1, 2))), v=v,
                lv=LambdaFunction(lambda x: 2.0 * torch.abs(x)),
                lf=float(np.linalg.norm(a, 2)), gp=bench_gp(),
                tau=float(np.min(grid.unit_maxes)),
                initial_set=np.concatenate(initial))


def _timed_sweep(lyap, batch):
    """One ``update_safe_set(batch_size=batch)``: its wall seconds, its
    CUDA-event milliseconds (``None`` off the card) and its kernel-1
    launches."""
    launches = gp_kernel.gp_predict_cuda.launches
    events = None
    if config.device.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    _sync()
    start = time.perf_counter()
    if events:
        events[0].record()
    lyap.update_safe_set(batch_size=batch)
    if events:
        events[1].record()
    _sync()
    seconds = time.perf_counter() - start
    device_ms = events[0].elapsed_time(events[1]) if events else None
    return seconds, device_ms, gp_kernel.gp_predict_cuda.launches - launches


def run(points=POINTS, batch=BATCH, oracle_samples=ORACLE_SAMPLES,
        emit=print):
    """The benchmark's flow (module docstring); ``emit`` takes each JSON
    line. Returns a dict of every stage's numbers (``sweeps``: both sweeps'
    seconds, device ms and launches; ``lyap``, ``safe``; the oracle's
    verdicts). Raises when a check fails."""
    def report(section, **fields):
        emit(json.dumps(dict(section=section, **fields)))

    out = {}
    report("backend", device=str(config.device), card=card(),
           grid=[points, points], nindex=points * points, batch=batch)
    if config.device.type == "cuda":
        # The statistics exist once the device's context does.
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(config.device)
    t0 = time.perf_counter()
    inst = bench_instance(points, batch)
    grid = inst["grid"]
    lyap = Lyapunov(grid, inst["v"], inst["gp"], inst["lf"], inst["lv"],
                    inst["tau"], inst["policy"],
                    initial_set=inst["initial_set"])
    _sync()
    out["build_s"] = time.perf_counter() - t0
    report("build", seconds=out["build_s"], tau=inst["tau"],
           initial_states=int(len(inst["initial_set"])), rss_gb=_rss_gb())

    t0 = time.perf_counter()
    margin = calibrate_certificate_margin(lyap, num_samples=4096)
    out["margin_s"] = time.perf_counter() - t0
    report("margin", seconds=out["margin_s"], margin=margin,
           level_margin=lyap.level_margin)

    sweeps = []
    for name in ("sweep_first", "sweep_steady"):
        lyap.safe_set = np.zeros(grid.nindex, dtype=bool)
        lyap.safe_set |= lyap.initial_safe_set
        seconds, device_ms, launches = _timed_sweep(lyap, batch)
        safe = np.array(lyap.safe_set)
        sweeps.append(dict(seconds=seconds, device_ms=device_ms,
                           launches=launches,
                           checks_per_sec=grid.nindex / seconds))
        report(name, safe_fraction=float(safe.mean()),
               c_max=float(lyap.c_max), rss_gb=_rss_gb(), **sweeps[-1])
        if name == "sweep_first":
            first = safe
    if not (np.array_equal(first, safe) and 0.05 < safe.mean() < 0.95):
        raise AssertionError("the two sweeps differ or the instance does "
                             "not discriminate")
    out.update(sweeps=sweeps, safe=safe, lyap=lyap, margin=margin,
               c_max=float(lyap.c_max), safe_fraction=float(safe.mean()))
    if config.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(config.device)

    # The float64 oracle on a subsample: containment and the level.
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    idx = rng.choice(grid.nindex, size=min(oracle_samples, grid.nindex),
                     replace=False)
    sub = grid.points_at(idx).astype(np.float64)
    om = oracle_margins(lyap, sub)
    ov = _oracle_values(lyap, sub)
    exempt = np.isin(idx, inst["initial_set"])
    violations = int((safe[idx] & ~exempt & (om >= 0)).sum())
    fail = (om >= 0) & ~exempt
    oracle_c = float(np.min(ov[fail])) if fail.any() else np.inf
    level_ok = bool(lyap.c_max <= oracle_c + 1e-6 * max(1.0, abs(oracle_c)))
    out.update(oracle_s=time.perf_counter() - t0, samples=len(idx),
               violations=violations, oracle_c_upper=oracle_c,
               level_ok=level_ok)
    report("oracle_subsample", seconds=out["oracle_s"], samples=len(idx),
           containment_violations=violations, c_max=out["c_max"],
           oracle_c_upper=oracle_c, level_ok=level_ok)
    if violations or not level_ok:
        raise AssertionError("{} certified sampled states fail the float64 "
                             "oracle; level_ok={}".format(violations,
                                                          level_ok))
    report("summary", ok=True, nindex=grid.nindex,
           checks_per_sec=sweeps[-1]["checks_per_sec"],
           device_ms=sweeps[-1]["device_ms"],
           launches_per_sweep=sweeps[-1]["launches"],
           peak_device_gb=out.get("peak_bytes", 0) / 1e9,
           vs_reference_envelope=grid.nindex / 9.0e6)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--points", type=int, default=POINTS,
                        help="grid points per axis (10001: 1.0e8 points)")
    parser.add_argument("--batch", type=int, default=BATCH,
                        help="grid points per streamed batch")
    parser.add_argument("--oracle-samples", type=int,
                        default=ORACLE_SAMPLES)
    args = parser.parse_args(argv)
    return run(args.points, args.batch, args.oracle_samples)


if __name__ == "__main__":
    main()
