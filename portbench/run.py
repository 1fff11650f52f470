"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``safe_learning_tpu_torch``)
and an NVIDIA GPU: builds the cell's instance on the card from the seed,
warms up, runs a closed loop of requests (one caller, each request waiting
for the last) for ``--seconds``, then checks a sample of what the window
produced, and set-up's certify, against the plain float64 reference
(``reference/``). With ``--trace 1`` the window runs under
``torch.profiler`` and the line carries the per-layer metrics; with
``--trace 0`` the end-to-end ones. The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the line's last key, ``check``.

It exits with another code than 0, and prints no result, without CUDA or
with fewer cards than the cell asks for, and when JAX, the JAX package or
flax is loaded once the window has closed. The port's host work runs with
PyTorch's and the BLAS's default threads, as a user's process runs it.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

from . import registry  # noqa: E402
from .traffic import Traffic, rng_of  # noqa: E402

#: Top-level modules that may not be loaded in the process that prints
#: the result (compared whole: the port's name begins with the JAX
#: package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "safe_learning_tpu")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in modules
                   if name.split(".", 1)[0] in FORBIDDEN})


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length
    (Algorithm R), drawn from ``rng``."""

    def __init__(self, size, rng):
        self.size, self.rng = int(size), rng
        self.items, self.seen = [], 0

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def _nvidia_smi():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed, seconds, trace, device, t_start):
    """One run of ``cell`` (a :class:`registry.Cell`); returns the result
    dictionary. ``device`` is where the port and the reference run
    (``"cuda:0"``, or ``"cpu"`` in the tests)."""
    import torch

    import safe_learning_tpu_torch as st

    st.config.device = device
    cuda = torch.device(device).type == "cuda"
    workload = cell.workload
    program = cell.module("program")
    reference = cell.module("reference")
    kind = cell.module("request")
    warmup = int(workload["warmup_requests"])

    traffic = Traffic(cell.config, workload, reference, seed)
    traffic.prepare(warmup)
    request = kind.Request(cell, traffic, program, reference, seed)
    t_build = time.perf_counter()
    request.setup()
    fastest = math.inf
    for i in range(warmup):
        request.restore()
        t0 = time.perf_counter()
        request.run(i, lambda name: contextlib.nullcontext())
        fastest = min(fastest, time.perf_counter() - t0)
    # The window's rows, twice as many as the warm-up's pace asks for; a
    # faster window draws its further rows alike (the same rows).
    traffic.prepare(warmup + 2 * seconds / max(fastest, 1e-3) + 1)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        def span(name):
            return record_function(name)

        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
    else:
        def span(name):
            return contextlib.nullcontext()

        profiler = contextlib.nullcontext()

    kept = Reservoir(workload["checked_requests"], rng_of(seed, 2))
    records = []
    index = warmup
    with profiler as prof:
        with span("portbench.window"):
            start = time.perf_counter()
            while not records or time.perf_counter() - start < seconds:
                with span("portbench.restore"):
                    request.restore()
                t0 = time.perf_counter()
                try:
                    append_s, out = request.run(index, span)
                    ok = True
                except Exception:  # a failed request is counted, not fatal
                    traceback.print_exc()
                    append_s, out, ok = None, None, False
                t1 = time.perf_counter()
                records.append((t0, t1, append_s, ok))
                if ok:
                    kept.offer(out)
                index += 1
            end = time.perf_counter()
        sync()
    setup_s = start - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    parsed = None
    if trace:
        from .trace import Trace

        parsed = Trace(prof)
    last_counts = getattr(request.lyap, "last_sweep_counts", None)
    request.release()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = request.check(kept.items, device)
    check_s = time.perf_counter() - t_check
    limits = workload["limits"]
    check = {name: dict(value=float(numbers[name]),
                        limit=float(limits[name])) for name in limits}
    failed = sum(1 for r in records if not r[3])
    correct = bool(failed == 0 and kept.items and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in check.values()))

    run = types.SimpleNamespace(
        cell=cell, config=cell.config, workload=workload, seconds=seconds,
        requests=records, window_s=end - start, setup_s=setup_s,
        nindex=request.nindex, trace=parsed)
    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = registry.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = dict(value=float(value),
                                          unit=entry["unit"])
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = dict(platform="gpu" if cuda else "cpu", kind=name,
               count=int(cell.entry["chips"]), memory_peak_bytes=int(peak))
    if parsed is not None:
        dev.update(busy_s=parsed.busy_s, window_s=parsed.window_s)
    times = np.array([r[1] - r[0] for r in records])
    print(json.dumps(dict(
        cell=cell.name, seed=seed, requests=len(records),
        request_ms_median=float(np.median(times) * 1e3),
        request_ms_quarters=[float(np.median(q) * 1e3)
                             for q in np.array_split(times, 4) if len(q)],
        setup_build_s=t_build - t_start, check_s=check_s, numbers=numbers,
        last_sweep_counts=last_counts,
        card=_nvidia_smi() if cuda else None)), file=sys.stderr)
    result = dict(correct=correct, attempted=len(records), failed=failed,
                  metrics=metrics, device=dev)
    if parsed is not None:
        result["breakdown"] = parsed.breakdown
    result["check"] = check
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = registry.Cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("portbench: the cell needs {} CUDA device(s); this machine "
              "has {}".format(chips, torch.cuda.device_count()
                              if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", PROCESS_START)
    found = forbidden_modules()
    if found:
        print("portbench: loaded after the window: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print("check {} {!r} limit {!r}".format(name, c["value"],
                                                c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
