"""The port's own spans and counts in a ``--trace 1`` run.

``safe_learning_tpu_torch.profiling`` keeps, while a ``torch.profiler``
session runs, a buffer of span records ``(name, index, parent, call,
start_ns, end_ns)`` and count records ``(name, n, t_ns)`` on the
profiler's clock, the clock of ``trace.Trace``'s device intervals. The
readers here cut them to the window ``[run.trace.lo, run.trace.hi]``. A
port that keeps no such buffer (``profiling.spans`` missing), or whose
full buffer dropped records (``profiling.dropped()``), gives ``None``, and
the metrics that read it are left out of the line.
"""

from __future__ import annotations

import bisect
import itertools

from .trace import union


def records():
    """The port's span and count records; ``None`` where it keeps none,
    or where a full buffer dropped some (the window's sums would read
    low)."""
    from safe_learning_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    dropped = getattr(profiling, "dropped", None)
    if read is None or (dropped is not None and dropped()):
        return None
    return list(read())


def spans(run):
    """Every closed span record of the run, ``{index: record}``; ``None``
    without a trace or without the port's records."""
    found = records() if run.trace is not None else None
    if found is None:
        return None
    return {r[1]: r for r in found if len(r) == 6 and r[5] is not None}


def window_count(run, name):
    """The sum of the counts ``name`` recorded inside the window; ``None``
    where none was."""
    found = records() if run.trace is not None else None
    if found is None:
        return None
    lo, hi = run.trace.lo, run.trace.hi
    counts = [r[1] for r in found
              if len(r) == 3 and r[0] == name and lo <= r[2] <= hi]
    return sum(counts) if counts else None


def idle_within(run):
    """``measure(start_ns, end_ns)``: the seconds of the window in which no
    device operation ran (the gaps between the union of their intervals)
    that lie inside ``[start_ns, end_ns]``."""
    lo, hi = run.trace.lo, run.trace.hi
    busy = union([(s, e) for _, s, e in run.trace.device], lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    starts = [a for a, _ in gaps]
    before = list(itertools.accumulate((b - a for a, b in gaps),
                                       initial=0))

    def idle_until(t):
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0
        a, b = gaps[i]
        return before[i] + min(t, b) - a

    def measure(start, end):
        return max(0, idle_until(end) - idle_until(start)) / 1e9

    return measure


def idle_by_span(run):
    """``{span name: seconds}``: the window's device-idle time by the
    innermost port span open at the time (each span's idle time less its
    child spans'); idle time outside every port span is not in it."""
    found = spans(run)
    if found is None or not run.trace.device:
        return None
    measure = idle_within(run)
    own = {i: measure(r[4], r[5]) for i, r in found.items()}
    children = {}
    for i, r in found.items():
        children[r[2]] = children.get(r[2], 0.0) + own[i]
    out = {}
    for i, r in found.items():
        out[r[0]] = out.get(r[0], 0.0) + own[i] - children.get(i, 0.0)
    return out
