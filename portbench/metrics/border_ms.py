"""``functions.gp``: the median over the window's ``gp.add_data_point``
calls of their summed ``gp.append.border`` spans (the float64 bordered
solve, one an output), in milliseconds (the port's spans)."""

import statistics

from ..program_trace import spans


def read(run):
    found = spans(run)
    if found is None:
        return None
    lo, hi = run.trace.lo, run.trace.hi
    calls = {i: 0 for i, r in found.items()
             if r[0] == "gp.add_data_point" and lo <= r[4] <= hi}
    if not calls:
        return None
    for r in found.values():
        if r[0] != "gp.append.border":
            continue
        up = r[2]
        while up in found and up not in calls:
            up = found[up][2]
        if up in calls:
            calls[up] += r[5] - r[4]
    return statistics.median(calls.values()) / 1e6
