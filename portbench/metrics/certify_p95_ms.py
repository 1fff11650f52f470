"""The 95th percentile (nearest rank) of the wall time of every request
of the window, in milliseconds (host clock)."""

import math


def read(run):
    times = sorted(r[1] - r[0] for r in run.requests)
    if not times:
        return None
    return times[max(0, math.ceil(0.95 * len(times)) - 1)] * 1e3
