"""``functions.gp``: the median over the window's requests of the host
span around ``add_data_point`` (the float64 bordered append and the
upload), in milliseconds."""

import statistics


def read(run):
    spans = [r[2] for r in run.requests if r[3]]
    return statistics.median(spans) * 1e3 if spans else None
