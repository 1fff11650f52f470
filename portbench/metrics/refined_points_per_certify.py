"""``lyapunov``: the refined sub-points the walk checked
(``lyapunov.refined_points`` counts in the window), per request (the
port's counter)."""

from ..program_trace import window_count


def read(run):
    points = window_count(run, "lyapunov.refined_points")
    if points is None or not run.requests:
        return None
    return points / len(run.requests)
