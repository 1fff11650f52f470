"""``lyapunov``: the reads that wait for the device (``lyapunov.host_reads``
counts in the window), per request: how often a certify drains the
card's queue (the port's counter)."""

from ..program_trace import window_count


def read(run):
    reads = window_count(run, "lyapunov.host_reads")
    if reads is None or not run.requests:
        return None
    return reads / len(run.requests)
