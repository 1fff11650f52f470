"""``lyapunov``: device milliseconds per request of every operation but
kernels 1-3: the policy, the candidate, the decrease and its threshold,
the sort, the level cut, the refinement walk's indexing and the copies
(from the trace)."""

from . import is_gp_kernel


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    other = run.trace.seconds(lambda name: not is_gp_kernel(name))
    return other * 1e3 / len(run.requests)
