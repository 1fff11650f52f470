"""``ops.gp_kernel`` / ``csrc``: device milliseconds of kernels 1-3 (the
``gp_predict_*`` and ``gp_program_*`` kernels) per request, from the
trace."""

from . import is_gp_kernel


def read(run):
    if run.trace is None or not run.trace.count(is_gp_kernel):
        return None
    return run.trace.seconds(is_gp_kernel) * 1e3 / len(run.requests)
