"""``lyapunov`` (host dispatch): device operations (kernels, copies and
fills) in the traced window, per request."""


def read(run):
    if run.trace is None or not run.requests or not run.trace.device:
        return None
    return run.trace.count() / len(run.requests)
