"""``lyapunov``: the window's device-idle milliseconds inside the port's
``lyapunov.update_safe_set`` spans, per request: how long the card waited
on the certify's host code (the port's spans, the device trace)."""

from ..program_trace import idle_within, spans


def read(run):
    found = spans(run)
    if found is None or not run.trace.device or not run.requests:
        return None
    roots = [r for r in found.values() if r[0] == "lyapunov.update_safe_set"]
    if not roots:
        return None
    measure = idle_within(run)
    return sum(measure(r[4], r[5]) for r in roots) * 1e3 / len(run.requests)
