"""Grid states certified per second: the grid's states times the requests
completed in the window, over the window's seconds (host clock)."""


def read(run):
    done = sum(1 for r in run.requests if r[3])
    return run.nindex * done / run.window_s if run.window_s > 0 else None
