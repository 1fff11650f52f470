"""Seconds from the process's start to the window's: imports, the build
or load of the kernels' libraries, the instance and its base GP, set-up's
certify and the warm-up requests (host clock)."""


def read(run):
    return run.setup_s
