"""Metric readers: ``metrics/<name>.py`` reads the metric ``<name>`` of
``BENCHMARK.json`` from a run (``read(run)``), or returns ``None`` where
the run holds nothing to read, and the harness leaves it out.

``run`` has ``requests`` (``(start, end, append_s, ok)`` a request, host
clock, in the window), ``window_s``, ``setup_s``, ``nindex`` (the grid's
states), ``config``, ``workload`` and ``trace`` (a ``trace.Trace`` of the
window in a ``--trace 1`` run, else ``None``).
"""

import re

#: Kernels 1-3 of the port (``csrc/gp_predict.cu``: ``gp_predict_*``;
#: ``csrc/gp_predict_program.cuh``: ``gp_program_*``).
GP_KERNEL = re.compile(r"\bgp_(predict|program)_")
#: Kernel 1 alone.
KERNEL1 = re.compile(r"\bgp_predict_")


def is_gp_kernel(name):
    return GP_KERNEL.search(name) is not None


def is_kernel1(name):
    return KERNEL1.search(name) is not None
