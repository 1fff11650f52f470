"""``csrc`` kernel 1: the least time of its predicts at the workload's
shape (``workload["kernel1"]``, the frozen ``roofline.kernel_bound``) over
its device time in the traced window, in percent. Each launch is one
predict at that shape."""

from . import is_kernel1
from ..roofline import kernel_bound, stationary_ops


def read(run):
    shape = run.workload.get("kernel1")
    if run.trace is None or shape is None:
        return None
    launches = run.trace.count(is_kernel1)
    seconds = run.trace.seconds(is_kernel1)
    if not launches or seconds <= 0:
        return None
    bound_ms, _ = kernel_bound(
        shape["queries"], shape["d"], shape["count"], shape["p"],
        shape["n_out"], stationary_ops(shape["kind"], shape["d"]),
        shape["itemsize"])
    return 100.0 * bound_ms * 1e-3 * launches / seconds
