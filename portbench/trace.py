"""Read a ``torch.profiler`` trace of the window, in memory.

The device's operations (kernels, copies and fills) come from the
profiler's CUPTI records, the host's from its operator records and the
harness's own spans (``record_function``), all on one clock. Busy time is
the union of the device operations' intervals, not the sum of their
times; an idle gap is named by what the host was doing at its middle: the
harness's innermost span and the outermost PyTorch operator there.
"""

from __future__ import annotations

import bisect

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _ns(event):
    start = event.start_ns()
    return start, start + event.duration_ns()


def collect(prof):
    """``(device, host, spans)`` of a finished profile, each a list of
    ``(name, start_ns, end_ns)``: device operations, host operators, and
    the harness's spans (names starting ``portbench.``)."""
    device, host, spans = [], [], []
    for event in prof.profiler.kineto_results.events():
        kind = event.activity_type() if hasattr(event, "activity_type") \
            else ""
        on_device = str(event.device_type()).endswith("CUDA")
        start, end = _ns(event)
        if on_device:
            if kind in DEVICE_ACTIVITIES or (
                    not kind and not event.is_user_annotation()):
                device.append((event.name(), start, end))
        elif event.is_user_annotation():
            if event.name().startswith("portbench."):
                spans.append((event.name(), start, end))
        elif kind in ("cpu_op", ""):
            host.append((event.name(), start, end))
    return device, host, spans


def union(intervals, lo, hi):
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    merged = []
    for start, end in sorted((max(s, lo), min(e, hi))
                             for s, e in intervals):
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _outermost(intervals):
    """Intervals not inside another, sorted by start."""
    out = []
    for name, start, end in sorted(intervals, key=lambda t: (t[1], -t[2])):
        if out and end <= out[-1][2]:
            continue
        out.append((name, start, end))
    return out


def _at(layer, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and layer[i][1] <= t < layer[i][2]:
        return layer[i][0]
    return None


def gaps_by_host(busy, lo, hi, host, spans):
    """Idle seconds inside ``[lo, hi]`` by what the host was doing: ``{name:
    seconds}``, the name ``<span>/<operator>`` at the middle of each
    gap."""
    ops = _outermost(host)
    op_starts = [s for _, s, _ in ops]
    # The harness's spans inside the window do not overlap one another.
    inner = _outermost([t for t in spans if t[0] != "portbench.window"])
    inner_starts = [s for _, s, _ in inner]
    out = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for start, end in zip(edges[0::2], edges[1::2]):
        if end <= start:
            continue
        mid = (start + end) / 2
        span = _at(inner, inner_starts, mid) or "portbench.window"
        op = _at(ops, op_starts, mid)
        key = "{}/{}".format(span.split(".", 1)[-1], op or "python")
        out[key] = out.get(key, 0.0) + (end - start) / 1e9
    return out


class Trace:
    """The window's trace: ``device`` operations inside ``[lo, hi]`` (ns),
    ``busy_s`` (their union), ``window_s``, and ``breakdown`` (the ten
    device operations that took most time, the ten largest idle shares by
    host activity)."""

    def __init__(self, prof, window_name="portbench.window"):
        device, host, spans = collect(prof)
        windows = [s for s in spans if s[0] == window_name]
        if not windows:
            raise RuntimeError("the trace holds no window span")
        _, self.lo, self.hi = windows[0]
        self.device = [(n, s, e) for n, s, e in device
                       if s < self.hi and e > self.lo]
        busy = union([(s, e) for _, s, e in self.device], self.lo, self.hi)
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.window_s = (self.hi - self.lo) / 1e9
        totals = {}
        for name, s, e in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s) / 1e9
        gaps = gaps_by_host(busy, self.lo, self.hi, host, spans)
        self.breakdown = dict(
            device_ops=[[n[:120], t] for n, t in sorted(
                totals.items(), key=lambda kv: -kv[1])[:10]],
            idle_gaps=[[n[:120], t] for n, t in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]])

    def seconds(self, match=None):
        """Device seconds of the operations whose name ``match(name)``
        accepts (all of them without one)."""
        return sum((e - s) / 1e9 for n, s, e in self.device
                   if match is None or match(n))

    def count(self, match=None):
        return sum(1 for n, _, _ in self.device
                   if match is None or match(n))
