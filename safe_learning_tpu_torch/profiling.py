"""Tracing, profiling and lightweight metrics.

Counterpart of ``safe_learning_tpu/profiling.py`` on ``torch.profiler``:
``trace`` records a profile of the host and, when ``config.device`` is a
CUDA device, of the card, and writes it as a Chrome trace (Perfetto or
``chrome://tracing`` show it); ``named_scope`` labels a range in it;
``Timer`` and ``MetricsRecorder`` structure the learning loops' timings
and series; ``show_program`` renders what one call ran, operator by
operator, with the hand-written kernels it launched; and
``enable_nan_debugging`` raises at the first operation that makes a NaN.

The port's spans and counts (these names stay out of ``__all__``,
which is the JAX package's). Each costs one check of ``torch.autograd.
_profiler_enabled()`` while no ``torch.profiler`` session runs, and
records nothing. While one runs (``trace``, or any other):

- ``named_scope(name)`` enters ``record_function(name)`` and keeps a
  :class:`SpanRecord` ``(name, index, parent, call, start_ns, end_ns)``:
  ``index`` is its place in the buffer, ``parent`` the enclosing span's
  (-1 for none), ``call`` the outermost open span's, so every span of one
  public call shares it; the times are on the profiler's own clock
  (Unix-epoch nanoseconds, ``time.time_ns``), so the spans line up with
  the device's events. Spans nest within one thread.
- ``count(name, n=1)`` keeps a :class:`CountRecord` ``(name, n, t_ns)``,
  so that a window's counts can be cut out by time.

The buffer holds :data:`BUFFER_LIMIT` records; later ones are dropped
and counted by ``dropped()``. ``spans()`` returns the buffer,
``span_table()`` sums its spans by name (count, total and self seconds,
self being the duration less its child spans). The buffer is cleared
when a session starts: by ``trace``, and otherwise at the session's
first span or count (a session begins, for the buffer, at the first span
or count seen with the profiler on after one seen with it off).
"""

from __future__ import annotations

import contextlib
import html
import os
import time
from collections import defaultdict, namedtuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .config import config
from .ops import gp_kernel

__all__ = ["trace", "named_scope", "Timer", "MetricsRecorder",
           "enable_nan_debugging", "show_program"]

#: Most records the buffer of spans and counts holds in one session.
BUFFER_LIMIT = 1 << 19

#: A span of the buffer (times in Unix-epoch nanoseconds; ``end_ns`` is
#: ``None`` while the span is open).
SpanRecord = namedtuple("SpanRecord",
                        "name index parent call start_ns end_ns")
#: A count added while a session ran.
CountRecord = namedtuple("CountRecord", "name n t_ns")

_profiler_on = torch.autograd._profiler_enabled


class _Recorder:
    """One session's buffer and stack of open spans. A span is kept as
    ``(name, parent, call, start_ns)``, its end in ``ends`` under its
    index, and a count as ``(name, n, t_ns)``: plain tuples of atoms,
    which the garbage collector stops tracking."""

    def __init__(self):
        self.begin()
        self.live = False

    def begin(self):
        """A new session: an empty buffer."""
        self.records = []
        self.ends = {}
        self.open = []
        self.dropped = 0
        self.live = True


_RECORDER = _Recorder()


class _Span:
    """One recorded ``named_scope``."""

    __slots__ = ("scope", "records", "index")

    def __init__(self, name):
        self.scope = torch.profiler.record_function(name)

    def __enter__(self):
        rec = _RECORDER
        if not rec.live:
            rec.begin()
        self.scope.__enter__()
        start = time.time_ns()
        records, open_ = rec.records, rec.open
        self.records = records
        self.index = index = len(records)
        if index < BUFFER_LIMIT:
            records.append((self.scope.name, open_[-1] if open_ else -1,
                            records[open_[0]][2] if open_ else index,
                            start))
        else:
            self.index = None
            rec.dropped += 1
        open_.append(self.index)
        return self

    def __exit__(self, *exc):
        self.scope.__exit__(*exc)
        end = time.time_ns()
        rec = _RECORDER
        if self.records is rec.records:
            rec.open.pop()
            if self.index is not None:
                rec.ends[self.index] = end
        return False


_OFF = contextlib.nullcontext()


def named_scope(name):
    """Label a range of the profile: ``with named_scope("sweep"): ...``.

    A shared no-op while no profiler session runs; during one, a
    ``record_function`` span that is also kept in :func:`spans`."""
    if not _profiler_on():
        _RECORDER.live = False
        return _OFF
    return _Span(name)


def count(name, n=1):
    """During a profiler session, record ``n`` of ``name`` with its time
    in :func:`spans`; otherwise nothing."""
    if not _profiler_on():
        _RECORDER.live = False
        return
    rec = _RECORDER
    if not rec.live:
        rec.begin()
    if len(rec.records) < BUFFER_LIMIT:
        rec.records.append((name, n, time.time_ns()))
    else:
        rec.dropped += 1


def spans():
    """The buffer: this session's :class:`SpanRecord`\\ s and
    :class:`CountRecord`\\ s, in the order they began."""
    ends = _RECORDER.ends
    return [SpanRecord(r[0], i, r[1], r[2], r[3], ends.get(i))
            if len(r) == 4 else CountRecord(*r)
            for i, r in enumerate(_RECORDER.records)]


def dropped():
    """How many spans and counts this session left out of a full
    buffer."""
    return _RECORDER.dropped


def span_table():
    """``{name: {"count", "total_s", "self_s"}}`` over the buffer's closed
    spans: how many, their summed duration, and their summed self time
    (each span's duration less that of its closed child spans)."""
    closed = [r for r in spans()
              if isinstance(r, SpanRecord) and r.end_ns is not None]
    children = defaultdict(int)
    for r in closed:
        if r.parent >= 0:
            children[r.parent] += r.end_ns - r.start_ns
    table = {}
    for r in closed:
        row = table.setdefault(r.name, dict(count=0, total_s=0.0,
                                            self_s=0.0))
        duration = r.end_ns - r.start_ns
        row["count"] += 1
        row["total_s"] += duration / 1e9
        row["self_s"] += (duration - children[r.index]) / 1e9
    return table


def _activities():
    """The profiler's activities: the host, and the card when
    ``config.device`` is a CUDA device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if config.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block: ``with trace("/tmp/profile"): step()``.

    On exit the profile is written into ``log_dir`` (made if missing) as
    a Chrome trace, ``trace-<pid>-<ns>.json``. Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` sum the block's
    operators and kernels. The buffer of :func:`spans` starts empty.
    """
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        _RECORDER.begin()
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, "trace-{}-{}.json".format(os.getpid(), time.time_ns())))


def _synchronize():
    if config.device.type == "cuda":
        torch.cuda.synchronize(config.device)


class Timer:
    """Wall-clock timer context manager: ``elapsed`` seconds, recorded
    under ``name`` in ``metrics`` when given. On a CUDA ``config.device``
    it waits for the device at both ends, so the time covers the device's
    work."""

    def __init__(self, name="timer", metrics=None):
        self.name = name
        self.metrics = metrics
        self.elapsed = None

    def __enter__(self):
        """Start the timer."""
        _synchronize()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        """Stop the timer and store the elapsed seconds."""
        _synchronize()
        self.elapsed = time.perf_counter() - self._start
        if self.metrics is not None:
            self.metrics.record(self.name, self.elapsed)
        return False


class MetricsRecorder:
    """Append-only scalar metrics recorder (the reference notebooks'
    ``safe_level`` / ``safe_set_fraction`` / ``test_loss`` lists)."""

    def __init__(self):
        self._data = defaultdict(list)

    def record(self, name, value):
        """Append one scalar value under ``name``."""
        self._data[name].append(float(value))

    def record_many(self, **kwargs):
        """Append several named scalar values at once."""
        for name, value in kwargs.items():
            self.record(name, value)

    def __getitem__(self, name):
        # .get: probing an unrecorded name must not insert a phantom
        # empty series into the defaultdict (summary() would crash).
        """Return the recorded series for ``name``."""
        return np.asarray(self._data.get(name, []))

    def names(self):
        """Recorded metric names."""
        return sorted(self._data)

    def summary(self):
        """Dict of the latest value per metric."""
        return {name: {"last": values[-1], "count": len(values)}
                for name, values in self._data.items()}


_SHOW_PROGRAM_CSS = """
<style>
.slt-prog { font-family: ui-monospace, Menlo, monospace; font-size: 12px; }
.slt-prog summary { cursor: pointer; font-weight: 600; padding: 2px 0; }
.slt-prog table { border-collapse: collapse; margin: 4px 0 10px; }
.slt-prog td, .slt-prog th { border: 1px solid #d0d7de; padding: 2px 8px;
  text-align: right; }
</style>
"""


class _Program:
    """What :func:`show_program` rendered: ``html`` (shown inline by a
    notebook through ``_repr_html_``) and the plain ``text``."""

    def __init__(self, html_body, text_body):
        self.html = html_body
        self.text = text_body

    def _repr_html_(self):
        return self.html

    def __repr__(self):
        return self.text


def show_program(fn, *example_args, file=None, **example_kwargs):
    """Render what one call of ``fn(*example_args, **example_kwargs)``
    runs.

    The call runs once under ``torch.profiler`` (host and, on a CUDA
    ``config.device``, the card; ``record_shapes`` and ``with_flops``).
    The result has two sections: the hand-written kernels the call
    launched, each with its launches and source file, and the operator
    table (name, calls, self host and self device time, the FLOPs where
    torch counts them), by self device time, then self host time. In a
    notebook the returned object renders inline (``_repr_html_``); pass
    ``file=`` to write a standalone HTML page, or read ``.text``.
    """
    kernels = gp_kernel.kernels()
    before = {name: wrapper.launches
              for name, (wrapper, _, _) in kernels.items()}
    with torch.profiler.profile(activities=_activities(), record_shapes=True,
                                with_flops=True) as prof:
        fn(*example_args, **example_kwargs)
        _synchronize()
    launched = [(name, wrapper.launches - before[name], source)
                for name, (wrapper, source, _) in kernels.items()
                if wrapper.launches != before[name]]

    def device_us(event):
        us = getattr(event, "self_device_time_total", None)
        return event.self_cuda_time_total if us is None else us

    ops = sorted(prof.key_averages(),
                 key=lambda e: (-device_us(e), -e.self_cpu_time_total))
    columns = ("operator", "calls", "self host us", "self device us",
               "FLOPs")
    rows = [(e.key, e.count, e.self_cpu_time_total, device_us(e),
             getattr(e, "flops", 0) or 0) for e in ops]
    kernel_columns = ("kernel", "launches", "source")

    def table(head, body):
        cells = "".join(
            "<tr>" + "".join(
                "<td{}>{}</td>".format(
                    " style='text-align:left'" if i == 0 or
                    isinstance(v, str) else "",
                    html.escape(v) if isinstance(v, str)
                    else "{:,.0f}".format(v))
                for i, v in enumerate(row)) + "</tr>"
            for row in body)
        return ("<table><tr>" + "".join("<th>{}</th>".format(h)
                                        for h in head)
                + "</tr>" + cells + "</table>")

    html_doc = (
        _SHOW_PROGRAM_CSS + "<div class='slt-prog'>"
        + "<details open><summary>hand-written kernels launched"
          "</summary>" + table(kernel_columns, launched) + "</details>"
        + "<details open><summary>operators</summary>"
        + table(columns, rows) + "</details></div>")
    text = ("=== hand-written kernels launched ===\n{}\n\n"
            "=== operators ===\n{}\n".format(
                "\n".join("{}: {} launches ({})".format(*k)
                          for k in launched) or "none",
                "\n".join("{}: {} calls, self host {:.1f} us, self device "
                          "{:.1f} us, {} FLOPs".format(*row)
                          for row in rows)))
    if file is not None:
        with open(file, "w") as f:
            f.write("<!doctype html><meta charset='utf-8'>" + html_doc)
    return _Program(html_doc, text)


class NanCheckMode(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first operation whose floating
    output holds a NaN, naming the operation. :meth:`disable` leaves the
    mode and turns anomaly detection off."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.layout == torch.strided
                    and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    "NaN in the output of {}".format(func))
        return out

    def disable(self):
        """Leave the mode; anomaly detection off."""
        self.__exit__(None, None, None)
        torch.autograd.set_detect_anomaly(False)


def enable_nan_debugging():
    """Raise at the forward operation that makes a NaN, as
    ``jax_debug_nans`` does: enters a :class:`NanCheckMode` (each
    operation's outputs checked, which makes the host wait for the device
    at every operation) and turns on ``torch.autograd.set_detect_anomaly``
    for the backward pass. Returns the mode; its ``disable()`` ends both.
    """
    mode = NanCheckMode()
    mode.__enter__()
    torch.autograd.set_detect_anomaly(True)
    return mode
