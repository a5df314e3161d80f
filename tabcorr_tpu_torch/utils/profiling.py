"""Timing and device-trace hooks.

Port of ``tabcorr_tpu/utils/profiling.py``: wall-clock phase timers
(collected, not just printed) and a context manager around
``torch.profiler`` that writes a Chrome trace (open it in Perfetto or
``chrome://tracing``).

The port's own spans: :func:`span` and :func:`spanned` mark the layer
boundaries of the hot path (the sampler step, the log posterior, the
predictor, each kernel launch of ``ops.fused``).  They record only while a
``torch.profiler`` session records (:func:`device_trace`, or any other
profiler the caller starts); otherwise a span site costs one flag check.
A recorded :class:`Span` is stamped with ``time.time_ns()``, the clock on
which the profiler stamps its host and device events, and kept in a
bounded in-memory ring that :func:`recorded` reads.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import logging
import os
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

from .device import resolve_device

logger = logging.getLogger("tabcorr_tpu_torch")


class Timer:
    """Collects named wall-clock phase timings.

    >>> timer = Timer()
    >>> with timer("pair counting"):
    ...     do_work()
    >>> timer.summary()

    Work queued on a CUDA device is timed only as far as the host waits
    for it: end a timed block with ``torch.cuda.synchronize()`` to time
    the device's work.
    """

    def __init__(self):
        self.records: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def __call__(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.records.append((name, elapsed))
            logger.debug("%s: %.3f s", name, elapsed)

    def total(self, name=None):
        return sum(t for n, t in self.records
                   if name is None or n == name)

    def summary(self):
        lines = [f"  {name}: {elapsed:.3f} s"
                 for name, elapsed in self.records]
        return "\n".join(lines)


# The most spans kept: the oldest go first.
RING_SPANS = 2 ** 20
_RING = collections.deque(maxlen=RING_SPANS)
_IDS = itertools.count(1)
_THREAD = threading.local()


class Span:
    """One recorded span: ``name``, its own ``id``, the ``parent`` span's
    id (None at the top of its thread), ``start_ns`` and ``end_ns`` on
    ``time.time_ns()``, and ``counts``, a dict of integer counts of the
    work inside it (``rows``, ``syncs``)."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "counts")

    def __init__(self, name, counts):
        self.name = name
        self.counts = counts
        self.id = next(_IDS)

    def __enter__(self):
        stack = getattr(_THREAD, "stack", None)
        if stack is None:
            stack = _THREAD.stack = []
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _THREAD.stack.pop()
        _RING.append(self)
        return False


class _Off:
    """The span site's stand-in while no profiler records: enters and
    exits doing nothing, and is false (so a site computes a count only
    for a recorded span)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


_OFF = _Off()


def span(name, **counts):
    """A span named ``name`` around a ``with`` block, with the integer
    ``counts`` given (more may be set in its ``counts`` dict inside the
    block).  Recorded only while a ``torch.profiler`` session records;
    otherwise a shared no-op, false in a test."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, counts)


def spanned(name):
    """Decorator: every call of the function inside ``span(name)``."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with Span(name, {}):
                return fn(*args, **kwargs)
        return call
    return decorate


def recorded():
    """The recorded spans, oldest first by end (at most
    :data:`RING_SPANS`; filter them by time)."""
    return list(_RING)


def _add_spans(trace_path, start_ns, end_ns):
    """Append the spans recorded within [start_ns, end_ns] to the Chrome
    trace at ``trace_path`` as complete events on the profiler's timeline
    (its ``ts`` are microseconds after ``baseTimeNanoseconds``), in a row
    of their own."""
    with open(trace_path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    row = {"pid": "tabcorr_tpu_torch spans", "tid": "spans"}
    events = trace.setdefault("traceEvents", [])
    events.append(dict(row, ph="M", name="process_name",
                       args={"name": "tabcorr_tpu_torch spans"}))
    for s in recorded():
        if start_ns <= s.start_ns and s.end_ns <= end_ns:
            events.append(dict(
                row, ph="X", cat="tabcorr_tpu_torch", name=s.name,
                ts=(s.start_ns - base) / 1e3,
                dur=(s.end_ns - s.start_ns) / 1e3,
                args=dict(s.counts, id=s.id, parent=s.parent)))
    with open(trace_path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(log_dir, *, device="cuda"):
    """Profile a code block with ``torch.profiler`` and write its Chrome
    trace into ``log_dir`` (created if missing).

    Records CPU activity, and on a CUDA ``device`` (the default; 'cpu'
    for a run on the CPU) the card's kernels too, synchronising the
    device before the trace ends.  Yields the ``torch.profiler.profile``
    object (``key_averages()`` sums time by operator and kernel); the
    trace's path is its ``trace_path`` attribute after the block.  The
    port's spans recorded in the block (:func:`span`) are in the trace
    too, as a row of their own named ``tabcorr_tpu_torch spans``.
    """
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    start_ns = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    prof.trace_path = log_dir / (
        f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.pt.trace.json")
    end_ns = time.time_ns()
    prof.export_chrome_trace(str(prof.trace_path))
    _add_spans(prof.trace_path, start_ns, end_ns)
