"""The measured window and the arithmetic of its end-to-end metrics.

The window issues steps back to back with no synchronisation: after each
step it records one CUDA event and keeps the step's accept fraction on the
device.  It starts after a synchronisation, with the host clock and a start
event, stops issuing once ``seconds`` have passed on the host clock, and
ends after a final synchronisation.  The rate is taken over all the work
and all the time of the window; the tail over every step of it.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU (tests only)."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event_type(device):
    return torch.cuda.Event if device.type == "cuda" else HostEvent


class Window:
    """What one window measured."""

    def __init__(self, seconds, steps, step_ms, accepts, traced_steps):
        self.seconds = seconds
        self.steps = steps
        self.step_ms = step_ms
        self.accepts = accepts
        self.traced_steps = traced_steps


def run_window(step, seconds, device, tracer=None):
    """Issue ``step()`` (which returns the step's accept fraction, a device
    scalar) until ``seconds`` have passed, then synchronise.

    With a ``tracer``, the profiler runs over the window's first steps, up
    to ``tracer.max_steps`` or ``tracer.max_seconds``; it synchronises at
    both ends of that slice, which only a traced run pays.
    """
    event = event_type(device)
    synchronize(device)
    start = event(enable_timing=True)
    events, accepts = [], []
    traced = (0, 0)
    clock = time.perf_counter
    t0 = clock()
    start.record()
    if tracer is not None:
        tracer.start()
    tracing = tracer is not None
    while True:
        accepts.append(step())
        ev = event(enable_timing=True)
        ev.record()
        events.append(ev)
        now = clock() - t0
        if tracing and (len(events) >= tracer.max_steps or
                        now >= tracer.max_seconds):
            tracer.stop()
            tracing = False
            traced = (0, len(events))
        if now >= seconds:
            break
    if tracing:
        tracer.stop()
        traced = (0, len(events))
    synchronize(device)
    elapsed = clock() - t0
    step_ms = [start.elapsed_time(events[0])] + [
        events[i - 1].elapsed_time(events[i]) for i in range(1, len(events))]
    return Window(elapsed, len(events), step_ms,
                  torch.stack(accepts).double().cpu().numpy(), traced)


def rate(items_per_step, steps, seconds):
    """Items completed per second over the whole window."""
    return items_per_step * steps / seconds


def p95(values):
    """The 95th percentile (linear interpolation) of every value."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))
