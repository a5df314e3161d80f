"""Host spans around the calls into each layer, and their self times.

A span is ``(name, start_ns, end_ns)`` on ``time.perf_counter_ns``.  The
benchmark wraps the callables it hands to the program (the predictor
handed to the log posterior, the log posterior handed to the sampler) and
its own call of the sampler, so the spans nest: sampler > log posterior >
predictor.  A layer's self time is its span's duration less the part its
child spans cover.
"""

from __future__ import annotations

import time
from collections import defaultdict


class Spans:
    """Spans kept in memory while ``on``; nothing is recorded when off."""

    def __init__(self):
        self.records = []
        self.on = False

    def wrap(self, name, fn):
        records = self.records
        clock = time.perf_counter_ns

        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            start = clock()
            try:
                return fn(*args, **kwargs)
            finally:
                records.append((name, start, clock()))

        return wrapped


def self_times(records):
    """Per span, its duration less what its direct children cover.

    ``records`` are ``(name, start, end)`` of properly nested spans.
    Returns ``[(name, start, end, self_ns), ...]`` in start order.
    """
    order = sorted(records, key=lambda r: (r[1], -r[2]))
    out = [[name, s, e, e - s] for name, s, e in order]
    stack = []
    for k, (_, s, e, _) in enumerate(out):
        while stack and out[stack[-1]][2] <= s:
            stack.pop()
        if stack and e <= out[stack[-1]][2]:
            out[stack[-1]][3] -= e - s
        stack.append(k)
    return [tuple(r) for r in out]


def summary(records):
    """``{name: (count, total_ns, self_ns)}`` over ``records``."""
    acc = defaultdict(lambda: [0, 0, 0])
    for name, s, e, own in self_times(records):
        a = acc[name]
        a[0] += 1
        a[1] += e - s
        a[2] += own
    return {k: tuple(v) for k, v in acc.items()}


def innermost(records, t_ns):
    """The name of the innermost span open at ``t_ns``, or None."""
    best = None
    for name, s, e in records:
        if s <= t_ns < e and (best is None or s >= best[1]):
            best = (name, s)
    return None if best is None else best[0]
