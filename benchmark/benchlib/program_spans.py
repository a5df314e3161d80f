"""The port's own spans in a traced run's profiled slice, and the slice's
idle device time split by the layer the host was in.

The port records its spans (``tabcorr_tpu_torch.utils.profiling``) while
the profiler records, stamped with ``time.time_ns()``: the clock of the
profiler's device events and of ``Run.trace_window_ns``, so they are set
beside the kernels as they are.  A port that records none (one older than
its spans) gives none here, and every reader of them returns None.
"""

from __future__ import annotations

from .trace import idle_gaps

# The layers the idle time is split over, outermost first.
LAYERS = ("sampler.step", "logpost", "predictor")


def in_slice(run):
    """The port's spans that lie inside the profiled slice, or []."""
    if run.trace_window_ns is None:
        return []
    from tabcorr_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return []
    lo, hi = run.trace_window_ns
    return [s for s in recorded() if lo <= s.start_ns and s.end_ns <= hi]


def _ancestors(spans):
    """``span -> [its ancestors' names]`` by the spans' parent ids."""
    by_id = {s.id: s for s in spans}

    def names(s):
        out, p = [], by_id.get(s.parent)
        while p is not None:
            out.append(p.name)
            p = by_id.get(p.parent)
        return out

    return names


def calls(spans, name):
    """The spans of ``name`` not inside another of the same name (a
    member's predictor inside a joint one is one call, not two)."""
    ancestors = _ancestors(spans)
    return [s for s in spans if s.name == name and name not in ancestors(s)]


def under(spans, name):
    """The spans with an ancestor named ``name``."""
    ancestors = _ancestors(spans)
    return [s for s in spans if name in ancestors(s)]


def innermost(spans, names=LAYERS):
    """Disjoint ``(name, start, end)`` pieces of the host's timeline, each
    named by the innermost span of ``names`` open there (the spans of one
    thread nest)."""
    pieces, stack, t = [], [], None
    for s in sorted((s for s in spans if s.name in names),
                    key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            top = stack.pop()
            pieces.append((top.name, t, top.end_ns))
            t = top.end_ns
        if stack:
            pieces.append((stack[-1].name, t, s.start_ns))
        stack.append(s)
        t = s.start_ns
    while stack:
        top = stack.pop()
        pieces.append((top.name, t, top.end_ns))
        t = top.end_ns
    return [p for p in pieces if p[2] > p[1]]


def idle_by_layer(run):
    """``{layer: idle ns}`` over the profiled slice: each idle nanosecond
    (``trace.idle_gaps``) to the innermost of :data:`LAYERS` open on the
    host then, and to None where none is (the benchmark's own loop); the
    values sum to the slice's idle time.  None without device events or
    without the port's spans."""
    spans = in_slice(run)
    if not run.kernels or not spans:
        return None
    lo, hi = run.trace_window_ns
    gaps = idle_gaps(run.kernels, lo, hi)
    out = dict.fromkeys(LAYERS + (None,), 0)
    out[None] = sum(e - s for s, e in gaps)
    first = 0
    for name, s, e in innermost(spans):   # both in time order, disjoint
        while first < len(gaps) and gaps[first][1] <= s:
            first += 1
        for g0, g1 in gaps[first:]:
            if g0 >= e:
                break
            overlap = min(e, g1) - max(s, g0)
            out[name] += overlap
            out[None] -= overlap
    return out


def idle_pct(run, layer):
    """The share of the slice (%) in which the device idled while the
    host was innermost in ``layer``; None as :func:`idle_by_layer`."""
    idle = idle_by_layer(run)
    if idle is None:
        return None
    lo, hi = run.trace_window_ns
    return 100.0 * idle[layer] / (hi - lo)


def per_call_us(run, match):
    """Microseconds of the spans ``match`` accepts, a ``predictor`` call;
    None without predictor calls or without such spans."""
    spans = in_slice(run)
    n_calls = len(calls(spans, "predictor"))
    if not n_calls or not any(match(s.name) for s in spans):
        return None
    return sum(s.end_ns - s.start_ns for s in spans
               if match(s.name)) / n_calls / 1e3
