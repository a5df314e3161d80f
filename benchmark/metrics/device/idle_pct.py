"""The share of the profiled slice in which no device activity ran (one
minus the union of the trace's kernel and copy intervals over the
slice)."""

from benchlib.trace import busy_ns


def read(run):
    if not run.kernels or run.trace_window_ns is None:
        return None
    lo, hi = run.trace_window_ns
    return 100.0 * (1.0 - busy_ns(run.kernels, lo, hi) / (hi - lo))
