"""Host microseconds of one predictor call: the enqueue of its tensor ops,
the kernel's launch through ctypes and, for a grid, the spline's node
weights (the benchmark's spans, after the profiled slice)."""


def read(run):
    count, total, _ = run.span_summary().get("predictor", (0, 0, 0))
    return total / count / 1e3 if count else None
