"""Host microseconds of the grid spline's node weights a predictor call:
the port's ``predictor.node_weights`` spans over its ``predictor`` calls,
in the profiled slice (a fused Interpolator's; none elsewhere)."""

from benchlib.program_spans import per_call_us


def read(run):
    return per_call_us(run, lambda name: name == "predictor.node_weights")
