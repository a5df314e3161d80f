"""Host microseconds of the port's kernel launches a predictor call: the
``fused.*`` spans (each ``ops.fused`` launch function: its checks, its
pointer lists and the ctypes call) over the ``predictor`` calls, in the
profiled slice."""

from benchlib.program_spans import per_call_us


def read(run):
    return per_call_us(run, lambda name: name.startswith("fused."))
