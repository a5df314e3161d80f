"""The share of the profiled slice in which the device idled while the
host was innermost in the port's ``predictor`` span (of ``sampler.step``,
``logpost``, ``predictor``): ``benchlib.program_spans.idle_by_layer``."""

from benchlib.program_spans import idle_pct


def read(run):
    return idle_pct(run, "predictor")
