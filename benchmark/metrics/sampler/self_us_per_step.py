"""Host microseconds inside ``mcmc.ensemble_step`` a step, less its calls
of the log posterior (the benchmark's spans, after the profiled slice)."""


def read(run):
    count, _, own = run.span_summary().get("sampler", (0, 0, 0))
    return own / count / 1e3 if count else None
