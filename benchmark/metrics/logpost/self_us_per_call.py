"""Host microseconds inside the log posterior
(``mcmc.make_gaussian_logpost_batched``'s function) a call, less its call
of the predictor (the benchmark's spans, after the profiled slice)."""


def read(run):
    count, _, own = run.span_summary().get("logpost", (0, 0, 0))
    return own / count / 1e3 if count else None
