"""``occupation_kernel``'s (csrc/occupation.cu) share of its roofline: the
least time of one predictor call's occupation (``benchlib.family_work``'s
counts, from the shapes of the one cell this metric lists, at 989 TFLOP/s
and 3.35 TB/s) over the kernel's mean device time a launch in the trace,
each launch one call of ``run.call_rows`` rows."""

from benchlib import family_work
from benchlib.roofline import share_pct
from benchlib.trace import kernel_times_ns


def read(run):
    times = kernel_times_ns(run.kernels, "occupation_kernel")
    if not times or not run.call_rows:
        return None
    s = family_work.cell_shapes("occupation_kernel_roofline")
    flop = family_work.occupation_flop(run.call_rows, s["n_bins"],
                                       s["n_gauss"])
    n_bytes = family_work.occupation_bytes(run.call_rows, s["n_bins"],
                                           s["n_gauss"], s["n_params"])
    return share_pct(flop, n_bytes, sum(times) / len(times) / 1e9)
