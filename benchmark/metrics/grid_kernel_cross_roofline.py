"""``grid_kernel``'s (csrc/grid.cu, B2) share of its roofline on a
cross-mode grid with its densities in (model code 2): the least time of
one predictor call's contraction (``benchlib.family_work``'s counts, from
the shapes of the one cell this metric lists, at 989 TFLOP/s and 3.35
TB/s) over the kernel's mean device time a launch in the trace, each
launch one call of ``run.call_rows`` rows.  ``grid_kernel_roofline``
counts a grid of auto tables with its occupation inside the kernel."""

from benchlib import family_work
from benchlib.roofline import share_pct
from benchlib.trace import kernel_times_ns


def read(run):
    times = kernel_times_ns(run.kernels, "grid_kernel")
    if not times or not run.call_rows:
        return None
    s = family_work.cell_shapes("grid_kernel_cross_roofline")
    rows = run.call_rows
    flop = rows * family_work.cross_contraction_flop(
        s["n_bins"], s["n_nodes"], s["n_xi"])
    n_bytes = family_work.cross_contraction_bytes(
        rows, s["n_bins"], s["n_nodes"], s["n_xi"])
    return share_pct(flop, n_bytes, sum(times) / len(times) / 1e9)
