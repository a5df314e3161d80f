"""``step_mfu`` for a cross-mode grid: the algorithmic FLOP of one ensemble
step (two half-batch predictions through the grid and the chi^2 of every
walker, ``benchlib.family_work``'s counts from the shapes of the one cell
this metric lists) over the mean step interval between the window's CUDA
events after the profiled slice, at 989 TFLOP/s."""

from benchlib import family_work
from benchlib.roofline import PEAK_FLOPS


def read(run):
    steps = run.untraced_step_ms()
    if not steps or not run.call_rows:
        return None
    s = family_work.cell_shapes("step_mfu_cross")
    flop = family_work.cross_grid_step_flop(
        2 * run.call_rows, s["n_bins"], s["n_gauss"], s["n_nodes"],
        s["n_xi"])
    step_s = sum(steps) / len(steps) / 1e3
    return 100.0 * flop / (step_s * PEAK_FLOPS)
