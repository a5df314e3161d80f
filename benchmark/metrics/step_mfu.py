"""The whole step's share of the card's peak: the algorithmic FLOP of one
ensemble step (two half-batch predictions and the chi^2 of every walker,
``benchlib.roofline``'s counts) over the mean step interval between the
window's CUDA events after the profiled slice, at 989 TFLOP/s."""

from benchlib.roofline import PEAK_FLOPS


def read(run):
    steps = run.untraced_step_ms()
    if not steps:
        return None
    step_s = sum(steps) / len(steps) / 1e3
    return 100.0 * run.step_flop / (step_s * PEAK_FLOPS)
