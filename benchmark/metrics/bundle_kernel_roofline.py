"""``bundle_kernel``'s (csrc/bundle.cu, B1) share of its roofline: the
least time of one predictor call's work (``benchlib.roofline``'s counts
from the shapes, at 989 TFLOP/s and 3.35 TB/s) over the kernel's mean
device time a launch in the trace."""

from benchlib.roofline import kernel_share


def read(run):
    return kernel_share(run, "bundle_kernel")
