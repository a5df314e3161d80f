"""Device nanoseconds of ``occupation_kernel`` (csrc/occupation.cu) a
distinct abscissa of a row: the kernel's device time in the profiled slice
over the ``rows`` x ``abscissae`` the port counts in its
``fused.occupation_launch`` spans there (one SHMR evaluation with its
decoration and quadrature terms; comparable across batch sizes)."""

from benchlib.program_spans import in_slice
from benchlib.trace import kernel_times_ns


def read(run):
    times = kernel_times_ns(run.kernels, "occupation_kernel")
    work = sum(s.counts.get("rows", 0) * s.counts.get("abscissae", 0)
               for s in in_slice(run) if s.name == "fused.occupation_launch")
    if not times or not work:
        return None
    return sum(times) / work
