"""The yardstick of the rooflines: peaks, and the work counted from shapes.

Frozen copies.  ``contraction_flop`` and ``quadrature_flop`` are copied
from ``chip_smoke.py:518-533`` and the grid's count from
``chip_smoke.py:879-882`` at commit ebfe9da.  They count the algorithm's
work from the shapes, whatever kernel computes it: the symmetric half of
an auto table, one multiply-add a quadrature node, and for a grid every
node's contraction and the fold of the nodes; the occupation functions
are not counted.  Bytes are each input read once and each output written
once, in float32, from the shapes (not from any layout of the program).

Every share divides by the card's dense BF16 tensor peak, whatever pipe
a kernel uses today: no format that can meet these float32 contracts runs
faster, so no honest kernel reads over 100%.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at the 700 W limit.
PEAK_FLOPS = 989e12        # BF16 / FP16 tensor cores
PEAK_BYTES = 3.35e12       # HBM3
FLOAT = 4                  # bytes of a float32


def npair(n_bins):
    return n_bins * (n_bins + 1) // 2


def contraction_flop(n_bins, n_xi, auto):
    """FP32 operations of one row's statistics from its densities, at the
    least: the symmetric form over the n_bins (n_bins + 1) / 2 pairs (one
    product for each pair's weight, one multiply-add per pair and row of
    the statistic) in auto mode, the matrix-vector product in cross
    mode."""
    if not auto:
        return 2 * n_xi * n_bins
    n = npair(n_bins)
    return n + 2 * n_xi * n


def quadrature_flop(n_bins, n_gauss):
    """One row's quadrature sums (a multiply-add per node); the occupation
    functions themselves are not counted."""
    return 2 * n_bins * n_gauss


def grid_flop(n_bins, n_gauss, n_nodes, n_xi):
    """One row of a grid of auto tables sharing one binning: the
    quadrature, the pair weights, and every node's contraction with the
    fold of its statistics by the node weights."""
    n = npair(n_bins)
    return (quadrature_flop(n_bins, n_gauss) + n +
            2 * n_nodes * n_xi * (n + 1))


def table_bytes(n_bins, n_gauss, n_xi, auto, n_nodes=1):
    """A table's inputs: the stored matrix (the symmetric half in auto
    mode), the quadrature's nodes, node residuals and weights, and the
    bins' densities and secondary percentiles."""
    matrix = n_nodes * n_xi * (npair(n_bins) if auto else n_bins)
    return FLOAT * (matrix + 3 * n_bins * n_gauss + 2 * n_bins)


def chi2_flop(n_data):
    """One row's chi^2 with a dense inverse covariance: the residual, its
    product with the matrix, and the dot product."""
    return 2 * n_data * n_data + 3 * n_data


def bound_s(flop, n_bytes):
    """The least time the card could take."""
    return max(flop / PEAK_FLOPS, n_bytes / PEAK_BYTES)


def share_pct(flop, n_bytes, seconds):
    """The roofline share of work that took ``seconds``."""
    return 100.0 * bound_s(flop, n_bytes) / seconds


def kernel_share(run, kernel):
    """The roofline share of ``kernel``'s launches in a traced run, each
    launch one predictor call of ``run.call_rows`` rows; None where the
    trace holds no launch of it."""
    from .trace import kernel_times_ns
    times = kernel_times_ns(run.kernels, kernel)
    if not times:
        return None
    flop, n_bytes = run.call_work(run.call_rows)
    return share_pct(flop, n_bytes, sum(times) / len(times) / 1e9)
