"""The yardstick of a cross-mode grid with its occupation in a kernel of its
own: the work counted from shapes.

Frozen.  The convention is ``roofline``'s: the algorithm's work from the
shapes, whatever kernel computes it; one multiply-add a quadrature node,
the occupation functions themselves not counted; bytes each input read
once and each output written once, in float32.  ``cell.work_of`` counts
every grid as a grid of auto tables (``roofline.grid_flop``: the
n_bins (n_bins + 1) / 2 pairs of a symmetric table), which over-counts a
cross table's row by ~460x at 1104 bins; these counts are for cross-mode
grids and are what the shares of a cross cell read.

``Run`` carries no shapes, so :func:`cell_shapes` reads them from the
table file of the configuration of the one cell a metric's entry lists.
"""

from __future__ import annotations

import numpy as np

from .manifest import ROOT, Manifest
from .roofline import FLOAT, chi2_flop, quadrature_flop


def occupation_flop(rows, n_bins, n_gauss):
    """One occupation launch: the quadrature's multiply-add a (bin, node)
    of every row."""
    return rows * quadrature_flop(n_bins, n_gauss)


def occupation_bytes(rows, n_bins, n_gauss, n_params):
    """One occupation launch: the (n_params, rows) parameters and the
    quadrature's nodes, node residuals and weights read once, the (n_bins,
    rows) densities written once."""
    return FLOAT * (rows * n_params + 3 * n_bins * n_gauss + rows * n_bins)


def cross_contraction_flop(n_bins, n_nodes, n_xi):
    """One row of a cross-mode grid from its densities: their sum, every
    node's matrix-vector product and the fold of the nodes' statistics by
    the node weights."""
    return n_bins + 2 * n_nodes * n_xi * (n_bins + 1)


def cross_contraction_bytes(rows, n_bins, n_nodes, n_xi):
    """One densities-in launch on a cross-mode grid: the (n_bins, rows)
    densities, every node's (n_xi, n_bins) matrix and the (rows, n_nodes)
    node weights read once, each row's ngal and n_xi statistics written
    once."""
    return FLOAT * (rows * n_bins + n_nodes * n_xi * n_bins +
                    rows * n_nodes + rows * (1 + n_xi))


def cross_grid_row_flop(n_bins, n_gauss, n_nodes, n_xi):
    """One row's prediction through a cross-mode grid: the quadrature and
    the contraction (:func:`cross_contraction_flop`)."""
    return (quadrature_flop(n_bins, n_gauss) +
            cross_contraction_flop(n_bins, n_nodes, n_xi))


def cross_grid_step_flop(walkers, n_bins, n_gauss, n_nodes, n_xi):
    """One ensemble step: every walker's prediction and its chi^2 with a
    dense inverse covariance."""
    return walkers * (cross_grid_row_flop(n_bins, n_gauss, n_nodes, n_xi) +
                      chi2_flop(n_xi))


def cell_shapes(metric):
    """``dict(n_bins, n_gauss, n_params, n_nodes, n_xi)`` of the one cell
    the per-layer entry ``metric`` lists: from its configuration's
    Interpolator file (the bins, the statistic's rows and the nodes),
    ``n_gauss`` and the occupation's parameters (the fiducial point's less
    the grid's keys)."""
    manifest = Manifest()
    entry = next(m for m in manifest.data["per_layer"]
                 if m["name"] == metric)
    cell, = entry["workloads"]
    config = manifest.cell(cell).config
    with np.load(ROOT / config["tables"][0]["file"],
                 allow_pickle=False) as d:
        keys = d["param_dict_table"].dtype.names
        n_nodes = len(d["param_dict_table"])
        n_xi, n_bins = d["tabcorr_0.tpcf_matrix"].shape
    return dict(n_bins=int(n_bins), n_gauss=int(config["n_gauss"]),
                n_params=len(set(config["fiducial"]) - set(keys)),
                n_nodes=int(n_nodes), n_xi=int(n_xi))
