"""Synthetic tabulations and the 64-node Interpolator grids, numpy only.

Both grids have the published 'default' database geometry (reference:
tabcorr/database.py:56-59): 4 x 4 x 4 = 64 nodes over (alpha_c, alpha_s,
log_eta) and xi_0/2/4 x 14 separation bins = 42 rows per node.

* :func:`grid64_interpolator`: 30 primary-property bins x 2 galaxy types
  = 60 halo bins.  It draws the same random numbers in the same order as
  the JAX package's benchmark builder
  (``scripts/bench_grid.py:build_interpolator`` with
  ``tests/test_bundle_shapes.py:synthetic_tabcorr``), so both packages
  hold the same tables array for array.
* :func:`wide_grid_interpolator`: the published assembly-bias split (2
  secondary-percentile bins) with a finer mass binning, 40 primary bins x
  2 x 2 = 160 halo bins: too wide for the packed grid layout (more than
  127 bins), so the fused engine runs the slab kernel.  Same draws, in
  the same order, with ``n_sec=2``.
"""

from __future__ import annotations

import numpy as np

from ..interpolator import Interpolator
from ..io import ColumnTable
from ..table import TabCorr
from .packing import packed_index_arrays


def synthetic_tabcorr(rng, n_prim, n_sec, n_xi, mode):
    """A structurally valid TabCorr with random contents: ``n_prim`` x
    ``n_sec`` bins per galaxy type, row amplitudes over ~6 decades, and
    positive-dominant symmetric matrices."""
    n_half = n_prim * n_sec
    n_bins = 2 * n_half
    log_m = np.linspace(11.0, 14.5, n_prim + 1)
    gal_type = ColumnTable()
    gal_type["n_h"] = np.tile(10.0 ** -np.linspace(0, 4, n_half), 2) * 1e-3
    gal_type["log_prim_haloprop_min"] = np.tile(
        np.repeat(log_m[:-1], n_sec), 2)
    gal_type["log_prim_haloprop_max"] = np.tile(
        np.repeat(log_m[1:], n_sec), 2)
    sec = (np.arange(n_sec) + 0.5) / n_sec
    gal_type["sec_haloprop_percentile_min"] = np.tile(
        np.tile(sec - 0.5 / n_sec, n_prim), 2)
    gal_type["sec_haloprop_percentile_max"] = np.tile(
        np.tile(sec + 0.5 / n_sec, n_prim), 2)
    gal_type["sec_haloprop_percentile"] = np.tile(np.tile(sec, n_prim), 2)
    gal_type["prim_haloprop"] = 10.0 ** (
        0.5 * (gal_type["log_prim_haloprop_min"] +
               gal_type["log_prim_haloprop_max"]))
    gal_type["prim_haloprop_dist_index"] = rng.uniform(-2, 2, n_bins)
    gal_type["gal_type"] = np.concatenate(
        [np.repeat(b"centrals", n_half), np.repeat(b"satellites", n_half)])

    row_amp = 10.0 ** rng.uniform(-5, 1, n_xi)
    if mode == "auto":
        base = rng.uniform(0.2, 1.0, (n_xi, n_bins, n_bins))
        base = 0.5 * (base + np.transpose(base, (0, 2, 1)))
        dense = base * row_amp[:, None, None]
        idx_i, idx_j = packed_index_arrays(n_bins)
        matrix = dense[:, idx_i, idx_j]
    else:
        matrix = rng.uniform(0.2, 1.0, (n_xi, n_bins)) * row_amp[:, None]

    halotab = TabCorr()
    halotab.gal_type = gal_type
    halotab.attrs = {"mode": mode, "tpcf": "synthetic", "redshift": 0.0,
                     "simname": "prop", "Num_ptcl_requirement": 300,
                     "prim_haloprop_key": "halo_mvir",
                     "sec_haloprop_key": "halo_nfw_conc"}
    halotab.tpcf_shape = (n_xi,)
    halotab.tpcf_matrix = matrix
    return halotab


def grid64_interpolator(n_nodes=64, n_prim=30, n_xi=42, seed=42):
    """The 64-node 'default'-geometry grid of 60 halo bins."""
    return _default_grid(n_nodes, n_prim, 1, n_xi, seed)


def wide_grid_interpolator(n_nodes=64, n_prim=40, n_sec=2, n_xi=42,
                           seed=42):
    """The 64-node 'default'-geometry grid of 160 halo bins (assembly-bias
    secondary-percentile midpoints 0.25 and 0.75)."""
    return _default_grid(n_nodes, n_prim, n_sec, n_xi, seed)


def _default_grid(n_nodes, n_prim, n_sec, n_xi, seed):
    """Every node's table is the same draw (seed ``seed``) times
    node-dependent noise (seed 1000 + node); statistics shaped (3,
    n_xi // 3); nodes on the 'default' geometry's cube."""
    tabs = []
    for j in range(n_nodes):
        t = synthetic_tabcorr(np.random.default_rng(seed), n_prim, n_sec,
                              n_xi, "auto")
        r2 = np.random.default_rng(1000 + j)
        t.tpcf_matrix = t.tpcf_matrix * (
            1.0 + 0.1 * r2.normal(size=t.tpcf_matrix.shape))
        t.tpcf_shape = (3, n_xi // 3)
        tabs.append(t)
    side = round(n_nodes ** (1 / 3))
    ac, as_, le = np.meshgrid(np.linspace(0, .4, side),
                              np.linspace(.8, 1.2, side),
                              np.linspace(-.4, .4, side), indexing="ij")
    table = ColumnTable()
    table["alpha_c"] = ac.ravel()
    table["alpha_s"] = as_.ravel()
    table["log_eta"] = le.ravel()
    return Interpolator(tabs, table)
