"""A 'default'-geometry Interpolator grid of synthetic auto tables, made
from the seed.

Frozen copy of ``tabcorr_tpu_torch/utils/synthetic.py``'s
``synthetic_tabcorr`` and ``_default_grid`` at commit ebfe9da, with two
changes: the random parts are drawn on the device from the run's seed in
a few large calls (not numpy's generator on the host), and the nodes are
the published grid's (``log_eta`` = log10 of 4 points geometric in [1/3,
3], not the port's +-0.4).  Every node shares one binning: ``n_prim``
primary bins of log M in [11, 14.5] x ``n_sec`` secondary bins a galaxy
type; n_h = 10^-(0..4) x 1e-3 over a type's bins; a bin's
prim_haloprop_dist_index uniform in [-2, 2]; statistics' amplitudes
10^U(-5, 1) a row; each node's matrix the shared symmetric draw
U(0.2, 1) (symmetrised) times the row amplitude times (1 + 0.1 N(0, 1))
of its own, per stored element.
"""

from __future__ import annotations

import numpy as np
import torch


def columns(n_prim, n_sec, dist_index):
    n_half = n_prim * n_sec
    log_m = np.linspace(11.0, 14.5, n_prim + 1)
    sec = (np.arange(n_sec) + 0.5) / n_sec
    cols = {
        "n_h": np.tile(10.0 ** -np.linspace(0, 4, n_half), 2) * 1e-3,
        "log_prim_haloprop_min": np.tile(np.repeat(log_m[:-1], n_sec), 2),
        "log_prim_haloprop_max": np.tile(np.repeat(log_m[1:], n_sec), 2),
        "sec_haloprop_percentile_min": np.tile(
            np.tile(sec - 0.5 / n_sec, n_prim), 2),
        "sec_haloprop_percentile_max": np.tile(
            np.tile(sec + 0.5 / n_sec, n_prim), 2),
        "sec_haloprop_percentile": np.tile(np.tile(sec, n_prim), 2),
        "prim_haloprop_dist_index": dist_index,
        "gal_type": np.concatenate([np.repeat(b"centrals", n_half),
                                    np.repeat(b"satellites", n_half)]),
    }
    cols["prim_haloprop"] = 10.0 ** (0.5 * (cols["log_prim_haloprop_min"] +
                                            cols["log_prim_haloprop_max"]))
    return cols


def node_values(axes):
    """(n_nodes, n_keys) grid points in C order over the axes."""
    mesh = np.meshgrid(*[np.asarray(v, dtype=np.float64) for v in axes],
                       indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1)


def make(grid, generator, device):
    """``(columns, matrices (n_nodes, n_xi, n_pairs) float64, keys,
    values (n_nodes, n_keys))`` for the configuration's ``grid``."""
    n_prim, n_sec, n_xi = grid["n_prim"], grid["n_sec"], grid["n_xi"]
    keys = list(grid["axes"])
    values = node_values([grid["axes"][k] for k in keys])
    n_nodes = values.shape[0]
    n_bins = 2 * n_prim * n_sec
    n_pairs = n_bins * (n_bins + 1) // 2

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(
            shape, generator=generator, dtype=torch.float64, device=device)

    dist_index = uniform(-2.0, 2.0, (n_bins,))
    row_amp = 10.0 ** uniform(-5.0, 1.0, (n_xi,))
    base = uniform(0.2, 1.0, (n_xi, n_bins, n_bins))
    base = 0.5 * (base + base.transpose(1, 2))
    i, j = (torch.as_tensor(k, device=device)
            for k in np.tril_indices(n_bins))
    packed = (base * row_amp[:, None, None])[:, i, j]
    noise = torch.randn((n_nodes, n_xi, n_pairs), generator=generator,
                        dtype=torch.float64, device=device)
    matrices = packed[None] * (1.0 + 0.1 * noise)
    return (columns(n_prim, n_sec, dist_index.cpu().numpy()),
            matrices.cpu().numpy(), keys, values)
