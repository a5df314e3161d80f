"""Legendre multipoles of xi(s, mu) (port of ``tabcorr_tpu/ops/multipole.py``).

Equivalent of halotools' ``tpcf_multipole`` (the reference uses it to
convert tabulated xi(s, mu) matrices to xi_0/2/4,
scripts/tabulate_snapshot.py:102-113):

    xi_ell(s) = (2 ell + 1)/2 * sum_j xi(s, mu_j)
                * [P_ell(mu_j) + P_ell(-mu_j)] dmu_j

with mu on [0, 1]: the integrand is mirrored to [-1, 1] exactly as
halotools does, so even orders pick up a factor 2 that cancels the 1/2
normalization and odd orders vanish identically (LOS symmetry).  The
weights are float64 numpy; a tensor input is weighted in its own dtype on
its own device.
"""

from __future__ import annotations

import copy

import numpy as np
import torch


def legendre(order, x):
    """Legendre polynomial P_order(x) for the orders used in RSD."""
    if order == 0:
        return (torch.ones_like(x) if isinstance(x, torch.Tensor) else
                np.ones_like(x))
    if order == 1:
        return x
    if order == 2:
        return 0.5 * (3 * x**2 - 1)
    if order == 3:
        return 0.5 * (5 * x**3 - 3 * x)
    if order == 4:
        return 0.125 * (35 * x**4 - 30 * x**2 + 3)
    if order == 6:
        return (231 * x**6 - 315 * x**4 + 105 * x**2 - 5) / 16.0
    raise ValueError(f"Legendre order {order} not implemented.")


def _multipole_weights(order, mu_bins):
    """Quadrature weights projecting xi(s, mu) on [0, 1] onto P_order:
    (2 order + 1)/2 * [P(mu) + P(-mu)] * dmu at the bin centres."""
    mu_bins = np.asarray(mu_bins, dtype=np.float64)
    mu_centers = 0.5 * (mu_bins[1:] + mu_bins[:-1])
    dmu = np.diff(mu_bins)
    return ((2 * order + 1) / 2.0 * dmu *
            (legendre(order, mu_centers) + legendre(order, -mu_centers)))


def tpcf_multipole(s_mu_tpcf_result, mu_bins, order=0):
    """Multipole of xi(s, mu) sampled on mu bins: (..., n_s, n_mu) ->
    (..., n_s), numpy or a tensor."""
    weights = _multipole_weights(order, mu_bins)
    if isinstance(s_mu_tpcf_result, torch.Tensor):
        w = torch.as_tensor(weights, dtype=s_mu_tpcf_result.dtype,
                            device=s_mu_tpcf_result.device)
        return torch.sum(s_mu_tpcf_result * w, dim=-1)
    return np.sum(np.asarray(s_mu_tpcf_result) * weights, axis=-1)


def tabcorr_s_mu_to_multipole(halotab_s_mu, mu_bins, order):
    """A tabulated xi(s, mu) TabCorr as a multipole TabCorr: every
    bin-pair column of the matrix projected onto P_order in one einsum
    (reference pipeline: scripts/tabulate_snapshot.py:102-113)."""
    halotab = copy.deepcopy(halotab_s_mu)
    n_s, n_mu = halotab_s_mu.tpcf_shape
    matrix = halotab_s_mu.tpcf_matrix.reshape(
        n_s, n_mu, halotab_s_mu.tpcf_matrix.shape[1])
    weights = _multipole_weights(order, mu_bins)
    halotab.tpcf_matrix = np.einsum("smp,m->sp", matrix, weights)
    halotab.tpcf_shape = (n_s,)
    halotab.clear_caches()
    return halotab
