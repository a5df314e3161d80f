"""Tensor prediction path: occupation quadrature and contraction.

The reference's hot loop (reference: tabcorr/tabcorr.py:580-683) is: mean
occupation per halo bin -> per-bin galaxy density ``n`` -> packed pair
weights -> contraction.  Because the packed weights sum to
``(sum_i n_i)^2`` and the packed contraction equals the dense quadratic
form over the unpacked symmetric matrix ``F``, auto-mode prediction is

    xi_k = n^T F_k n / (sum_i n_i)^2

and cross mode is ``xi = F n / sum(n)``.  The functions here are
batch-native: a leading batch axis on the parameters and occupations
broadcasts through.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import numpy_dtype, resolve_device

AUTO = "auto"

_FIELDS = ("tpcf_dense", "n_h", "log_prim_quad", "quad_weight", "sec_perc",
           "log_prim_quad_lo")


@dataclasses.dataclass(frozen=True)
class TableData:
    """A tabulation as tensors on one device.

    Attributes
    ----------
    tpcf_dense : (n_xi, n_bins, n_bins) in auto mode, (n_xi, n_bins) in
        cross mode. The unpacked correlation-function matrix.
    n_h : (n_bins,) halo number density per bin.
    log_prim_quad : (n_bins, n_gauss) log10 primary halo property at the
        Gauss-Legendre nodes of each bin.
    quad_weight : (n_bins, n_gauss) normalized quadrature weights including
        the per-bin M^(n+1) measure; rows sum to 1.
    sec_perc : (n_bins,) secondary-property percentile midpoint per bin.
    mode : 'auto' or 'cross'.
    tpcf_shape : tuple of Python ints, shape of one statistic.
    n_centrals : number of leading central bins; bins are ordered
        [centrals..., satellites...].
    log_prim_quad_lo : (n_bins, n_gauss) or None.  Residual of the float64
        nodes after rounding ``log_prim_quad`` to float32; occupations
        absorb it (see :func:`occupation_with_residual`).  None in float64.
    """

    tpcf_dense: torch.Tensor
    n_h: torch.Tensor
    log_prim_quad: torch.Tensor
    quad_weight: torch.Tensor
    sec_perc: torch.Tensor
    mode: str
    tpcf_shape: tuple
    n_centrals: int
    log_prim_quad_lo: torch.Tensor | None = None

    @property
    def n_bins(self):
        return self.n_h.shape[0]

    @classmethod
    def from_numpy(cls, arrays, mode, tpcf_shape, n_centrals, device, dtype):
        """Build from numpy arrays keyed by field name.

        ``arrays`` maps ``tpcf_dense``, ``n_h``, ``log_prim_quad``,
        ``quad_weight``, ``sec_perc`` and optionally ``log_prim_quad_lo``
        (None or absent in float64) to arrays; each is converted to
        ``dtype`` on the host and copied to ``device``.
        """
        device = resolve_device(device)
        np_dtype = numpy_dtype(dtype)

        def tensor(a):
            if a is None:
                return None
            return torch.tensor(np.asarray(a, dtype=np_dtype), device=device)

        return cls(**{f: tensor(arrays.get(f)) for f in _FIELDS},
                   mode=mode,
                   tpcf_shape=tuple(int(s) for s in tpcf_shape),
                   n_centrals=int(n_centrals))


def quadrature_grid(log_prim_min, log_prim_max, dist_index, n_gauss):
    """Host-side (float64) Gauss-Legendre nodes and weights per bin.

    Nodes at ``logmin + d * x`` with x in (0, 1) and weights
    ``w * M^(n+1)`` normalized per bin (reference: tabcorr/tabcorr.py:
    543-578).  Masses are scaled by the bin minimum before exponentiation.
    """
    log_prim_min = np.asarray(log_prim_min, dtype=np.float64)
    log_prim_max = np.asarray(log_prim_max, dtype=np.float64)
    x, w = np.polynomial.legendre.leggauss(n_gauss)
    x = (x + 1.0) / 2.0
    d = (log_prim_max - log_prim_min)[:, None]
    log_quad = log_prim_min[:, None] + d * x
    n = np.asarray(dist_index, dtype=np.float64)[:, None] + 1.0
    measure = w * 10.0 ** (n * (log_quad - log_prim_min[:, None]))
    weight = measure / np.sum(measure, axis=-1, keepdims=True)
    return log_quad, weight


def occupation_with_residual(occ_fn, params, log_prim, log_prim_res, sec):
    """Occupation at the double-float node ``log_prim + log_prim_res``.

    Uses the callable's exact-absorption form (``occ_fn.with_residual``)
    when present, else a first-order forward-mode correction.
    """
    with_res = getattr(occ_fn, "with_residual", None)
    if with_res is not None:
        return with_res(params, log_prim, log_prim_res, sec)
    occ, d = torch.func.jvp(lambda l: occ_fn(params, l, sec),
                            (log_prim,), (log_prim_res,))
    return occ + d


def mean_occupation(table: TableData, occupation_cen, occupation_sat, params):
    """Per-bin mean occupation (..., n_bins) via the precomputed quadrature.

    ``params`` maps names to tensors of a common batch shape (...) on the
    table's device; they broadcast against the (n_bins, n_gauss) nodes.
    """
    params = {k: v[..., None, None] for k, v in params.items()}
    nc = table.n_centrals
    sec = table.sec_perc[:, None]
    logm = table.log_prim_quad
    res = table.log_prim_quad_lo
    if res is None:
        occ_c = occupation_cen(params, logm[:nc], sec[:nc])
        occ_s = occupation_sat(params, logm[nc:], sec[nc:])
    else:
        occ_c = occupation_with_residual(
            occupation_cen, params, logm[:nc], res[:nc], sec[:nc])
        occ_s = occupation_with_residual(
            occupation_sat, params, logm[nc:], res[nc:], sec[nc:])
    occ = torch.cat([occ_c, occ_s], dim=-2)
    return torch.sum(table.quad_weight * occ, dim=-1)


def predict_from_occupation(table: TableData, mean_occ):
    """(ngal (...,), xi (..., n_xi)) from a mean-occupation array."""
    ngal = mean_occ * table.n_h
    total = torch.sum(ngal, dim=-1)
    if table.mode == AUTO:
        t = torch.einsum("kij,...j->...ki", table.tpcf_dense, ngal)
        xi = torch.einsum("...ki,...i->...k", t, ngal)
        xi = xi / total[..., None] ** 2
    else:
        xi = torch.einsum("ki,...i->...k", table.tpcf_dense, ngal)
        xi = xi / total[..., None]
    return total, xi
