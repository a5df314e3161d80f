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

from ..utils.device import host_tensor, resolve_device

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
        (None or absent in float64) to arrays; each is rounded to
        ``dtype`` (bfloat16, float32 or float64) once from float64 on the
        host and copied to ``device``.
        """
        device = resolve_device(device)

        def tensor(a):
            if a is None:
                return None
            return host_tensor(a, dtype).to(device)

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

    A bfloat16 table's occupation runs in float32, on its bfloat16
    nodes, residuals and weights and the parameters as given (bfloat16
    ones widened exactly), and comes out float32, as tabcorr_tpu's does:
    its transcendentals return float32 for a bfloat16 argument, and XLA
    keeps the bfloat16 arithmetic around them in float32 (excess
    precision within a fusion).
    """
    if table.n_h.dtype == torch.bfloat16:
        def wide(x):
            return None if x is None else x.float()

        table = dataclasses.replace(table, **{
            f: wide(getattr(table, f)) for f in
            ("log_prim_quad", "log_prim_quad_lo", "quad_weight",
             "sec_perc")})
        params = {k: v.float() if v.dtype == torch.bfloat16 else v
                  for k, v in params.items()}
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


def promoted_einsum(equation, a, b, out_dtype=None):
    """``torch.einsum`` over operands of mixed types, as ``jnp.einsum``
    computes it: in their promoted type (float32 for bfloat16, which
    accumulates wide), rounded to ``out_dtype`` (its
    ``preferred_element_type``; default the promoted type).  A bfloat16
    table and float32 densities contract in float32; bfloat16 densities
    give a bfloat16 result."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    out_dtype = dtype if out_dtype is None else out_dtype
    if a.dtype == b.dtype == out_dtype != torch.bfloat16:
        return torch.einsum(equation, a, b)
    wide = torch.float32 if dtype == torch.bfloat16 else dtype
    return torch.einsum(equation, a.to(wide), b.to(wide)).to(out_dtype)


def predict_from_occupation(table: TableData, mean_occ):
    """(ngal (...,), xi (..., n_xi)) from a mean-occupation array."""
    ngal = mean_occ * table.n_h
    total = torch.sum(ngal, dim=-1)
    if table.mode == AUTO:
        t = promoted_einsum("kij,...j->...ki", table.tpcf_dense, ngal,
                            ngal.dtype)
        xi = promoted_einsum("...ki,...i->...k", t, ngal)
        xi = xi / total[..., None] ** 2
    else:
        xi = promoted_einsum("ki,...i->...k", table.tpcf_dense, ngal,
                             ngal.dtype)
        xi = xi / total[..., None]
    return total, xi


def predict_from_occupation_separate(table: TableData, mean_occ):
    """Per-galaxy-type decomposition (reference: tabcorr/tabcorr.py:652-683).

    Returns (ngal_dict, xi_dict); auto-mode keys are 'centrals-centrals',
    'centrals-satellites' and 'satellites-satellites', cross-mode keys
    'centrals' and 'satellites'.
    """
    ngal = mean_occ * table.n_h
    mask_c = (torch.arange(table.n_bins, device=ngal.device) <
              table.n_centrals).to(ngal.dtype)
    n_cen = ngal * mask_c
    n_sat = ngal * (1.0 - mask_c)
    total = torch.sum(ngal, dim=-1)
    ngal_dict = {"centrals": torch.sum(n_cen, dim=-1),
                 "satellites": torch.sum(n_sat, dim=-1)}
    if table.mode == AUTO:
        denom = total[..., None] ** 2

        def quad(a, b):
            t = promoted_einsum("kij,...j->...ki", table.tpcf_dense, b,
                                b.dtype)
            return promoted_einsum("...ki,...i->...k", t, a) / denom

        xi_dict = {"centrals-centrals": quad(n_cen, n_cen),
                   "centrals-satellites": 2.0 * quad(n_cen, n_sat),
                   "satellites-satellites": quad(n_sat, n_sat)}
    else:
        denom = total[..., None]
        xi_dict = {
            "centrals": promoted_einsum("ki,...i->...k", table.tpcf_dense,
                                        n_cen, n_cen.dtype) / denom,
            "satellites": promoted_einsum("ki,...i->...k", table.tpcf_dense,
                                          n_sat, n_sat.dtype) / denom}
    return ngal_dict, xi_dict
