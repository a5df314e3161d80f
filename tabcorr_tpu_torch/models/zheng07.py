"""Zheng et al. (2007) HOD occupation model.

    <N_cen>(M) = 1/2 [1 + erf((log10 M - logMmin) / sigma_logM)]
    <N_sat>(M) = ((M - M0) / M1)^alpha   for M > M0, else 0

with optional central modulation <N_sat> -> <N_cen> <N_sat> (halotools'
``modulate_with_cenocc``).  The satellite power law is evaluated in log
space, ``exp(ln10 * alpha * (log10(M - M0) - logM1))`` with
``log10(M - M0) = logM + log1p(-10^(logM0 - logM))/ln10``.

Every numerical choice follows ``tabcorr_tpu/models/zheng07.py``, and the
CUDA kernels (``csrc/zheng07.cuh``) evaluate the same expressions in the
same order.
"""

from __future__ import annotations

from ..utils.backend import (erfc, exp, exp10, get_namespace, is_float64,
                             log1p_abs)
from .protocol import CENTRALS, HodModel

_LN10 = 2.302585092994046

# Zheng et al. (2007), Table 1: best-fit parameters for SDSS
# luminosity-threshold samples, keyed by absolute r-band magnitude threshold.
ZHENG07_THRESHOLD_PARAMS = {
    -18.0: dict(logMmin=11.35, sigma_logM=0.25, logM0=11.20, logM1=12.40, alpha=0.83),
    -18.5: dict(logMmin=11.46, sigma_logM=0.24, logM0=10.59, logM1=12.68, alpha=0.97),
    -19.0: dict(logMmin=11.60, sigma_logM=0.26, logM0=11.49, logM1=12.83, alpha=1.02),
    -19.5: dict(logMmin=11.75, sigma_logM=0.28, logM0=11.69, logM1=13.01, alpha=1.06),
    -20.0: dict(logMmin=12.02, sigma_logM=0.26, logM0=11.38, logM1=13.31, alpha=1.06),
    -20.5: dict(logMmin=12.30, sigma_logM=0.21, logM0=11.84, logM1=13.58, alpha=1.12),
    -21.0: dict(logMmin=12.79, sigma_logM=0.39, logM0=11.92, logM1=13.94, alpha=1.15),
    -21.5: dict(logMmin=13.38, sigma_logM=0.51, logM0=13.94, logM1=13.91, alpha=1.04),
    -22.0: dict(logMmin=14.22, sigma_logM=0.77, logM0=14.00, logM1=14.69, alpha=0.87),
}


def zheng07_centrals(params, log_prim_haloprop, log_prim_res=None):
    """<N_cen> as a pure function of a params mapping and log10(M).

    Evaluated as erfc(-x)/2 rather than (1 + erf(x))/2, which loses the
    deep tail (N_cen -> 0) to float32 cancellation against 1.  The
    standardization multiplies by 1/sigma, computed once per parameter
    vector.  ``log_prim_res`` (the float64 residual of the float32 node)
    is added AFTER the O(1) subtraction ``logM - logMmin``, where it is
    not rounded away.
    """
    inv_sigma = 1.0 / params["sigma_logM"]
    centered = log_prim_haloprop - params["logMmin"]
    if log_prim_res is not None:
        centered = centered + log_prim_res
    return 0.5 * erfc(-centered * inv_sigma)


def zheng07_satellites(params, log_prim_haloprop, modulate_with_cenocc=False,
                       log_prim_res=None):
    """<N_sat> as a pure function of a params mapping and log10(M).

    ``log_prim_res`` is absorbed analytically:
    d(log10(M - M0))/d(log10 M) = 1/(1 - M0/M), so the exponent picks up
    ``res / (1 - ratio)``.
    """
    xp = get_namespace(log_prim_haloprop)
    log_m = log_prim_haloprop
    log_m0 = params["logM0"]
    # Clamp the log1p argument away from -1 so value and gradient stay
    # finite when a node sits within one ulp of M0.  The ratio is the
    # product 10**(-logM) * 10**logM0: each factor depends on one of
    # (node grid, parameter vector) only.
    eps = 1e-12 if is_float64(log_m) else 1e-6
    ratio = (exp10(-log_m) * exp10(log_m0)).clip(max=1.0 - eps)
    # (log_m - logM1) first: the close float32 subtraction is exact, so no
    # ~15-magnitude intermediate is rounded before the O(1) log1p term.
    log_pow = (log_m - params["logM1"]) + log1p_abs(-ratio) / _LN10
    if log_prim_res is not None:
        log_pow = log_pow + log_prim_res / (1.0 - ratio)
    nsat = exp(_LN10 * params["alpha"] * log_pow)
    nsat = xp.where(log_m > log_m0, nsat, 0.0)
    if modulate_with_cenocc:
        nsat = nsat * zheng07_centrals(params, log_prim_haloprop,
                                       log_prim_res=log_prim_res)
    return nsat


class Zheng07Model(HodModel):
    """Zheng07 HOD model (cens + sats), the reference's workhorse model.

    Parameters
    ----------
    threshold : float, optional
        SDSS luminosity threshold selecting default parameters from
        Zheng et al. (2007) Table 1. Default is -20.
    modulate_with_cenocc : bool, optional
        If True, multiply <N_sat> by <N_cen> (halotools option).
    **params : dict
        Overrides for logMmin, sigma_logM, logM0, logM1, alpha.
    """

    param_names = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")
    # The parameter columns of the CUDA kernels' model (ops.fused.
    # kernel_model), in the order they read them.
    kernel_param_names = param_names

    def __init__(self, threshold=-20.0, modulate_with_cenocc=False,
                 prim_haloprop_key="halo_mvir",
                 sec_haloprop_key=None, redshift=0.0, **params):
        if threshold not in ZHENG07_THRESHOLD_PARAMS:
            raise ValueError(f"No Zheng07 parameters for threshold "
                             f"{threshold}; choose from "
                             f"{sorted(ZHENG07_THRESHOLD_PARAMS)}.")
        self.param_defaults = dict(ZHENG07_THRESHOLD_PARAMS[threshold])
        self.threshold = threshold
        self.modulate_with_cenocc = modulate_with_cenocc
        super().__init__(prim_haloprop_key=prim_haloprop_key,
                         sec_haloprop_key=sec_haloprop_key,
                         redshift=redshift, **params)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return zheng07_centrals(params, log_prim_haloprop)
        return zheng07_satellites(
            params, log_prim_haloprop,
            modulate_with_cenocc=self.modulate_with_cenocc)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return zheng07_centrals(params, log_prim_haloprop,
                                    log_prim_res=log_prim_res)
        return zheng07_satellites(
            params, log_prim_haloprop,
            modulate_with_cenocc=self.modulate_with_cenocc,
            log_prim_res=log_prim_res)
