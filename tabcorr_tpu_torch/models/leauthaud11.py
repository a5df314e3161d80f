"""Leauthaud et al. (2011) HOD occupation model.

Port of ``tabcorr_tpu/models/leauthaud11.py``.  Occupations derive from
the Behroozi et al. (2010) stellar-to-halo-mass relation (SHMR):

    <N_cen>(Mh) = 1/2 erfc( (log10 M*_t - log10 f_SHMR(Mh))
                            / (sqrt(2) sigma_logM*) )
    <N_sat>(Mh) = <N_cen>(Mh) (Mh / M_sat)^alpha_sat exp(-M_cut / Mh)

with M_sat = 1e12 B_sat (Mh_t / 1e12)^beta_sat and
M_cut = 1e12 B_cut (Mh_t / 1e12)^beta_cut, where Mh_t = f_SHMR^-1(M*_t)
(Leauthaud et al. 2011, eqs. 8 and 12-14).

f_SHMR^-1 (stellar -> halo mass) is the closed-form Behroozi relation; the
forward direction f_SHMR, needed for centrals, is a monotone inversion
(``utils.inversion.monotone_inverse``): a log-M* grid in the query's dtype
seeds a piecewise-linear estimate that three Newton steps with the
analytic derivative refine.  The inverse exists where the relation
increases; its form guarantees that where beta, delta and gamma (at the
scale factor) are all positive, as in every published fit, and f_SHMR is
NaN elsewhere (:func:`shmr_increasing`; the JAX package inverts such a
relation all the same, to one of its roots).  The expressions and their
order follow the JAX package; on tensors the parameters are (B, 1, 1) and
the nodes (n_bins, n_gauss), on numpy scalars and float64 arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.backend import asarray, erfc, exp, exp10, is_numpy, log10
from ..utils.inversion import monotone_inverse
from .protocol import CENTRALS, HodModel

_LN10 = 2.302585092994046
_SQRT2 = 1.4142135623730951

# Behroozi et al. (2010) SMHM scaling parameters and the Leauthaud et al.
# (2012) satellite scaling relations ("SIG_MOD1" z1 fit): the defaults
# halotools ships for its leauthaud11 prebuilt model.
LEAUTHAUD11_PARAMS = dict(
    smhm_m0_0=10.72, smhm_m0_a=0.59,
    smhm_m1_0=12.35, smhm_m1_a=0.3,
    smhm_beta_0=0.43, smhm_beta_a=0.18,
    smhm_delta_0=0.56, smhm_delta_a=0.18,
    smhm_gamma_0=1.54, smhm_gamma_a=2.52,
    scatter_model_param1=0.2,
    alphasat=1.0, betasat=0.859, bsat=10.62,
    betacut=-0.13, bcut=1.47,
)

# log10(M*) grid of the inversion seed (the JAX package's).
_GRID_LO, _GRID_HI, _GRID_N = 5.0, 13.0, 257


def _smhm_coeffs(params, a):
    """Redshift-scaled Behroozi10 coefficients (scale factor a)."""
    am1 = a - 1.0
    return (params["smhm_m1_0"] + params["smhm_m1_a"] * am1,
            params["smhm_m0_0"] + params["smhm_m0_a"] * am1,
            params["smhm_beta_0"] + params["smhm_beta_a"] * am1,
            params["smhm_delta_0"] + params["smhm_delta_a"] * am1,
            params["smhm_gamma_0"] + params["smhm_gamma_a"] * am1)


def behroozi10_log_halo_mass(log_mstar, params, a, littleh=0.72):
    """log10 Mh(M*): Behroozi et al. (2010), eq. 21.

    log10 Mh = log10 M1 + beta x + 10^(delta x) / (1 + 10^(-gamma x))
               - 1/2,   with x = log10(M* / M*_0).

    ``littleh``: the published coefficients assume h = 0.72; following
    halotools, h = 1 quantities are converted by evaluating the relation
    at M* h^2 and returning Mh / h (``littleh=1``: the raw relation).
    """
    log_m1, log_m0, beta, delta, gamma = _smhm_coeffs(params, a)
    log_h = math.log10(littleh)
    x = log_mstar + 2.0 * log_h - log_m0
    s_delta = exp10(delta * x)
    s_neg_gamma = exp10(-gamma * x)
    return (log_m1 + beta * x + s_delta / (1.0 + s_neg_gamma) - 0.5 -
            log_h)


def _d_log_mh_d_log_mstar(log_mstar, params, a, littleh=0.72):
    """Analytic d(log10 Mh)/d(log10 M*) for the Newton refinement."""
    _, log_m0, beta, delta, gamma = _smhm_coeffs(params, a)
    x = log_mstar + 2.0 * math.log10(littleh) - log_m0
    s_delta = exp10(delta * x)
    s_neg_gamma = exp10(-gamma * x)
    denom = 1.0 + s_neg_gamma
    return beta + _LN10 * s_delta * (
        delta + (delta + gamma) * s_neg_gamma) / (denom * denom)


def shmr_inverse(log_mh, fwd, dfwd):
    """log10 M* at which the monotone relation ``fwd`` (log10 M* ->
    log10 Mh) reaches ``log_mh``: grid-seeded Newton inversion, the grid
    in the query's dtype and namespace.  Queries outside the grid's
    halo-mass range give its ends: each of the three Newton steps is held
    to the grid's range, where a flat relation (a small beta) would
    otherwise carry the lowest halos' roots tens of dex below it, and
    overflow in float32."""
    if is_numpy(log_mh):
        grid = np.linspace(_GRID_LO, _GRID_HI, _GRID_N, dtype=log_mh.dtype)
    else:
        grid = torch.linspace(_GRID_LO, _GRID_HI, _GRID_N,
                              dtype=log_mh.dtype, device=log_mh.device)
    return monotone_inverse(fwd, log_mh, grid, dfn=dfwd, clamp=True)


def shmr_increasing(beta, delta, gamma):
    """Whether the Behroozi10 form with these coefficients increases by
    construction: its derivative ``beta + ln10 10^(delta x) (delta +
    (delta + gamma) 10^(-gamma x)) / (1 + 10^(-gamma x))^2`` is then
    positive for every x.  Elsewhere it may turn (beta < 0 bends it down
    at low mass) and has no inverse."""
    return (beta > 0) & (delta > 0) & (gamma > 0)


def _where(ok, x):
    """``x`` where ``ok``, NaN elsewhere, on ``x``'s backend."""
    if isinstance(ok, (bool, np.bool_)):
        return x if ok else x * math.nan
    if is_numpy(x):
        return np.where(ok, x, np.nan)
    return torch.where(ok, x, math.nan)


def defined_inverse(log_mstar, beta, delta, gamma):
    """``log_mstar`` where :func:`shmr_increasing`, NaN elsewhere (the
    coefficients broadcast against it)."""
    return _where(shmr_increasing(beta, delta, gamma), log_mstar)


def positive(scatter):
    """The central scatter where it is positive, NaN elsewhere: a width
    of zero or below is no log-normal (the JAX package evaluates the erfc
    with it, which turns the central occupation around)."""
    return _where(scatter > 0, scatter)


def fshmr_log_mstar(log_mh, params, a, littleh=0.72):
    """log10 f_SHMR(Mh): mean stellar mass at halo mass Mh, the monotone
    inversion of :func:`behroozi10_log_halo_mass`; NaN where the relation
    is not increasing by construction (:func:`shmr_increasing`)."""
    log_mh = asarray(log_mh, log_mh)
    _, _, beta, delta, gamma = _smhm_coeffs(params, a)
    return defined_inverse(shmr_inverse(
        log_mh, lambda ls: behroozi10_log_halo_mass(ls, params, a, littleh),
        lambda ls: _d_log_mh_d_log_mstar(ls, params, a, littleh)),
        beta, delta, gamma)


def leauthaud11_centrals(params, log_prim_haloprop, threshold, a,
                         littleh=0.72, log_prim_res=None):
    """<N_cen>: Leauthaud et al. (2011), eq. 8; NaN where the scatter is
    not positive (:func:`positive`) or f_SHMR is undefined.

    ``log_prim_res`` (the float64 residual of the float32 node) shifts
    log10 M* by res / f'(log10 M*) (implicit function theorem, with the
    analytic forward derivative), applied after the O(1) subtraction
    ``threshold - log_fshmr`` so that it is not rounded away.
    """
    log_fshmr = fshmr_log_mstar(log_prim_haloprop, params, a, littleh)
    centered = threshold - log_fshmr
    if log_prim_res is not None:
        centered = centered - log_prim_res / _d_log_mh_d_log_mstar(
            log_fshmr, params, a, littleh)
    inv_scatter = 1.0 / (_SQRT2 * positive(params["scatter_model_param1"]))
    return 0.5 * erfc(centered * inv_scatter)


def leauthaud11_satellites(params, log_prim_haloprop, threshold, a,
                           modulate_with_cenocc=True, littleh=0.72,
                           log_prim_res=None):
    """<N_sat>: Leauthaud et al. (2011), eqs. 12-14.

    M_sat and M_cut scale with the threshold halo mass Mh_t, the
    closed-form direction of the relation.  ``log_prim_res`` enters the
    two affine exponents additively, an exact absorption.
    """
    log_mh = asarray(log_prim_haloprop, log_prim_haloprop)
    # The threshold pivot in the query's dtype and device: a float64
    # constant must not promote the float32 path.
    thr = asarray(threshold, log_mh)
    log_mh_t = behroozi10_log_halo_mass(thr, params, a, littleh)
    log_msat = (12.0 + log10(params["bsat"]) +
                params["betasat"] * (log_mh_t - 12.0))
    log_mcut = (12.0 + log10(params["bcut"]) +
                params["betacut"] * (log_mh_t - 12.0))
    d_pow = log_mh - log_msat
    d_cut = log_mcut - log_mh
    if log_prim_res is not None:
        d_pow = d_pow + log_prim_res
        d_cut = d_cut - log_prim_res
    nsat = (exp(_LN10 * params["alphasat"] * d_pow) *
            exp(-exp10(d_cut)))
    if modulate_with_cenocc:
        nsat = nsat * leauthaud11_centrals(params, log_mh, threshold,
                                           a, littleh,
                                           log_prim_res=log_prim_res)
    return nsat


class Leauthaud11Model(HodModel):
    """Leauthaud11 HOD model (cens + sats), SHMR-based.

    Parameters
    ----------
    threshold : float, optional
        Stellar-mass threshold log10(M*_t) in h = 1 units.  Default 10.5.
    modulate_with_cenocc : bool, optional
        Multiply <N_sat> by <N_cen> (Leauthaud et al. 2011 eq. 12;
        halotools' default).  Default True.
    littleh : float, optional
        Hubble parameter of the published Behroozi10 coefficients
        (halotools' convention).  Default 0.72.
    redshift : float, optional
        Sets the scale factor a = 1 / (1 + z) of the coefficients'
        evolution.  Default 0.
    **params : dict
        Overrides for ``smhm_{m0,m1,beta,delta,gamma}_{0,a}``,
        ``scatter_model_param1``, ``alphasat``, ``betasat``, ``bsat``,
        ``betacut``, ``bcut``.
    """

    param_names = tuple(LEAUTHAUD11_PARAMS)
    param_defaults = dict(LEAUTHAUD11_PARAMS)

    def __init__(self, threshold=10.5, modulate_with_cenocc=True,
                 littleh=0.72, prim_haloprop_key="halo_mvir",
                 sec_haloprop_key=None, redshift=0.0, **params):
        self.threshold = float(threshold)
        self.modulate_with_cenocc = modulate_with_cenocc
        self.littleh = float(littleh)
        super().__init__(prim_haloprop_key=prim_haloprop_key,
                         sec_haloprop_key=sec_haloprop_key,
                         redshift=redshift, **params)

    @property
    def _a(self):
        return 1.0 / (1.0 + self.redshift)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        # The undecorated form, also under a decorated subclass.
        return Leauthaud11Model.occupation_residual(
            self, params, gal_type, log_prim_haloprop, None,
            sec_haloprop_percentile)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        # Implicit-function-theorem absorption (leauthaud11_centrals).
        if gal_type == CENTRALS:
            return leauthaud11_centrals(params, log_prim_haloprop,
                                        self.threshold, self._a,
                                        littleh=self.littleh,
                                        log_prim_res=log_prim_res)
        return leauthaud11_satellites(
            params, log_prim_haloprop, self.threshold, self._a,
            modulate_with_cenocc=self.modulate_with_cenocc,
            littleh=self.littleh, log_prim_res=log_prim_res)
