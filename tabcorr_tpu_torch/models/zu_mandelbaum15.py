"""Zu & Mandelbaum (2015) iHOD occupation model.

Port of ``tabcorr_tpu/models/zu_mandelbaum15.py``.  Like Leauthaud11 the
occupations derive from a Behroozi et al. (2010)-form SHMR, with a
halo-mass-dependent log-normal scatter:

    <N_cen>(Mh) = 1/2 erfc( (ln M*_t - ln f_SHMR(Mh))
                            / (sqrt(2) sigma_lnM*(Mh)) )
    <N_sat>(Mh) = <N_cen>(Mh) (Mh / M_sat)^alpha_sat exp(-M_cut / Mh)

    sigma_lnM*(Mh) = sigma_0                          for Mh <  M_1
                     sigma_0 + eta ln(Mh / M_1)       for Mh >= M_1

with M_sat, M_cut scaling with Mh_t = f_SHMR^-1(M*_t) (Zu & Mandelbaum
2015, eqs. 25-30).  The fit is in h = 1 units with no redshift evolution;
parameter keys follow halotools (``smhm_m0``/``smhm_m1`` linear masses).
"""

from __future__ import annotations

from ..utils.backend import asarray, erfc, exp, exp10, get_namespace, log10
from .leauthaud11 import (_d_log_mh_d_log_mstar, behroozi10_log_halo_mass,
                          shmr_inverse)
from .protocol import CENTRALS, HodModel

_LN10 = 2.302585092994046
_SQRT2 = 1.4142135623730951

# Zu & Mandelbaum (2015) Table 2, the iHOD best fit halotools ships.
ZU_MANDELBAUM15_PARAMS = dict(
    smhm_m0=10.0 ** 10.31, smhm_m1=10.0 ** 12.10,
    smhm_beta=0.33, smhm_delta=0.42, smhm_gamma=1.21,
    smhm_sigma=0.50, smhm_sigma_slope=-0.04,
    alphasat=1.0, betasat=0.90, bsat=8.98,
    betacut=0.41, bcut=0.86,
)

# Scatter floor: keeps sigma_lnM* positive for pathological samples.
_SIGMA_FLOOR = 1e-6


def _behroozi_coeff_dict(params):
    """Zu15's keys in the coefficient layout behroozi10_log_halo_mass
    reads (a = 1 makes the *_a entries inert)."""
    return dict(
        smhm_m1_0=log10(params["smhm_m1"]), smhm_m1_a=0.0,
        smhm_m0_0=log10(params["smhm_m0"]), smhm_m0_a=0.0,
        smhm_beta_0=params["smhm_beta"], smhm_beta_a=0.0,
        smhm_delta_0=params["smhm_delta"], smhm_delta_a=0.0,
        smhm_gamma_0=params["smhm_gamma"], smhm_gamma_a=0.0)


def zu15_log_halo_mass(log_mstar, params):
    """log10 Mh(M*): the Behroozi10 form at the Zu15 parameters (h = 1
    units, no redshift scaling)."""
    return behroozi10_log_halo_mass(log_mstar, _behroozi_coeff_dict(params),
                                    a=1.0, littleh=1.0)


def zu15_log_mstar(log_mh, params):
    """log10 f_SHMR(Mh), by the grid-seeded Newton inversion of
    :func:`zu15_log_halo_mass`."""
    coeffs = _behroozi_coeff_dict(params)
    log_mh = asarray(log_mh, log_mh)
    return shmr_inverse(
        log_mh, lambda ls: behroozi10_log_halo_mass(ls, coeffs, 1.0, 1.0),
        lambda ls: _d_log_mh_d_log_mstar(ls, coeffs, 1.0, 1.0))


def zu15_scatter_ln_mstar(params, log_prim_haloprop, log_prim_res=None):
    """sigma_lnM*(Mh): Zu & Mandelbaum (2015), eq. 26, floored at a tiny
    positive value.  ``log_prim_res`` enters ln(Mh / M_1) additively."""
    xp = get_namespace(log_prim_haloprop, params["smhm_m1"])
    log_mh = asarray(log_prim_haloprop, log_prim_haloprop)
    dln_mh = _LN10 * (log_mh - log10(params["smhm_m1"]))
    if log_prim_res is not None:
        dln_mh = dln_mh + _LN10 * log_prim_res
    sigma = params["smhm_sigma"] + params["smhm_sigma_slope"] * xp.where(
        dln_mh > 0.0, dln_mh, 0.0)
    return xp.where(sigma > _SIGMA_FLOOR, sigma, _SIGMA_FLOOR)


def zu_mandelbaum15_centrals(params, log_prim_haloprop, threshold,
                             log_prim_res=None):
    """<N_cen>: Zu & Mandelbaum (2015), eq. 27.  ``log_prim_res`` shifts
    the SHMR by the implicit function theorem (see
    models.leauthaud11) and enters the scatter exactly."""
    log_fshmr = zu15_log_mstar(log_prim_haloprop, params)
    centered = threshold - log_fshmr
    if log_prim_res is not None:
        centered = centered - log_prim_res / _d_log_mh_d_log_mstar(
            log_fshmr, _behroozi_coeff_dict(params), 1.0, 1.0)
    sigma = zu15_scatter_ln_mstar(params, log_prim_haloprop,
                                  log_prim_res=log_prim_res)
    return 0.5 * erfc(_LN10 * centered / (_SQRT2 * sigma))


def zu_mandelbaum15_satellites(params, log_prim_haloprop, threshold,
                               modulate_with_cenocc=True,
                               log_prim_res=None):
    """<N_sat>: Zu & Mandelbaum (2015), eqs. 28-30, Leauthaud11's form
    with the threshold pivot from the closed-form Zu15 relation."""
    log_mh = asarray(log_prim_haloprop, log_prim_haloprop)
    thr = asarray(threshold, log_mh)
    log_mh_t = zu15_log_halo_mass(thr, params)
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
        nsat = nsat * zu_mandelbaum15_centrals(params, log_mh, threshold,
                                               log_prim_res=log_prim_res)
    return nsat


class ZuMandelbaum15Model(HodModel):
    """Zu & Mandelbaum (2015) iHOD model (cens + sats).

    Parameters
    ----------
    threshold : float, optional
        Stellar-mass threshold log10(M*_t), h = 1 units.  Default 10.5.
    modulate_with_cenocc : bool, optional
        Multiply <N_sat> by <N_cen>.  Default True.
    prim_haloprop_key : str, optional
        Halo mass column; the published fit uses M200m.
    **params : dict
        Overrides for the SHMR coefficients (``smhm_m0``/``smhm_m1`` as
        linear masses, ``smhm_{beta,delta,gamma}``), the scatter
        (``smhm_sigma``, ``smhm_sigma_slope``) and the satellite scalings
        (``alphasat``, ``betasat``, ``bsat``, ``betacut``, ``bcut``).
    """

    param_names = tuple(ZU_MANDELBAUM15_PARAMS)
    param_defaults = dict(ZU_MANDELBAUM15_PARAMS)

    def __init__(self, threshold=10.5, modulate_with_cenocc=True,
                 prim_haloprop_key="halo_m200m", sec_haloprop_key=None,
                 redshift=0.0, **params):
        self.threshold = float(threshold)
        self.modulate_with_cenocc = modulate_with_cenocc
        super().__init__(prim_haloprop_key=prim_haloprop_key,
                         sec_haloprop_key=sec_haloprop_key,
                         redshift=redshift, **params)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        # The undecorated form, also under a decorated subclass.
        return ZuMandelbaum15Model.occupation_residual(
            self, params, gal_type, log_prim_haloprop, None,
            sec_haloprop_percentile)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return zu_mandelbaum15_centrals(params, log_prim_haloprop,
                                            self.threshold,
                                            log_prim_res=log_prim_res)
        return zu_mandelbaum15_satellites(
            params, log_prim_haloprop, self.threshold,
            modulate_with_cenocc=self.modulate_with_cenocc,
            log_prim_res=log_prim_res)
