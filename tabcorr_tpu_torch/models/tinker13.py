"""Tinker et al. (2013) quiescent/active HOD occupation model.

Port of ``tabcorr_tpu/models/tinker13.py`` (halotools' ``Tinker13Cens`` /
``Tinker13QuiescentSats`` / ``Tinker13ActiveSats``).  Centrals carry
separate Behroozi10 SHMRs for the quiescent and active populations,
weighted by a central quiescent fraction f_q(Mh) given at control masses,

    <N_cen,q>(Mh) = f_q(Mh)       * 1/2 erfc(nu_q(Mh)),
    <N_cen,a>(Mh) = (1 - f_q(Mh)) * 1/2 erfc(nu_a(Mh)),

and each satellite population follows its own Leauthaud11-form power law
with exponential cutoff, not modulated by the centrals (Tinker et al.
2013, eqs. 6-9).  Parameter keys follow halotools' suffixes
(``smhm_m1_0_active``, ``quiescent_fraction_ordinates_param1``, ...).

f_q(Mh) is halotools' ``custom_spline``: an interpolating spline of degree
min(n_points - 1, 5) in log10 Mh through the ordinates, polynomial
extrapolation, the result clipped to [0, 1].  For fixed control masses the
spline is linear in the ordinates, so the map from ordinates to
piecewise-polynomial coefficients is built once on the host with scipy
(:func:`tinker13_fq_spline_map`); its breaks and coefficients go to each
device once, and the evaluation is ``where`` selection and Horner
arithmetic in float64 (the spline's terms cancel; a float32 query gets
the result rounded to float32).  Piecewise-linear interpolation stays
available as ``interpolation='linear'``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.backend import asarray, get_namespace, is_numpy
from .leauthaud11 import (LEAUTHAUD11_PARAMS, leauthaud11_centrals,
                          leauthaud11_satellites)
from .protocol import CENTRALS, HodModel

QUIESCENT = "quiescent"
ACTIVE = "active"

# Control masses of the central quiescent fraction (halotools' default).
TINKER13_ABSCISSA = (12.0, 13.5, 15.0)          # log10 Mh
_DEFAULT_ORDINATES = (0.25, 0.7, 0.95)

_SMHM_KEYS = ("smhm_m0_0", "smhm_m0_a", "smhm_m1_0", "smhm_m1_a",
              "smhm_beta_0", "smhm_beta_a", "smhm_delta_0",
              "smhm_delta_a", "smhm_gamma_0", "smhm_gamma_a",
              "scatter_model_param1")
_SAT_KEYS = ("alphasat", "betasat", "bsat", "betacut", "bcut")

# The Leauthaud11 coefficients for both populations, then the ordinates.
TINKER13_PARAMS = {f"{k}_{sfr}": LEAUTHAUD11_PARAMS[k]
                   for sfr in (ACTIVE, QUIESCENT)
                   for k in _SMHM_KEYS + _SAT_KEYS}
TINKER13_PARAMS.update({f"quiescent_fraction_ordinates_param{i + 1}": o
                        for i, o in enumerate(_DEFAULT_ORDINATES)})


def _ordinate(i):
    return f"quiescent_fraction_ordinates_param{i + 1}"


def _subparams(params, sfr):
    """The Leauthaud11-layout parameter view of one SFR population."""
    return {k: params[f"{k}_{sfr}"] for k in _SMHM_KEYS + _SAT_KEYS}


# Host maps by (abscissa, degree), and their float64 device copies by
# (abscissa, device).
_FQ_SPLINE_MAPS = {}
_FQ_SPLINE_TENSORS = {}


def tinker13_fq_spline_map(abscissa=TINKER13_ABSCISSA, k=None):
    """The f_q spline as a linear map from ordinates to piecewise
    polynomial coefficients, on the host (scipy, float64).

    Returns ``(breaks, coeffs)`` of shapes ``(n_segments + 1,)`` and
    ``(n_segments, degree + 1, n_points)``: per segment the PPoly
    coefficients (highest degree first, in ``x - break_left``) of the
    spline through each unit ordinate vector.  The outer segments extend
    beyond the end breaks.  The default 3-point abscissa gives one
    quadratic segment.
    """
    from scipy.interpolate import PPoly, splrep

    x = np.asarray(abscissa, dtype=np.float64)
    n = len(x)
    if k is None:
        k = min(n - 1, 5)
    key = (tuple(x.tolist()), int(k))
    cached = _FQ_SPLINE_MAPS.get(key)
    if cached is not None:
        return cached
    breaks = None
    cols = []
    for i in range(n):
        e = np.zeros(n)
        e[i] = 1.0
        pp = PPoly.from_spline(splrep(x, e, k=k, s=0), extrapolate=True)
        # The knot vector repeats its ends; keep the segments of nonzero
        # width.
        real = np.flatnonzero(np.diff(pp.x) > 0)
        if breaks is None:
            breaks = np.append(pp.x[real], pp.x[real[-1] + 1])
        cols.append(pp.c[:, real])
    coeffs = np.stack(cols, axis=-1).transpose(1, 0, 2)
    result = (breaks, np.ascontiguousarray(coeffs))
    _FQ_SPLINE_MAPS[key] = result
    return result


def _spline_map_on(abscissa, like):
    """The spline map in ``like``'s namespace and on its device, float64
    (tensor queries are evaluated in float64), sent to each device once."""
    breaks, coeffs = tinker13_fq_spline_map(abscissa)
    if is_numpy(like):
        return breaks, coeffs
    key = (tuple(abscissa), like.device)
    cached = _FQ_SPLINE_TENSORS.get(key)
    if cached is None:
        cached = (torch.as_tensor(breaks, dtype=torch.float64,
                                  device=like.device),
                  torch.as_tensor(coeffs, dtype=torch.float64,
                                  device=like.device))
        _FQ_SPLINE_TENSORS[key] = cached
    return cached


def _fq_linear(params, logm, abscissa, log_prim_res, xp):
    """Piecewise-linear f_q: ordinates clamped to [0, 1], constant beyond
    the end control points; ``log_prim_res`` absorbed through the segment
    slope."""
    one = asarray(1.0, logm)
    zero = asarray(0.0, logm)
    ords = []
    for i in range(len(abscissa)):
        o = asarray(params[_ordinate(i)], logm)
        ords.append(xp.where(o < zero, zero, xp.where(o > one, one, o)))
    y = ords[0] + xp.zeros_like(logm)
    dy = xp.zeros_like(logm)
    for i in range(len(abscissa) - 1):
        dx = abscissa[i + 1] - abscissa[i]
        slope = (ords[i + 1] - ords[i]) / dx
        t = logm - abscissa[i]
        y = y + slope * xp.where(t < zero, zero,
                                 xp.where(t > dx, asarray(dx, logm), t))
        if log_prim_res is not None:
            dy = dy + xp.where((t >= zero) & (t < dx), slope, zero)
    if log_prim_res is not None:
        y = y + dy * log_prim_res
    return y


def tinker13_quiescent_fraction(params, log_prim_haloprop,
                                abscissa=TINKER13_ABSCISSA,
                                log_prim_res=None,
                                interpolation="spline",
                                spline_map=None):
    """Central quiescent fraction f_q(Mh) through the ordinate parameters
    at the control masses.

    ``interpolation='spline'`` (default) is halotools' spline, clipped to
    [0, 1]; ``'linear'`` the piecewise-linear variant.  ``spline_map``
    (breaks, coeffs) overrides the map of ``abscissa`` (numpy inputs).
    ``log_prim_res`` shifts the polynomial's evaluation point (the
    segment is chosen at the unshifted mass).
    """
    xp = get_namespace(log_prim_haloprop, params[_ordinate(0)])
    logm = asarray(log_prim_haloprop, log_prim_haloprop)
    if interpolation == "linear":
        return _fq_linear(params, logm, abscissa, log_prim_res, xp)
    if interpolation != "spline":
        raise ValueError(f"Unknown interpolation: {interpolation!r}")
    if xp is torch and logm.dtype != torch.float64:
        # The spline's terms cancel (coefficients ~10 against s^4 up to
        # ~100 with 5 control masses), beyond float32's 1e-6.  A float32
        # query gets the float64 evaluation rounded.
        res = None if log_prim_res is None else log_prim_res.double()
        return tinker13_quiescent_fraction(
            params, logm.double(), abscissa, res,
            spline_map=spline_map).to(logm.dtype)
    if spline_map is None:
        spline_map = _spline_map_on(abscissa, logm)
    breaks, coeffs = spline_map
    n_seg, n_coef, n_pts = coeffs.shape
    ords = [asarray(params[_ordinate(i)], logm) for i in range(n_pts)]
    # Per-segment coefficients: combinations of the ordinates, summed in
    # the JAX package's order.
    c_seg = [[sum(coeffs[j, d, i] * ords[i] for i in range(n_pts))
              for d in range(n_coef)] for j in range(n_seg)]
    if n_seg == 1:
        left = breaks[0]
        c_sel = c_seg[0]
    else:
        left = xp.full_like(logm, float(breaks[0]))
        c_sel = [c + xp.zeros_like(logm) for c in c_seg[0]]
        for j in range(1, n_seg):
            inside = logm >= breaks[j]
            left = xp.where(inside, breaks[j], left)
            c_sel = [xp.where(inside, c_seg[j][d], c_sel[d])
                     for d in range(n_coef)]
    s = logm - left
    if log_prim_res is not None:
        s = s + log_prim_res
    y = c_sel[0] + xp.zeros_like(logm)
    for d in range(1, n_coef):
        y = y * s + c_sel[d]
    one = asarray(1.0, logm)
    zero = asarray(0.0, logm)
    return xp.where(y < zero, zero, xp.where(y > one, one, y))


def tinker13_centrals(params, log_prim_haloprop, threshold, a,
                      sfr_designation, abscissa=TINKER13_ABSCISSA,
                      littleh=0.72, log_prim_res=None):
    """<N_cen> of one SFR population (or their sum): the population's own
    SHMR erfc weighted by f_q / (1 - f_q) (Tinker et al. 2013, eqs.
    6-8)."""
    fq = tinker13_quiescent_fraction(params, log_prim_haloprop,
                                     abscissa=abscissa,
                                     log_prim_res=log_prim_res)
    out = None
    if sfr_designation in (QUIESCENT, "all"):
        out = fq * leauthaud11_centrals(
            _subparams(params, QUIESCENT), log_prim_haloprop, threshold,
            a, littleh=littleh, log_prim_res=log_prim_res)
    if sfr_designation in (ACTIVE, "all"):
        occ_a = (1.0 - fq) * leauthaud11_centrals(
            _subparams(params, ACTIVE), log_prim_haloprop, threshold,
            a, littleh=littleh, log_prim_res=log_prim_res)
        out = occ_a if out is None else out + occ_a
    if out is None:
        raise ValueError(f"Unknown sfr_designation: {sfr_designation!r}")
    return out


def tinker13_satellites(params, log_prim_haloprop, threshold, a,
                        sfr_designation, littleh=0.72, log_prim_res=None):
    """<N_sat> of one SFR population (or their sum): the Leauthaud11 form
    with the population's own scalings, not modulated by <N_cen>
    (Tinker et al. 2013, eq. 9)."""
    kinds = (QUIESCENT, ACTIVE) if sfr_designation == "all" \
        else (sfr_designation,)
    if not set(kinds) <= {QUIESCENT, ACTIVE}:
        raise ValueError(f"Unknown sfr_designation: {sfr_designation!r}")
    return sum(
        leauthaud11_satellites(_subparams(params, sfr),
                               log_prim_haloprop, threshold, a,
                               modulate_with_cenocc=False,
                               littleh=littleh,
                               log_prim_res=log_prim_res)
        for sfr in kinds)


class Tinker13Model(HodModel):
    """Tinker et al. (2013) quiescent/active HOD model.

    Parameters
    ----------
    threshold : float, optional
        Stellar-mass threshold log10(M*_t), h = 1 units.  Default 10.5.
    sfr_designation : {'all', 'quiescent', 'active'}, optional
        Which population this instance predicts; instances may share a
        ``param_dict``.  Default 'all'.
    quiescent_fraction_abscissa : sequence of float, optional
        log10 control masses of f_q.  Default (12, 13.5, 15).
    littleh : float, optional
        See :class:`~.leauthaud11.Leauthaud11Model`.  Default 0.72.
    redshift : float, optional
        Scale factor a = 1/(1+z) of the coefficients' evolution.
    **params : dict
        Overrides for ``{name}_active`` / ``{name}_quiescent`` (the
        Leauthaud11 names) and ``quiescent_fraction_ordinates_param{i}``.
    """

    param_names = tuple(TINKER13_PARAMS)
    param_defaults = dict(TINKER13_PARAMS)

    def __init__(self, threshold=10.5, sfr_designation="all",
                 quiescent_fraction_abscissa=TINKER13_ABSCISSA,
                 littleh=0.72, prim_haloprop_key="halo_mvir",
                 sec_haloprop_key=None, redshift=0.0, **params):
        if sfr_designation not in ("all", QUIESCENT, ACTIVE):
            raise ValueError(
                f"Unknown sfr_designation: {sfr_designation!r}")
        self.threshold = float(threshold)
        self.sfr_designation = sfr_designation
        abscissa = tuple(float(x) for x in quiescent_fraction_abscissa)
        if len(abscissa) < 2 or any(
                b <= a for a, b in zip(abscissa, abscissa[1:])):
            raise ValueError("quiescent_fraction_abscissa must be "
                             ">= 2 strictly increasing log-masses.")
        self.quiescent_fraction_abscissa = abscissa
        self.littleh = float(littleh)
        # The ordinate count follows the abscissa: a custom abscissa
        # re-keys the ordinates (default 0.5 each).
        if len(abscissa) != len(TINKER13_ABSCISSA):
            defaults = {k: v for k, v in TINKER13_PARAMS.items()
                        if not k.startswith("quiescent_fraction_ordinates")}
            defaults.update({_ordinate(i): 0.5
                             for i in range(len(abscissa))})
            self.param_defaults = defaults
            self.param_names = tuple(defaults)
        super().__init__(prim_haloprop_key=prim_haloprop_key,
                         sec_haloprop_key=sec_haloprop_key,
                         redshift=redshift, **params)

    @property
    def _a(self):
        return 1.0 / (1.0 + self.redshift)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        # The undecorated form, also under a decorated subclass.
        return Tinker13Model.occupation_residual(
            self, params, gal_type, log_prim_haloprop, None,
            sec_haloprop_percentile)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        # Exact absorption throughout: the SHMR erfc by the implicit
        # function theorem, f_q by its shifted evaluation point, the
        # satellites' affine exponents.
        if gal_type == CENTRALS:
            return tinker13_centrals(
                params, log_prim_haloprop, self.threshold, self._a,
                self.sfr_designation,
                abscissa=self.quiescent_fraction_abscissa,
                littleh=self.littleh, log_prim_res=log_prim_res)
        return tinker13_satellites(
            params, log_prim_haloprop, self.threshold, self._a,
            self.sfr_designation, littleh=self.littleh,
            log_prim_res=log_prim_res)
