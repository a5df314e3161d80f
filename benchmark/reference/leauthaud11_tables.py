"""Plain reference of a decorated Leauthaud et al. (2011) HOD prediction
from tabulations.

Written from the published equations, in plain PyTorch, in float64.  It
imports nothing of the program and takes nothing the program made: it
reads the raw tables (the matrices and the bins' columns, as stored) and
works out everything else again.  The quadrature, the contraction and the
grid spline are ``hod_tables``' (TabCorr's method); this file adds the
occupation.

* The stellar-to-halo-mass relation (Behroozi et al. 2010, eq. 21):
  log10 M_h(M*) = log10 M_1 + beta x + 10^(delta x) / (1 + 10^(-gamma x))
  - 1/2 with x = log10(M* / M*_0), each coefficient ``*_0 + *_a (a - 1)``
  at the table's scale factor a = 1 / (1 + z).
* Its inverse f_SHMR(M_h), the mean stellar mass at a halo mass, by
  float64 bisection of the monotone relation.  The inverse exists where
  the relation increases; the form increases for every M* where beta,
  delta and gamma are all positive (each term of its derivative is then
  positive), as in Behroozi et al.'s fits, and the model is taken to be
  defined there only: elsewhere f_SHMR, and so the row's prediction, is
  NaN.  So are the centrals (and the satellites they modulate) where the
  scatter, the log-normal's width, is not positive.
* Centrals (Leauthaud et al. 2011, eq. 8): <N_cen> = erfc((log10 M*_t -
  log10 f_SHMR(M_h)) / (sqrt(2) sigma)) / 2, sigma the scatter
  (``scatter_model_param1``), M*_t the threshold.
* Satellites (eqs. 12-14): <N_sat> = <N_cen> (M_h / M_sat)^alpha_sat
  exp(-M_cut / M_h), M_sat = 1e12 B_sat (M_h,t / 1e12)^beta_sat and
  M_cut = 1e12 B_cut (M_h,t / 1e12)^beta_cut, M_h,t = M_h(M*_t).
* The decoration (Hearin et al. 2016, MNRAS 460, 2552): halos at or above
  the secondary-property split p (the bin's percentile midpoint) get
  <N> + delta, those below <N> - delta (1 - p) / p, which keeps the mean
  over the mass bin; delta = A min(hi - <N>, p / (1 - p) (<N> - lo)) for
  a strength A >= 0 and A min(<N> - lo, p / (1 - p) (hi - <N>)) for
  A < 0, A clipped to [-1, 1], so both halves stay inside [lo, hi]:
  [0, 1] for centrals, [0, inf) for satellites.

Departures from the published description, and the conventions chosen:

* littleh: the published coefficients are for h = 0.72; a mass in h = 1
  units enters the relation as M* h^2 and leaves as M_h / h (halotools'
  convention for its ``leauthaud11`` model).
* The bisection brackets log10 M* in [5, 13]: a halo mass whose stellar
  mass lies outside takes the nearer end.  64 halvings of the bracket
  leave it below one ulp of the result.
* The satellites' factor <N_cen> is the undecorated one (halotools builds
  it from an undecorated central model), and the decoration then applies
  to <N_sat> as a whole.
* The decoration is applied at each quadrature node, before the node's
  weight: TabCorr integrates the occupation over the bin.

``precision="tf32"`` is the control: the same arithmetic in float32 (the
bisection too) with the contraction's operands rounded to TF32, as
``hod_tables`` has it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.hod_tables import Reference as _Tables

LITTLEH = 0.72             # the published coefficients' h
SPLIT = 0.5                # the decoration's percentile split
BRACKET = (5.0, 13.0)      # log10 M* searched by the bisection
HALVINGS = 64
SQRT2 = math.sqrt(2.0)
LN10 = math.log(10.0)


def smhm_coefficients(p, a):
    """(log10 M_1, log10 M*_0, beta, delta, gamma) at scale factor ``a``."""
    return tuple(p[f"smhm_{k}_0"] + p[f"smhm_{k}_a"] * (a - 1.0)
                 for k in ("m1", "m0", "beta", "delta", "gamma"))


def log_halo_mass(log_mstar, coeffs, littleh=LITTLEH):
    """Behroozi et al. (2010) eq. 21: log10 M_h at log10 M* (h = 1 units
    in and out)."""
    log_m1, log_m0, beta, delta, gamma = coeffs
    log_h = math.log10(littleh)
    x = log_mstar + 2.0 * log_h - log_m0
    return (log_m1 + beta * x + 10.0 ** (delta * x) /
            (1.0 + 10.0 ** (-gamma * x)) - 0.5 - log_h)


def log_stellar_mass(log_mh, coeffs, littleh=LITTLEH):
    """log10 f_SHMR(M_h): the relation inverted by bisection, for
    ``log_mh`` broadcast against the coefficients."""
    shape = torch.broadcast_shapes(log_mh.shape, coeffs[0].shape)
    lo = torch.full(shape, BRACKET[0], dtype=log_mh.dtype,
                    device=log_mh.device)
    hi = torch.full_like(lo, BRACKET[1])
    for _ in range(HALVINGS):
        mid = 0.5 * (lo + hi)
        below = log_halo_mass(mid, coeffs, littleh) < log_mh
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def increasing(coeffs):
    """Where the relation increases by its form: beta, delta, gamma > 0."""
    _, _, beta, delta, gamma = coeffs
    return (beta > 0) & (delta > 0) & (gamma > 0)


def centrals(p, log_mstar, threshold):
    """Leauthaud et al. (2011) eq. 8, from log10 f_SHMR(M_h); NaN where
    the scatter, a log-normal's width, is not positive."""
    sigma = p["scatter_model_param1"]
    sigma = torch.where(sigma > 0, sigma, torch.nan)
    return 0.5 * torch.special.erfc((threshold - log_mstar) /
                                    (SQRT2 * sigma))


def satellites(p, log_mh, ncen, threshold, coeffs, littleh=LITTLEH):
    """Leauthaud et al. (2011) eqs. 12-14, modulated by ``ncen``."""
    thr = torch.full_like(p["bsat"], threshold)
    log_mh_t = log_halo_mass(thr, coeffs, littleh)
    log_msat = (12.0 + torch.log10(p["bsat"]) +
                p["betasat"] * (log_mh_t - 12.0))
    log_mcut = (12.0 + torch.log10(p["bcut"]) +
                p["betacut"] * (log_mh_t - 12.0))
    return (ncen * torch.exp(LN10 * p["alphasat"] * (log_mh - log_msat)) *
            torch.exp(-(10.0 ** (log_mcut - log_mh))))


def decorate(base, strength, above, upper, split=SPLIT):
    """Hearin et al. (2016)'s Heaviside decoration of ``base`` (lower
    bound 0, upper bound ``upper`` or None), ``above`` marking the halos at
    or above the split."""
    a = strength.clamp(-1.0, 1.0)
    ratio = split / (1.0 - split)
    if upper is None:
        room_up, room_down = ratio * base, base
    else:
        room_up = torch.minimum(upper - base, ratio * base)
        room_down = torch.minimum(base, ratio * (upper - base))
    delta = torch.where(a >= 0, a * room_up, a * room_down)
    return torch.where(above, base + delta,
                       base - delta * (1.0 - split) / split)


class Reference(_Tables):
    """Decorated Leauthaud11 predictions of every table of a
    configuration; ``hod_tables.Reference``'s interface (``predict``,
    ``shapes``) and raw tables.  The model's ``threshold`` (log10 M*_t)
    comes from the configuration's ``model.kwargs``, the scale factor from
    each table's redshift."""

    def __init__(self, tables, config, device, precision="float64",
                 block_bytes=2 ** 31):
        kwargs = config["model"]["kwargs"]
        self.threshold = float(kwargs["threshold"])
        self.littleh = float(kwargs.get("littleh", LITTLEH))
        self.split = float(kwargs.get("split", SPLIT))
        super().__init__(tables, config, device, precision, block_bytes)

    def _prepare(self, t):
        prep = super()._prepare(t)
        # The distinct abscissae: centrals and satellites share mass bins.
        nodes = prep["log_m"].cpu().numpy()
        distinct, inverse = np.unique(nodes, return_inverse=True)
        prep["abscissae"] = self._tensor(distinct)
        prep["inverse"] = torch.as_tensor(inverse.reshape(nodes.shape),
                                          device=self.device)
        prep["above"] = torch.as_tensor(
            np.asarray(t.columns["sec_haloprop_percentile"]) >= self.split,
            device=self.device)[:, None]
        prep["a"] = 1.0 / (1.0 + float(t.redshift))
        return prep

    def _occupation(self, t, p):
        q = {k: v[:, None] for k, v in p.items()}                # B, 1
        coeffs = smhm_coefficients(q, t["a"])
        log_mh = t["abscissae"][None]                            # 1, n_u
        log_mstar = torch.where(
            increasing(coeffs), log_stellar_mass(log_mh, coeffs,
                                                 self.littleh), torch.nan)
        ncen = centrals(q, log_mstar, self.threshold)
        nsat = satellites(q, log_mh, ncen, self.threshold, coeffs,
                          self.littleh)
        cen = ncen[:, t["inverse"]]                              # B, bins, g
        sat = nsat[:, t["inverse"]]
        r = {k: v[:, None] for k, v in q.items()}                # B, 1, 1
        cen = decorate(cen, r["mean_occupation_centrals_assembias_param1"],
                       t["above"], 1.0, self.split)
        sat = decorate(sat, r["mean_occupation_satellites_assembias_param1"],
                       t["above"], None, self.split)
        occ = torch.where(t["is_cen"][None], cen, sat)
        return torch.sum(occ * t["weight"][None], dim=-1)        # B, bins

    def _rows_per_block(self, t):
        # The bisection's (rows, abscissae) and the nodes' (rows, bins,
        # n_gauss) temporaries.
        width = (8 * t["abscissae"].shape[0] +
                 6 * t["n_bins"] * self.n_gauss + t["n_nodes"] * t["n_xi"])
        return max(256, self.block_bytes // (8 * width))

