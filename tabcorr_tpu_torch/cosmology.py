"""Self-contained flat FLRW cosmology, float64 numpy (no astropy).

The port's copy of ``tabcorr_tpu/cosmology.py``, number for number.  The
reference uses astropy cosmologies for two things only:

1. Alcock-Paczynski stretch factors at tabulation time: ratios of
   ``comoving_distance * H0`` and of ``efunc`` between the observation and
   simulation cosmologies (reference: tabcorr/tabcorr.py:142-152).
2. The cosmology registry with ``sigma8``/``ns``/``alphas`` extras
   (reference: tabcorr/database.py:74-158).

Flat FLRW cosmologies with photons, massless and massive neutrinos, and
(w0, wa) dark energy, in astropy's conventions (massive-neutrino density
via the Komatsu et al. 2011 fitting formula).  Cosmology only enters the
pair counts as scalar stretch factors and redshift-space displacements.
"""

from __future__ import annotations

import numpy as np

# Physical constants (SI / conventional units).
C_KM_S = 299792.458                  # speed of light [km/s]
_C_M_S = 299792458.0                 # speed of light [m/s]
_G = 6.67430e-11                     # gravitational constant [m^3/kg/s^2]
_A_RAD = 7.56572301e-16              # radiation constant a_B [J/m^3/K^4]
_MPC_M = 3.0856775814913673e22      # Mpc in meters
_KB_EV = 8.617333262145179e-5        # Boltzmann constant [eV/K]
_TNU_OVER_TCMB = 0.7137658555036082  # (4/11)^(1/3)
_NU_PREFAC = 0.22710731766023898     # 7/8 * (4/11)^(4/3)
# Komatsu et al. (2011) fitting-formula constants for the relative energy
# density of a massive neutrino (same values astropy uses).
_NU_P = 1.83
_NU_K = 0.3173


class FlatFLRW:
    """Spatially-flat FLRW cosmology with (w0, wa) dark energy.

    Parameters
    ----------
    H0 : float
        Hubble constant [km/s/Mpc].
    Om0 : float
        Matter density (CDM + baryons, excluding neutrinos) today.
    Tcmb0 : float, optional
        CMB temperature today [K]. 0 disables radiation.
    Neff : float, optional
        Effective number of neutrino species.
    m_nu : float or sequence, optional
        Neutrino masses [eV]. A scalar assigns the same mass to all
        ``floor(Neff)`` species.
    Ob0 : float or None, optional
        Baryon density today.
    w0, wa : float, optional
        CPL dark-energy equation of state w(a) = w0 + wa * (1 - a).
    sigma8, ns, alphas : float, optional
        Power-spectrum extras carried as attributes (reference:
        tabcorr/database.py:74-84).
    name : str, optional
        Display name.
    """

    def __init__(self, H0, Om0, Tcmb0=0.0, Neff=3.04, m_nu=0.0, Ob0=None,
                 w0=-1.0, wa=0.0, sigma8=0.8, ns=0.96, alphas=0.0, name=None):
        self.H0 = float(H0)
        self.h = self.H0 / 100.0
        self.Om0 = float(Om0)
        self.Ob0 = None if Ob0 is None else float(Ob0)
        self.Tcmb0 = float(Tcmb0)
        self.Neff = float(Neff)
        self.w0 = float(w0)
        self.wa = float(wa)
        self.sigma8 = float(sigma8)
        self.ns = float(ns)
        self.alphas = float(alphas)
        self.name = name

        # Photon density today.
        if self.Tcmb0 > 0:
            h0_si = self.H0 * 1000.0 / _MPC_M
            rho_crit = 3.0 * h0_si**2 / (8.0 * np.pi * _G)       # [kg/m^3]
            rho_gamma = _A_RAD * self.Tcmb0**4 / _C_M_S**2       # [kg/m^3]
            self.Ogamma0 = rho_gamma / rho_crit
        else:
            self.Ogamma0 = 0.0

        # Neutrino bookkeeping (mirrors astropy's conventions).
        self._n_nu = int(np.floor(self.Neff)) if self.Neff > 0 else 0
        m_nu = np.atleast_1d(np.asarray(m_nu, dtype=np.float64))
        if m_nu.size == 1 and self._n_nu > 1:
            m_nu = np.repeat(m_nu, self._n_nu)
        if self._n_nu > 0 and m_nu.size != self._n_nu:
            raise ValueError(
                f"m_nu must have 1 or floor(Neff)={self._n_nu} entries, "
                f"got {m_nu.size}.")
        self.m_nu = m_nu
        self._massive = m_nu[m_nu > 0]
        self._n_massless = int(np.sum(m_nu == 0))
        self._neff_per_nu = self.Neff / self._n_nu if self._n_nu else 0.0
        if self.Tcmb0 > 0:
            tnu0 = _TNU_OVER_TCMB * self.Tcmb0
            self._nu_y = self._massive / (_KB_EV * tnu0)
        else:
            self._nu_y = np.zeros(0)

        self.Onu0 = self.Ogamma0 * self._nu_relative_density(0.0)
        self.Ode0 = 1.0 - self.Om0 - self.Ogamma0 - self.Onu0

    # ------------------------------------------------------------------
    def _nu_relative_density(self, z):
        """Neutrino energy density relative to photons (astropy convention)."""
        if self._n_nu == 0 or self.Tcmb0 == 0:
            return np.zeros_like(np.asarray(z, dtype=np.float64)) + 0.0
        z = np.asarray(z, dtype=np.float64)
        if self._massive.size == 0:
            return _NU_PREFAC * self.Neff * np.ones_like(z)
        curr_y = self._nu_y / (1.0 + z[..., None])
        rel_mass = np.sum((1.0 + (_NU_K * curr_y)**_NU_P)**(1.0 / _NU_P),
                          axis=-1) + self._n_massless
        return _NU_PREFAC * self._neff_per_nu * rel_mass

    def de_density_scale(self, z):
        """rho_de(z) / rho_de(0) for CPL w(a) = w0 + wa (1 - a)."""
        z = np.asarray(z, dtype=np.float64)
        zp1 = 1.0 + z
        if self.wa == 0.0:
            if self.w0 == -1.0:
                return np.ones_like(zp1)
            return zp1**(3.0 * (1.0 + self.w0))
        return zp1**(3.0 * (1.0 + self.w0 + self.wa)) * np.exp(
            -3.0 * self.wa * z / zp1)

    def efunc(self, z):
        """E(z) = H(z) / H0."""
        z = np.asarray(z, dtype=np.float64)
        zp1 = 1.0 + z
        o_r = self.Ogamma0 * (1.0 + self._nu_relative_density(z))
        return np.sqrt(o_r * zp1**4 + self.Om0 * zp1**3 +
                       self.Ode0 * self.de_density_scale(z))

    def inv_efunc(self, z):
        return 1.0 / self.efunc(z)

    @property
    def hubble_distance(self):
        """c / H0 [Mpc]."""
        return C_KM_S / self.H0

    def comoving_distance(self, z, n_quad=256):
        """Line-of-sight comoving distance [Mpc] via Gauss-Legendre quadrature."""
        z = np.asarray(z, dtype=np.float64)
        x, w = np.polynomial.legendre.leggauss(n_quad)
        scalar = z.ndim == 0
        z = np.atleast_1d(z)
        nodes = 0.5 * z[..., None] * (x + 1.0)
        integral = 0.5 * z * np.sum(w * self.inv_efunc(nodes), axis=-1)
        result = self.hubble_distance * integral
        return result[0] if scalar else result

    def H(self, z):
        """Hubble parameter [km/s/Mpc]."""
        return self.H0 * self.efunc(z)

    def Om(self, z):
        z = np.asarray(z, dtype=np.float64)
        return self.Om0 * (1.0 + z)**3 / self.efunc(z)**2

    def critical_density(self, z):
        """Critical density [Msun/Mpc^3] (h-free, physical)."""
        h_si = self.H(z) * 1000.0 / _MPC_M
        rho = 3.0 * h_si**2 / (8.0 * np.pi * _G)  # kg/m^3
        msun = 1.98892e30
        return rho / msun * _MPC_M**3

    def __repr__(self):
        return (f"FlatFLRW(name={self.name}, H0={self.H0}, Om0={self.Om0}, "
                f"w0={self.w0}, wa={self.wa}, Neff={self.Neff}, "
                f"m_nu={list(self.m_nu)}, sigma8={self.sigma8}, ns={self.ns}, "
                f"alphas={self.alphas})")

    def __str__(self):
        return self.__repr__()


def FlatwCDM(H0, Om0, w0=-1.0, **kwargs):
    """Flat wCDM cosmology (reference: tabcorr/database.py:87-88)."""
    return FlatFLRW(H0=H0, Om0=Om0, w0=w0, wa=0.0, **kwargs)


def Flatw0waCDM(H0, Om0, w0=-1.0, wa=0.0, **kwargs):
    """Flat w0waCDM cosmology (reference: tabcorr/database.py:91-92)."""
    return FlatFLRW(H0=H0, Om0=Om0, w0=w0, wa=wa, **kwargs)


# Planck Collaboration XIII (2015) TT,TE,EE+lowP+lensing+ext parameters,
# identical to astropy.cosmology.Planck15.
Planck15 = FlatFLRW(H0=67.74, Om0=0.3089, Tcmb0=2.7255, Neff=3.046,
                    m_nu=(0.0, 0.0, 0.06), Ob0=0.0486, name="Planck15")
