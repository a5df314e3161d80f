"""HOD mock population: NFW satellite sampling, RSD, phase-space models.

The port's copy of ``tabcorr_tpu/mock.py``: host numpy throughout, with
every draw from the generator in the same order, so one seed gives the
same tracers bit for bit in both packages.

Replaces the halotools machinery the reference drives at tabulation time
(reference: tabcorr/tabcorr.py:237-279): the dummy dense mock (one central
per host halo + Poisson satellites tracing an NFW profile), redshift-space
distortions, and the velocity-bias phase-space models of the production
pipeline (reference: scripts/tabulate_snapshot.py:70-99).

Design notes
------------
* NFW radii come from the analytic enclosed-mass CDF inverted with a
  fixed-iteration Newton solve (vectorized; no lookup tables).
* Satellite velocities are isotropic Gaussians with the radius-dependent
  NFW Jeans dispersion, precomputed on a (concentration, radius) grid by
  numerical integration of the isotropic Jeans equation (what halotools
  tabulates with Cython lookup tables).
* Everything is vectorized over the flattened satellite array; the ragged
  halo->satellite expansion happens on the host (tabulation is a one-time
  offline step: the device's work is the pair counting that follows).
"""

from __future__ import annotations

import numpy as np

G_KMS_MPC_MSUN = 4.30091e-9  # G in km^2 s^-2 Mpc Msun^-1


def _nfw_g(u):
    return np.log1p(u) - u / (1.0 + u)


def nfw_sample_scaled_radii(conc, u):
    """Invert the NFW enclosed-mass CDF: scaled radius x = r/r_vir in (0, 1].

    Solves g(c x) = u g(c) with g(t) = ln(1+t) - t/(1+t) by Newton
    iterations on t = c x (g'(t) = t / (1+t)^2), vectorized over halos.
    """
    conc = np.asarray(conc, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    target = u * _nfw_g(conc)
    # Initial guess: small-t expansion g(t) ~ t^2/2 -> t = sqrt(2 target).
    t = np.sqrt(2.0 * np.maximum(target, 1e-12))
    for _ in range(40):
        f = _nfw_g(t) - target
        fp = t / (1.0 + t) ** 2
        t = np.clip(t - f / np.maximum(fp, 1e-30), 1e-9, conc)
    return t / conc


def nfw_jeans_dispersion_table(conc_grid=None, n_radii=64):
    """sigma_r(x|c) / V_vir lookup from the isotropic NFW Jeans equation.

    sigma_r^2(s) = (1 / rho(s)) * integral_s^inf rho(t) Gm(t) / t^2 dt
    with rho(t) proportional to 1/(c t (1 + c t)^2) and
    Gm(t) = g(c t)/g(c) in V_vir^2 r_vir units.
    """
    if conc_grid is None:
        conc_grid = np.geomspace(1.5, 40.0, 48)
    s_grid = np.geomspace(1e-3, 1.0, n_radii)
    # Integration nodes (log-spaced out to 1e3 r_vir).
    t_nodes = np.geomspace(1e-3, 1e3, 4096)
    log_t = np.log(t_nodes)
    dlog = np.gradient(log_t)

    table = np.empty((len(conc_grid), n_radii))
    for i, c in enumerate(conc_grid):
        rho = 1.0 / (c * t_nodes * (1.0 + c * t_nodes) ** 2)
        integrand = rho * _nfw_g(c * t_nodes) / _nfw_g(c) / t_nodes**2
        # cumulative from the outside in: I(s) = int_s^inf integrand dt
        contrib = integrand * t_nodes * dlog  # dt = t dlog t
        tail = np.cumsum(contrib[::-1])[::-1]
        # interp onto s_grid
        i_tail = np.interp(s_grid, t_nodes, tail)
        rho_s = 1.0 / (c * s_grid * (1.0 + c * s_grid) ** 2)
        table[i] = np.sqrt(np.maximum(i_tail / rho_s, 0.0))
    return np.log(conc_grid), np.log(s_grid), table


_JEANS_CACHE = {}


def nfw_sigma_v(conc, scaled_radius):
    """Interpolated sigma_r(x|c)/V_vir (bilinear in log c, log x)."""
    if "table" not in _JEANS_CACHE:
        log_c, log_s, table = nfw_jeans_dispersion_table()
        _JEANS_CACHE.update(log_c=log_c, log_s=log_s, table=table)
    log_c = _JEANS_CACHE["log_c"]
    log_s = _JEANS_CACHE["log_s"]
    table = _JEANS_CACHE["table"]

    lc = np.clip(np.log(conc), log_c[0], log_c[-1])
    ls = np.clip(np.log(scaled_radius), log_s[0], log_s[-1])
    ic = np.clip(np.searchsorted(log_c, lc) - 1, 0, len(log_c) - 2)
    isx = np.clip(np.searchsorted(log_s, ls) - 1, 0, len(log_s) - 2)
    wc = (lc - log_c[ic]) / (log_c[ic + 1] - log_c[ic])
    ws = (ls - log_s[isx]) / (log_s[isx + 1] - log_s[isx])
    return ((1 - wc) * (1 - ws) * table[ic, isx] +
            wc * (1 - ws) * table[ic + 1, isx] +
            (1 - wc) * ws * table[ic, isx + 1] +
            wc * ws * table[ic + 1, isx + 1])


def random_unit_vectors(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


class NFWPhaseSpace:
    """Satellite phase space: NFW positions + isotropic Jeans velocities.

    Parameters
    ----------
    conc_gal_bias : float, optional
        Multiplies the halo concentration for the satellite profile (the
        reference's ``conc_gal_bias`` / BiasedNFWPhaseSpace,
        scripts/tabulate_snapshot.py:70-81).
    alpha_s : float, optional
        Satellite velocity-dispersion scaling (ScaledBiasedNFWPhaseSpace).
    """

    def __init__(self, redshift=0.0, conc_gal_bias=1.0, alpha_s=1.0):
        self.redshift = redshift
        self.param_dict = {"conc_gal_bias": conc_gal_bias,
                           "alpha_s": alpha_s}

    def sample(self, rng, halo_pos, halo_vel, rvir, conc, mass):
        """Positions/velocities for one satellite per input row."""
        n = len(rvir)
        conc_eff = np.maximum(conc * self.param_dict["conc_gal_bias"], 1.01)
        x = nfw_sample_scaled_radii(conc_eff, rng.uniform(size=n))
        direction = random_unit_vectors(rng, n)
        pos = halo_pos + (x * rvir)[:, None] * direction

        rvir_phys = rvir / (1.0 + self.redshift)
        vvir = np.sqrt(G_KMS_MPC_MSUN * mass / rvir_phys)
        sigma = (nfw_sigma_v(conc_eff, x) * vvir *
                 self.param_dict["alpha_s"])
        vel = halo_vel + sigma[:, None] * rng.normal(size=(n, 3))
        return pos, vel


class TrivialPhaseSpace:
    """Centrals sit at the halo center with the halo velocity."""

    def __init__(self, redshift=0.0):
        self.redshift = redshift
        self.param_dict = {}

    def sample(self, rng, halo_pos, halo_vel, rvir, conc, mass):
        return halo_pos.copy(), halo_vel.copy()


class CentralVelocityBiasPhaseSpace(TrivialPhaseSpace):
    """Centrals with Gaussian velocity bias alpha_c * v_scale / sqrt(3)
    per component (reference: scripts/tabulate_snapshot.py:84-99)."""

    def __init__(self, redshift=0.0, alpha_c=0.0):
        super().__init__(redshift=redshift)
        self.param_dict = {"alpha_c": alpha_c}

    def sample(self, rng, halo_pos, halo_vel, rvir, conc, mass):
        pos, vel = halo_pos.copy(), halo_vel.copy()
        rvir_phys = rvir / (1.0 + self.redshift)
        vscale = np.sqrt(G_KMS_MPC_MSUN * mass / rvir_phys)
        vel = vel + (vscale[:, None] * rng.normal(size=vel.shape) *
                     self.param_dict["alpha_c"] / np.sqrt(3.0))
        return pos, vel


def populate_dense_mock(halocat, rng, sats_per_prim_haloprop,
                        prim_haloprop_key, num_ptcl_requirement,
                        cens_prof_model=None, sats_prof_model=None,
                        conc_key="halo_nfw_conc", rvir_key="halo_rvir",
                        mass_key="halo_mvir"):
    """The reference's dummy dense mock (tabcorr/tabcorr.py:237-262).

    Every selected host halo gets exactly one central; satellites are
    Poisson with mean ``sats_per_prim_haloprop * prim_haloprop`` (the
    reference sets zheng07 parameters so <N_cen> = 1 and
    <N_sat> = M * sats_per_prim_haloprop).

    Returns a dict of flat per-galaxy arrays: ``pos`` (N, 3), ``vel``
    (N, 3), ``log_prim``, ``sec_perc``, ``is_central`` and ``halo_index``
    (row into the selected host-halo table).
    """
    halos = halocat.host_halos(prim_haloprop_key, num_ptcl_requirement)
    n_halos = len(halos)
    prim = np.asarray(halos[prim_haloprop_key], dtype=np.float64)
    pos_h = np.column_stack([halos["halo_x"], halos["halo_y"],
                             halos["halo_z"]]).astype(np.float64)
    vel_h = np.column_stack([halos["halo_vx"], halos["halo_vy"],
                             halos["halo_vz"]]).astype(np.float64)
    rvir = np.asarray(halos[rvir_key], dtype=np.float64) \
        if rvir_key in halos else _rvir_from_mass(halocat, prim)
    conc = np.asarray(halos[conc_key], dtype=np.float64) \
        if conc_key in halos else np.full(n_halos, 5.0)
    mass = np.asarray(halos[mass_key], dtype=np.float64) \
        if mass_key in halos else prim

    if cens_prof_model is None:
        cens_prof_model = TrivialPhaseSpace(redshift=halocat.redshift)
    if sats_prof_model is None:
        sats_prof_model = NFWPhaseSpace(redshift=halocat.redshift)

    # Centrals: exactly one per host (the reference asserts this,
    # tabcorr/tabcorr.py:291-299).
    pos_c, vel_c = cens_prof_model.sample(rng, pos_h, vel_h, rvir, conc,
                                          mass)

    # Satellites: Poisson counts, flattened with np.repeat.
    n_sat = rng.poisson(sats_per_prim_haloprop * prim)
    sat_halo = np.repeat(np.arange(n_halos), n_sat)
    pos_s, vel_s = sats_prof_model.sample(
        rng, pos_h[sat_halo], vel_h[sat_halo], rvir[sat_halo],
        conc[sat_halo], mass[sat_halo])

    # Periodic wrap.
    lbox = halocat.Lbox
    pos = np.concatenate([pos_c, pos_s]) % lbox
    vel = np.concatenate([vel_c, vel_s])
    halo_index = np.concatenate([np.arange(n_halos), sat_halo])
    is_central = np.concatenate([np.ones(n_halos, dtype=bool),
                                 np.zeros(len(sat_halo), dtype=bool)])
    return {
        "pos": pos, "vel": vel, "halo_index": halo_index,
        "is_central": is_central, "halos": halos,
    }


def populate_mock(halocat, model, rng, prim_haloprop_key="halo_mvir",
                  num_ptcl_requirement=300, cens_prof_model=None,
                  sats_prof_model=None, conc_key="halo_nfw_conc",
                  rvir_key="halo_rvir"):
    """Populate a halo catalog with an HOD model realization.

    Equivalent of halotools' ``model.populate_mock`` for centrals-plus-
    satellites HODs: Bernoulli centrals with p = <N_cen>, Poisson
    satellites with mean <N_sat>, phase space from the profile models.
    Returns the same flat-array dict as :func:`populate_dense_mock`.
    """
    halos = halocat.host_halos(prim_haloprop_key, num_ptcl_requirement)
    n_halos = len(halos)
    prim = np.asarray(halos[prim_haloprop_key], dtype=np.float64)
    log_prim = np.log10(prim)
    if "sec_haloprop_percentile" in halos:
        sec_perc = np.asarray(halos["sec_haloprop_percentile"])
    else:
        sec_perc = np.full(n_halos, 0.5)

    n_cen_mean = np.asarray(model.occupation(
        model.param_dict, "centrals", log_prim, sec_perc))
    n_sat_mean = np.asarray(model.occupation(
        model.param_dict, "satellites", log_prim, sec_perc))

    has_central = rng.random(n_halos) < n_cen_mean
    n_sat = rng.poisson(n_sat_mean)

    pos_h = np.column_stack([halos["halo_x"], halos["halo_y"],
                             halos["halo_z"]]).astype(np.float64)
    vel_h = np.column_stack([halos["halo_vx"], halos["halo_vy"],
                             halos["halo_vz"]]).astype(np.float64)
    rvir = np.asarray(halos[rvir_key], dtype=np.float64) \
        if rvir_key in halos else _rvir_from_mass(halocat, prim)
    conc = np.asarray(halos[conc_key], dtype=np.float64) \
        if conc_key in halos else np.full(n_halos, 5.0)

    if cens_prof_model is None:
        cens_prof_model = TrivialPhaseSpace(redshift=halocat.redshift)
    if sats_prof_model is None:
        sats_prof_model = NFWPhaseSpace(redshift=halocat.redshift)

    cen_rows = np.flatnonzero(has_central)
    pos_c, vel_c = cens_prof_model.sample(
        rng, pos_h[cen_rows], vel_h[cen_rows], rvir[cen_rows],
        conc[cen_rows], prim[cen_rows])
    sat_rows = np.repeat(np.arange(n_halos), n_sat)
    pos_s, vel_s = sats_prof_model.sample(
        rng, pos_h[sat_rows], vel_h[sat_rows], rvir[sat_rows],
        conc[sat_rows], prim[sat_rows])

    pos = np.concatenate([pos_c, pos_s]) % halocat.Lbox
    vel = np.concatenate([vel_c, vel_s])
    halo_index = np.concatenate([cen_rows, sat_rows])
    is_central = np.concatenate([np.ones(len(cen_rows), dtype=bool),
                                 np.zeros(len(sat_rows), dtype=bool)])
    return {"pos": pos, "vel": vel, "halo_index": halo_index,
            "is_central": is_central, "halos": halos}


def _rvir_from_mass(halocat, mass):
    """Virial radius from mass for Delta = 200 rho_m (fallback)."""
    rho_m = (halocat.cosmology.critical_density(0.0) *
             halocat.cosmology.Om0 / halocat.cosmology.h**2)
    return (3 * mass / (4 * np.pi * 200 * rho_m)) ** (1.0 / 3.0) * \
        (1 + halocat.redshift)


def apply_redshift_space_distortions(pos, vel_z, redshift, cosmology, lbox_z):
    """Shift z by the peculiar-velocity displacement v (1+z) / H(z).

    Matches halotools' ``return_xyz_formatted_array`` velocity distortion
    (used at reference tabcorr/tabcorr.py:272-277): comoving displacement
    in h^-1 Mpc with H(z) = 100 E(z) h km/s/Mpc.
    """
    displacement = vel_z * (1 + redshift) / (
        100.0 * cosmology.efunc(redshift))
    return (pos + displacement) % lbox_z
