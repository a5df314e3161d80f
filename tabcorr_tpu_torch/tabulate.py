"""The tabulation engine: halo binning, mock population, pair counting.

Port of ``tabcorr_tpu/tabulate.py`` (reference: tabcorr/tabcorr.py:24-372).
Instead of farming O(n_bins^2 / 2) ragged pair-count tasks to a process
pool (reference: tabcorr/tabcorr.py:846-922), tracers carry an integer
(prim-bin x sec-bin x gal-type) label and ONE labeled sweep on the device
produces the entire counts[bin_1, bin_2, r] tensor per projection -- the
CUDA pair counter on the card (``ops/paircount.py``, ``csrc/
paircount.cu``), its plain version on the CPU; the per-bin-pair estimators
are then closed-form array operations against the analytic random counts.
Everything else (binning, percentiles, the dense mock, the estimators) is
host numpy, drawing from the generator in tabcorr_tpu's order, so one seed
gives the same tracers and the same tables in both packages.

Statistics with a fast path: 'wp' (projected), 's_mu_tpcf' (redshift-space
(s, mu)), 'tpcf' (real-space xi(r)), 'mean_delta_sigma' (galaxy-particle
lensing).  Any other halotools-signature callable falls back to a generic
per-bin-pair loop.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import interp1d

from .io import ColumnTable, vstack
from .mock import (NFWPhaseSpace, TrivialPhaseSpace,
                   apply_redshift_space_distortions, populate_dense_mock)
from .ops import paircount
from .utils.device import resolve_device
from .utils.packing import symmetric_matrix_to_array
from .utils.progress import progress as progress_bar


def compute_conditional_percentiles(prim_haloprop, sec_haloprop,
                                    dlog_prim=0.05):
    """Rank percentile of the secondary property at fixed primary property.

    Equivalent of halotools' ``compute_conditional_percentiles`` (used at
    reference tabcorr/tabcorr.py:187-190): within bins of
    ``dlog_prim`` dex in the primary property, percentile =
    (rank + 1) / count in (0, 1].
    """
    log_prim = np.log10(prim_haloprop)
    edges = np.arange(log_prim.min(), log_prim.max() + dlog_prim,
                      dlog_prim)
    bin_index = np.clip(np.digitize(log_prim, edges) - 1, 0,
                        max(len(edges) - 2, 0))
    percentile = np.empty(len(prim_haloprop), dtype=np.float64)
    order = np.argsort(bin_index, kind="stable")
    bins_sorted = bin_index[order]
    boundaries = np.flatnonzero(np.diff(bins_sorted)) + 1
    for seg in np.split(order, boundaries):
        sec = sec_haloprop[seg]
        ranks = np.empty(len(seg), dtype=np.float64)
        ranks[np.argsort(sec, kind="stable")] = np.arange(1, len(seg) + 1)
        percentile[seg] = ranks / len(seg)
    return percentile


def distribution_index(x_min, x_max, x_mean):
    """Effective power-law index reproducing a bin's mean
    (reference: tabcorr/tabcorr.py:740-767).

    Finds n such that p(x) ~ x^n on [x_min, x_max] has mean x_mean: a
    cubic inverse interpolation on n in [-10, 10] (the reference's
    method) seeds a Newton refinement, so the fitted measure reproduces
    the bin's mean halo mass to machine precision — which makes the
    mean-occupation quadrature exact for occupations linear in mass,
    and the wp/ds number densities binning-independent at the 1e-4
    cross-check level (reference: tests/test_database.py:29-31).
    """
    x_max = x_max / x_min
    x_mean = x_mean / x_min

    def mean_of(n):
        return ((n + 1) / (n + 2) *
                (x_max ** (n + 2) - 1) / (x_max ** (n + 1) - 1))

    n_grid = np.linspace(-10, 10, 100)
    n = float(interp1d(mean_of(n_grid), n_grid, kind="cubic",
                       fill_value=(-10.0, 10.0), bounds_error=False)(
                           x_mean))
    if not -10.0 < n < 10.0:
        return float(np.clip(n, -10.0, 10.0))
    # Newton with numeric derivative; mean_of is smooth and monotone in n
    # (singularities at n = -1, -2 are removable and never hit exactly).
    for _ in range(8):
        f = mean_of(n) - x_mean
        h = 1e-6
        df = (mean_of(n + h) - mean_of(n - h)) / (2 * h)
        if not np.isfinite(f) or not np.isfinite(df) or df == 0:
            break
        step = f / df
        n_new = float(np.clip(n - step, -10.0, 10.0))
        if abs(n_new - n) < 1e-12:
            n = n_new
            break
        n = n_new
    return n


def sort_into_bins(log_prim_haloprop, log_prim_haloprop_bins,
                   sec_haloprop_percentile, sec_haloprop_percentile_bins,
                   x, gal_type=None):
    """Sort an array into (prim x sec x type) bins; ragged list output.

    API-parity utility (reference: tabcorr/tabcorr.py:686-737); the fast
    tabulation path uses integer labels instead (see
    :func:`bin_labels`).
    """
    labels, n_bins = bin_labels(
        log_prim_haloprop, log_prim_haloprop_bins, sec_haloprop_percentile,
        sec_haloprop_percentile_bins, gal_type)
    keep = labels >= 0
    x = np.asarray(x)[keep]
    labels = labels[keep]
    order = np.argsort(labels, kind="stable")
    x_sorted = x[order]
    counts = np.bincount(labels, minlength=n_bins)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return [x_sorted[starts[i]:starts[i + 1]] for i in range(n_bins)]


def bin_labels(log_prim, log_prim_bins, sec_perc, sec_perc_bins,
               gal_type=None):
    """Integer (prim x sec x type) bin label per tracer; -1 = out of range.

    Label layout matches the reference's flattened ordering
    (reference: tabcorr/tabcorr.py:731): prim fastest, then sec, then type.
    """
    n_p = len(log_prim_bins) - 1
    n_s = len(sec_perc_bins) - 1
    i_prim = np.digitize(log_prim, log_prim_bins) - 1
    i_sec = np.digitize(sec_perc, sec_perc_bins) - 1
    bad = (i_prim < 0) | (i_prim >= n_p) | (i_sec < 0) | (i_sec >= n_s)
    if gal_type is not None:
        i_type = np.where(np.asarray(gal_type), 0, 1)  # True = central
        n_t = 2
    else:
        i_type = 0
        n_t = 1
    labels = i_prim + i_sec * n_p + i_type * n_p * n_s
    return np.where(bad, -1, labels).astype(np.int32), n_p * n_s * n_t


def _resolve_bins(halos, prim_haloprop_key, prim_haloprop_bins,
                  sec_haloprop_percentile_bins):
    """Bin-edge construction (reference: tabcorr/tabcorr.py:160-185).

    Unlike the reference, passing a list/array of log prim bins works
    (the reference's isinstance chain references an unassigned name there).
    """
    if isinstance(prim_haloprop_bins, int):
        log_prim = np.log10(halos[prim_haloprop_key])
        log_prim_bins = np.linspace(log_prim.min() - 1e-3,
                                    log_prim.max() + 1e-3,
                                    prim_haloprop_bins + 1)
    elif isinstance(prim_haloprop_bins, (list, np.ndarray)):
        log_prim_bins = np.asarray(prim_haloprop_bins, dtype=np.float64)
    else:
        raise ValueError("prim_haloprop_bins must be an int, list or "
                         "numpy array.")

    bins = sec_haloprop_percentile_bins
    if bins is None:
        sec_bins = np.array([-1e-3, 1 + 1e-3])
    elif isinstance(bins, float):
        if not 0 < bins < 1:
            raise ValueError("sec_haloprop_percentile_bins must be "
                             "between 0 and 1.")
        sec_bins = np.array([-1e-3, bins, 1 + 1e-3])
    elif isinstance(bins, int):
        sec_bins = np.linspace(-1e-3, 1 + 1e-3, bins + 1)
    elif isinstance(bins, (list, np.ndarray)):
        sec_bins = np.asarray(bins, dtype=np.float64)
    else:
        raise ValueError("sec_haloprop_percentile_bins must be an int, "
                         "float, list or numpy array.")
    return log_prim_bins, sec_bins


def _ap_stretch(halocat, cosmology_obs, mode):
    """Alcock-Paczynski stretch (reference: tabcorr/tabcorr.py:142-152)."""
    if cosmology_obs is None or mode != "auto":
        return np.ones(3)
    z = halocat.redshift
    cosmo = halocat.cosmology
    if z > 0:
        rp_stretch = ((cosmology_obs.comoving_distance(z) *
                       cosmology_obs.H0) /
                      (cosmo.comoving_distance(z) * cosmo.H0))
    else:
        # z -> 0 limit: D_C -> c z / H0, so the ratio tends to exactly 1.
        rp_stretch = 1.0
    pi_stretch = cosmo.efunc(z) / cosmology_obs.efunc(z)
    return np.array([rp_stretch, rp_stretch, pi_stretch])


class _FastPath:
    """Per-statistic estimator over the labeled count tensor."""

    def __init__(self, tpcf_name, tpcf_args, tpcf_kwargs, device="cuda",
                 backend="device", mesh=None):
        self.name = tpcf_name
        self.device = device
        self.mesh = mesh
        # 'device': the CUDA pair counter or its plain version, by device;
        # 'native': the host C++ counter (tabcorr_tpu_torch.native).
        self.strategy = {"device": None, "native": "native"}[backend]
        if tpcf_name == "wp":
            self.rp_bins = np.asarray(tpcf_args[0], dtype=np.float64)
            self.pi_max = float(
                tpcf_args[1] if len(tpcf_args) > 1
                else tpcf_kwargs["pi_max"])
            self.shape = (len(self.rp_bins) - 1,)
        elif tpcf_name == "s_mu_tpcf":
            self.s_bins = np.asarray(tpcf_args[0], dtype=np.float64)
            self.mu_bins = np.asarray(tpcf_args[1], dtype=np.float64)
            self.shape = (len(self.s_bins) - 1, len(self.mu_bins) - 1)
        elif tpcf_name == "tpcf":
            # xi(r) shares the (s, mu) machinery with a single mu bin.
            self.r_bins = np.asarray(tpcf_args[0], dtype=np.float64)
            self.s_bins = self.r_bins
            self.mu_bins = np.array([0.0, 1.0])
            self.shape = (len(self.r_bins) - 1,)
        elif tpcf_name == "mean_delta_sigma":
            self.ptcl_pos = np.asarray(tpcf_args[0], dtype=np.float64)
            self.ptcl_mass = tpcf_args[1]
            self.rp_bins = np.asarray(tpcf_args[2], dtype=np.float64)
            self.estimator = tpcf_kwargs.get("estimator", "annulus_mean")
            self.shape = (len(self.rp_bins) - 1,)
        else:
            raise ValueError(tpcf_name)

    def _count(self, *args, **kwargs):
        return paircount.labeled_pair_count(
            *args, **kwargs, strategy=self.strategy, device=self.device,
            mesh=self.mesh)

    def matrix_auto(self, pos, labels, n_bins, period, progress=False):
        """Dense (n_xi, n_bins, n_bins) matrix from one labeled sweep."""
        n_tracers = np.bincount(labels[labels >= 0], minlength=n_bins)
        volume = np.prod(period)
        outer = np.outer(n_tracers, n_tracers).astype(np.float64)

        if self.name == "wp":
            counts = self._count(
                pos, labels, n_bins, period=period, kind="rppi",
                r_edges=self.rp_bins, pi_max=self.pi_max, progress=progress)
            n_exp = (outer[:, :, None] / volume * np.pi *
                     np.diff(self.rp_bins**2) * 2 * self.pi_max)
            with np.errstate(invalid="ignore", divide="ignore"):
                xi = (counts / n_exp - 1) * 2 * self.pi_max
            xi[outer == 0] = 0.0
            return np.moveaxis(xi, -1, 0)

        if self.name in ("s_mu_tpcf", "tpcf"):
            counts = self._count(
                pos, labels, n_bins, period=period, kind="smu",
                r_edges=self.s_bins, mu_edges=self.mu_bins,
                progress=progress)
            n_mu = len(self.mu_bins) - 1
            n_exp = (outer[:, :, None, None] / volume * 4 * np.pi / 3 *
                     np.diff(self.s_bins**3)[:, None] / n_mu)
            with np.errstate(invalid="ignore", divide="ignore"):
                xi = counts / n_exp - 1
            xi[outer == 0] = 0.0
            return np.moveaxis(xi.reshape(n_bins, n_bins, -1), -1, 0)

        raise ValueError(f"{self.name} is a cross statistic.")

    def matrix_cross(self, pos, labels, n_bins, period, progress=False):
        """Dense (n_xi, n_bins) matrix for a cross statistic."""
        if self.name != "mean_delta_sigma":
            raise ValueError(f"{self.name} is an auto statistic.")
        n_tracers = np.bincount(labels[labels >= 0],
                                minlength=n_bins).astype(np.float64)
        masses = np.asarray(self.ptcl_mass, dtype=np.float64)
        if masses.ndim == 0:
            masses = np.full(len(self.ptcl_pos), masses)

        if self.estimator == "annulus_mean":
            from .ops.paircount import delta_sigma_from_mass_profiles

            edges = np.concatenate([[0.0], self.rp_bins])
            # One dual-channel sweep: pair enumeration dominates the
            # delta-sigma tabulation, and both the mass and mass*ln(rp)
            # histograms come from the same pairs.
            both = self._count(
                pos, labels, n_bins, pos2=self.ptcl_pos, weights2=masses,
                period=period, kind="proj", r_edges=edges,
                pair_weight="unit+log_rp", progress=progress)
            mass, log_mass = both[0, :, 0, :], both[1, :, 0, :]
            mass_in = np.cumsum(mass, axis=-1)[:, :-1]
            with np.errstate(invalid="ignore", divide="ignore"):
                ds = delta_sigma_from_mass_profiles(
                    self.rp_bins, mass_in, mass[:, 1:], log_mass[:, 1:],
                    n_tracers[:, None])
            ds[n_tracers == 0] = 0.0
            return ds.T

        # 'midpoint': deduplicated edge list (a geometric mid can coincide
        # bitwise with a bin edge); cylinder masses looked up by
        # searchsorted index, never by float dict key.
        rp_mids = np.sqrt(self.rp_bins[:-1] * self.rp_bins[1:])
        all_edges = np.unique(
            np.concatenate([[0.0], self.rp_bins, rp_mids]))
        counts = self._count(
            pos, labels, n_bins, pos2=self.ptcl_pos, weights2=masses,
            period=period, kind="proj", r_edges=all_edges,
            progress=progress)[:, 0, :]
        cum = np.concatenate(
            [np.zeros((n_bins, 1)), np.cumsum(counts, axis=-1)], axis=-1)

        def mass_at(r):
            return cum[:, np.searchsorted(all_edges, r)]

        with np.errstate(invalid="ignore", divide="ignore"):
            sigma_bar = mass_at(rp_mids) / (
                np.pi * rp_mids**2 * n_tracers[:, None])
            annulus = mass_at(self.rp_bins[1:]) - mass_at(self.rp_bins[:-1])
            sigma = annulus / (np.pi * np.diff(self.rp_bins**2) *
                               n_tracers[:, None])
            ds = sigma_bar - sigma
        ds[n_tracers == 0] = 0.0
        return ds.T

    def args_for_file(self):
        if self.name == "wp":
            return (self.rp_bins,), {"pi_max": self.pi_max}
        if self.name == "s_mu_tpcf":
            return (self.s_bins, self.mu_bins), {}
        if self.name == "tpcf":
            return (self.r_bins,), {}
        kwargs = ({} if self.estimator == "annulus_mean"
                  else {"estimator": self.estimator})
        return (self.ptcl_pos, self.ptcl_mass, self.rp_bins), kwargs


_FAST_TPCFS = {"wp", "s_mu_tpcf", "tpcf", "mean_delta_sigma"}


def tabulate(cls, halocat, tpcf, *tpcf_args, mode="auto",
             Num_ptcl_requirement=300, prim_haloprop_key="halo_mvir",
             prim_haloprop_bins=30, sec_haloprop_key="halo_nfw_conc",
             sec_haloprop_percentile_bins=None,
             sats_per_prim_haloprop=3e-12, downsample=1.0, verbose=False,
             redshift_space_distortions=True, cens_prof_model=None,
             sats_prof_model=None, project_xyz=False, cosmology_obs=None,
             num_threads=1, seed=None, mesh=None, backend="device",
             device="cuda", **tpcf_kwargs):
    """Tabulate halo correlation functions.

    Signature-compatible with the reference (tabcorr/tabcorr.py:24-34) and
    with tabcorr_tpu's ``tabulate``; ``tpcf`` may be one of this package's
    statistics (``wp``, ``s_mu_tpcf``, ``tpcf`` (real-space xi(r)),
    ``mean_delta_sigma`` from :mod:`tabcorr_tpu_torch.corrfunc`, or their
    names as strings) for the labeled fast path, or any halotools-signature
    callable for the generic path.  ``seed`` fixes the mock-population
    randomness.  ``num_threads`` runs the generic path's callables on a
    thread pool (the fast path ignores it).  ``device``: where the pair
    counts run, 'cuda' (default, the CUDA pair counter) or 'cpu' (its
    plain version).  ``backend='native'`` counts the fast path's pairs
    with the host C++ counter (:mod:`tabcorr_tpu_torch.native`, float64
    geometry) and takes ``device='cpu'`` only.  ``verbose`` prints the
    tracer count and reports the sweeps' progress.  ``mesh`` shards every
    pair-count sweep of the fast path over a mesh's first dimension
    (``ops.paircount.labeled_pair_count(mesh=)``): every rank of the world
    calls with the same catalog and seed and gets the same table.
    """
    if mesh is not None and backend == "native":
        raise ValueError("backend='native' counts on one host and takes no "
                         "mesh.")
    if backend not in ("device", "native"):
        raise ValueError(f"Unknown backend {backend!r}; use 'device' or "
                         "'native'.")
    if backend == "native" and (device is None or
                                torch.device(device).type != "cpu"):
        raise ValueError("backend='native' counts on the host: pass "
                         "device='cpu'.")
    device = resolve_device(device)
    if "period" in tpcf_kwargs:
        # The reference warns and overrides (tabcorr/tabcorr.py:134-138).
        print("Warning: TabCorr will pass the box size of the halo catalog "
              "as the 'period' argument. The value you provided will be "
              "ignored.")
        del tpcf_kwargs["period"]

    tpcf_name = tpcf if isinstance(tpcf, str) else tpcf.__name__
    fast = tpcf_name in _FAST_TPCFS
    if mesh is not None and not fast:
        raise ValueError(f"mesh shards the fast path's sweeps; {tpcf_name} "
                         "runs on the generic path.")
    rng = np.random.default_rng(seed)

    halotab = cls()
    lbox_stretch = _ap_stretch(halocat, cosmology_obs, mode)

    halos = halocat.host_halos(prim_haloprop_key, Num_ptcl_requirement)
    log_prim_bins, sec_bins = _resolve_bins(
        halos, prim_haloprop_key, prim_haloprop_bins,
        sec_haloprop_percentile_bins)

    sec_percentile = compute_conditional_percentiles(
        np.asarray(halos[prim_haloprop_key], dtype=np.float64),
        np.asarray(halos[sec_haloprop_key], dtype=np.float64))

    # --- gal_type table (reference: tabcorr/tabcorr.py:192-234) ---------
    log_prim_halos = np.log10(halos[prim_haloprop_key])
    n_h, _, _ = np.histogram2d(log_prim_halos, sec_percentile,
                               bins=[log_prim_bins, sec_bins])
    n_p, n_s = len(log_prim_bins) - 1, len(sec_bins) - 1
    n_half = n_p * n_s

    gal_type = ColumnTable()
    gal_type["n_h"] = n_h.ravel(order="F")
    grid_p, grid_s = np.meshgrid(log_prim_bins, sec_bins)
    gal_type["log_prim_haloprop_min"] = grid_p[:-1, :-1].ravel()
    gal_type["log_prim_haloprop_max"] = grid_p[:-1, 1:].ravel()
    gal_type["sec_haloprop_percentile_min"] = grid_s[:-1, :-1].ravel()
    gal_type["sec_haloprop_percentile_max"] = grid_s[1:, :-1].ravel()
    gal_type["prim_haloprop"] = 10 ** (
        0.5 * (gal_type["log_prim_haloprop_min"] +
               gal_type["log_prim_haloprop_max"]))
    gal_type["sec_haloprop_percentile"] = 0.5 * (
        gal_type["sec_haloprop_percentile_min"] +
        gal_type["sec_haloprop_percentile_max"])

    halo_labels, _ = bin_labels(log_prim_halos, log_prim_bins,
                                sec_percentile, sec_bins)
    dist_index = np.zeros(n_half)
    prim_values = np.asarray(halos[prim_haloprop_key], dtype=np.float64)
    for i in range(n_half):
        in_bin = halo_labels == i
        if np.any(in_bin):
            dist_index[i] = distribution_index(
                10 ** gal_type["log_prim_haloprop_min"][i],
                10 ** gal_type["log_prim_haloprop_max"][i],
                prim_values[in_bin].mean())
    gal_type["prim_haloprop_dist_index"] = dist_index

    # Duplicate rows for centrals/satellites (reference: :229-234).
    gal_type = vstack([gal_type, gal_type])
    gal_type["gal_type"] = np.concatenate([
        np.repeat(b"centrals", n_half), np.repeat(b"satellites", n_half)])
    halotab.gal_type = gal_type

    # --- dense dummy mock (reference: tabcorr/tabcorr.py:237-262) -------
    if cens_prof_model is None:
        cens_prof_model = TrivialPhaseSpace(redshift=halocat.redshift)
    if sats_prof_model is None:
        sats_prof_model = NFWPhaseSpace(redshift=halocat.redshift)
    mock = populate_dense_mock(
        halocat, rng, sats_per_prim_haloprop, prim_haloprop_key,
        Num_ptcl_requirement, cens_prof_model=cens_prof_model,
        sats_prof_model=sats_prof_model, mass_key=prim_haloprop_key)

    gal_log_prim = log_prim_halos[mock["halo_index"]]
    gal_sec_perc = sec_percentile[mock["halo_index"]]
    gal_prim = prim_values[mock["halo_index"]]
    labels_full, n_bins_total = bin_labels(
        gal_log_prim, log_prim_bins, gal_sec_perc, sec_bins,
        gal_type=mock["is_central"])

    if verbose:
        print(f"Number of tracer particles: {len(labels_full)}")

    # Consistency checks (reference: tabcorr/tabcorr.py:289-304).
    cen_counts = np.bincount(labels_full[(labels_full >= 0) &
                                         (labels_full < n_half)],
                             minlength=n_half)
    if not np.array_equal(cen_counts, gal_type["n_h"][:n_half].astype(int)):
        raise RuntimeError("There was an internal error in TabCorr.")
    sat_counts = np.bincount(
        labels_full[labels_full >= n_half] - n_half, minlength=n_half)
    if np.any((sat_counts == 0) & (gal_type["n_h"][:n_half] > 0)):
        raise RuntimeError(
            "There was at least one bin without satellite tracers. "
            "Increase sats_per_prim_haloprop.")

    # Downsampling (reference: tabcorr/tabcorr.py:306-322).
    if isinstance(downsample, float):
        frac = np.full(len(labels_full), downsample)
    else:
        frac = np.minimum(downsample(gal_prim), 1.0)
    keep = rng.random(len(labels_full)) < frac
    # Force >= 2 tracers per non-empty bin.  Deficient bins are found with
    # two bincounts and repaired via a grouped index array, touching each
    # tracer O(1) times total (the naive per-bin full-array mask scan is
    # O(n_bins * n_tracers) — prohibitive at the published ds config).
    valid = labels_full >= 0
    total_counts = np.bincount(labels_full[valid], minlength=n_bins_total)
    kept_counts = np.bincount(labels_full[valid & keep],
                              minlength=n_bins_total)
    deficient = np.flatnonzero(
        ((total_counts > 1) & (kept_counts <= 1)) | (total_counts == 1))
    if len(deficient):
        idx_by_label = np.flatnonzero(valid)[
            np.argsort(labels_full[valid], kind="stable")]
        starts = np.concatenate([[0], np.cumsum(total_counts)])
        for label in deficient:
            group = idx_by_label[starts[label]:starts[label + 1]]
            if len(group) == 1:
                keep[group] = True
            else:
                keep[rng.choice(group, size=2, replace=False)] = True
    keep &= valid

    pos_raw = mock["pos"][keep]
    vel_raw = mock["vel"][keep]
    labels = labels_full[keep]

    fast_path = _FastPath(tpcf_name, tpcf_args, tpcf_kwargs,
                          device=device, backend=backend,
                          mesh=mesh) if fast else None
    tpcf_matrix = None
    period = halocat.Lbox * lbox_stretch

    for xyz in ["xyz", "yzx", "zxy"]:
        if verbose and project_xyz:
            print(f"Projecting onto {xyz[2]}-axis...")
        axes = ["xyz".index(c) for c in xyz]
        pos = pos_raw[:, axes].copy()
        if redshift_space_distortions:
            pos[:, 2] = apply_redshift_space_distortions(
                pos[:, 2], vel_raw[:, axes[2]], halocat.redshift,
                halocat.cosmology, halocat.Lbox[axes[2]])
        pos = pos * lbox_stretch

        if fast:
            if mode == "auto":
                matrix = fast_path.matrix_auto(pos, labels, n_bins_total,
                                               period, progress=verbose)
            else:
                matrix = fast_path.matrix_cross(pos, labels, n_bins_total,
                                                period, progress=verbose)
            shape = fast_path.shape
        else:
            matrix, shape = _generic_tpcf_matrix(
                mode, pos, labels, n_bins_total, tpcf, period, tpcf_args,
                tpcf_kwargs, verbose, num_threads=num_threads)

        tpcf_matrix = matrix if tpcf_matrix is None else \
            tpcf_matrix + matrix
        if not project_xyz or mode == "cross":
            break

    if project_xyz and mode == "auto":
        tpcf_matrix /= 3.0

    if mode == "auto":
        tpcf_matrix = np.stack([
            symmetric_matrix_to_array(tpcf_matrix[i], check_symmetry=False)
            for i in range(tpcf_matrix.shape[0])])

    # Drop empty bins; densities (reference: tabcorr/tabcorr.py:346-354).
    use = gal_type["n_h"] != 0
    halotab.gal_type = gal_type[use]
    if mode == "auto":
        use = symmetric_matrix_to_array(np.outer(use, use),
                                        check_symmetry=False) > 0
    tpcf_matrix = tpcf_matrix[:, use]
    halotab.gal_type["n_h"] = (halotab.gal_type["n_h"] /
                               np.prod(halocat.Lbox * lbox_stretch))

    halotab.attrs = {
        "tpcf": tpcf_name, "mode": mode, "simname": halocat.simname,
        "redshift": halocat.redshift,
        "Num_ptcl_requirement": Num_ptcl_requirement,
        "prim_haloprop_key": prim_haloprop_key,
        "sec_haloprop_key": sec_haloprop_key}
    if fast and fast_path.name == "mean_delta_sigma":
        # Record the delta-sigma estimator convention in the file: the
        # default 'annulus_mean' is the exact area-weighted annulus
        # average (closed form from pair-count sums); 'midpoint'
        # evaluates sigma_bar(<r_mid) - sigma(annulus) at the geometric
        # bin center, the convention closest to halotools'
        # mean_delta_sigma used for the published reference tables
        # (reference: scripts/tabulate_snapshot.py:235-237).  The two
        # differ at O((dr/r)^2), quantified in
        # tests/test_delta_sigma.py::test_estimator_difference_is_below_
        # table_validation_tolerance.
        halotab.attrs["delta_sigma_estimator"] = fast_path.estimator

    if fast:
        args, kwargs = fast_path.args_for_file()
        halotab.tpcf_args = args
        halotab.tpcf_kwargs = kwargs
        halotab.tpcf_shape = fast_path.shape
    else:
        halotab.tpcf_args = tpcf_args
        halotab.tpcf_kwargs = tpcf_kwargs
        halotab.tpcf_shape = shape
    halotab.tpcf_matrix = tpcf_matrix
    return halotab


def compute_tpcf_matrix(mode, pos, tpcf, period, tpcf_args, tpcf_kwargs,
                        num_threads=1, verbose=False, *, device="cuda"):
    """Correlation-function matrix between ragged per-bin samples.

    Signature-compatible with the reference's module helper
    (reference: tabcorr/tabcorr.py:846-922) for code that drives the
    bin-pair computation directly: ``pos`` is a list of per-bin position
    arrays; returns (tpcf_matrix, tpcf_shape) with the matrix dense
    (n_xi, n_bins[, n_bins]).  ``num_threads > 1`` farms arbitrary
    callables over a thread pool (the built-in statistics are
    device-parallel and ignore it).  ``device``: where the built-in
    statistics count pairs.
    """
    labels = np.concatenate([
        np.full(len(p), i, dtype=np.int32) for i, p in enumerate(pos)])
    flat_pos = np.concatenate([np.asarray(p).reshape(-1, 3) for p in pos]) \
        if any(len(p) for p in pos) else np.zeros((0, 3))

    tpcf_name = tpcf if isinstance(tpcf, str) else tpcf.__name__
    if tpcf_name in _FAST_TPCFS:
        fast = _FastPath(tpcf_name, tpcf_args, tpcf_kwargs,
                         device=resolve_device(device))
        if mode == "auto":
            matrix = fast.matrix_auto(flat_pos, labels, len(pos), period)
        else:
            matrix = fast.matrix_cross(flat_pos, labels, len(pos), period)
        return matrix, fast.shape
    return _generic_tpcf_matrix(mode, flat_pos, labels, len(pos), tpcf,
                                period, tpcf_args, tpcf_kwargs, verbose,
                                num_threads=num_threads)


def _generic_tpcf_matrix(mode, pos, labels, n_bins, tpcf, period,
                         tpcf_args, tpcf_kwargs, verbose, num_threads=1):
    """Generic per-bin-pair farm for arbitrary halotools-signature tpcfs.

    The built-in statistics use the labeled device sweep instead; this
    path exists for API completeness with custom callables and fills the
    role of the reference's process-pool farm
    (reference: tabcorr/tabcorr.py:846-922): tasks are all occupied bins
    (cross) or bin-pairs (auto), shuffled for load balance, executed on a
    ``num_threads``-wide thread pool.  Threads rather than processes:
    realistic generic callables are GIL-releasing native pair counters
    (Corrfunc, Cython), and forking a process that holds a live CUDA
    context is unsafe.
    """
    import itertools

    pos_bins = [pos[labels == i] for i in range(n_bins)]
    occupied = [i for i in range(n_bins) if len(pos_bins[i]) > 0]

    if mode == "auto":
        tasks = list(itertools.combinations_with_replacement(occupied, 2))
    else:
        tasks = list(occupied)

    def worker(task):
        if mode == "auto":
            i_1, i_2 = task
            if len(pos_bins[i_1]) > len(pos_bins[i_2]):
                i_1, i_2 = i_2, i_1
            xi = tpcf(pos_bins[i_1], *tpcf_args,
                      sample2=pos_bins[i_2] if i_1 != i_2 else None,
                      do_auto=i_1 == i_2, do_cross=i_1 != i_2,
                      period=period, **tpcf_kwargs)
        else:
            xi = tpcf(pos_bins[task], *tpcf_args, period=period,
                      **tpcf_kwargs)
        return task, np.asarray(xi)

    if num_threads is not None and num_threads > 1 and len(tasks) > 1:
        from concurrent.futures import ThreadPoolExecutor

        # Shuffle so expensive (high-occupancy) tasks spread over workers.
        shuffled = list(tasks)
        np.random.default_rng(42).shuffle(shuffled)
        with ThreadPoolExecutor(num_threads) as pool:
            results = list(progress_bar(pool.map(worker, shuffled),
                                        total=len(shuffled),
                                        disable=not verbose))
    else:
        results = [worker(task) for task in progress_bar(
            tasks, total=len(tasks), disable=not verbose)]

    tpcf_matrix = None
    tpcf_shape = None
    for task, xi in results:
        if tpcf_matrix is None:
            if mode == "auto":
                tpcf_matrix = np.zeros((xi.size, n_bins, n_bins))
            else:
                tpcf_matrix = np.zeros((xi.size, n_bins))
            tpcf_shape = xi.shape
        if mode == "auto":
            tpcf_matrix[:, task[0], task[1]] = xi.ravel()
            tpcf_matrix[:, task[1], task[0]] = xi.ravel()
        else:
            tpcf_matrix[:, task] = xi.ravel()

    return tpcf_matrix, tpcf_shape
