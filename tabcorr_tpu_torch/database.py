"""Database of published tabulations: configs, cosmologies, paths, reading.

The port's copy of ``tabcorr_tpu/database.py`` (reference:
tabcorr/database.py): a string-keyed tabulation-configuration registry with
mixin precedence, cosmology registries for the AbacusSummit and AemulusAlpha
simulation suites (built from the public release parameter tables copied
into ``tabcorr_tpu_torch/data/``), the on-disk layout of the published
tabulation database, and ``read()``, which loads the port's
:class:`~.interpolator.Interpolator` from HDF5 (h5py is imported there, at
the read, so the rest needs numpy alone) or from its ``.npz`` copy.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np

from .cosmology import FlatFLRW, Planck15
from .interpolator import Interpolator

_DATA_DIR = Path(__file__).absolute().parent / "data"

# Conversion from omega_ncdm (physical neutrino density) to neutrino mass:
# m_nu = omega_ncdm * 93.04 eV (reference: tabcorr/database.py:127).
_OMEGA_NU_TO_EV = 93.04


def configuration(config_str):
    """Tabulation configuration registry (reference: database.py:14-71).

    ``config_str`` may mix configurations with underscores, e.g.
    ``'efficient_aemulus'``; earlier entries take precedence, and
    ``'default'`` always backstops.
    """
    config_list = config_str.split("_")
    for config in config_list:
        if config not in ["aemulus", "default", "efficient"]:
            raise ValueError(f"Unknown configuration {config}.")
    config_list.append("default")

    registry = {
        "s_bins": {"default": np.logspace(-1.0, 1.8, 15),
                   "aemulus": np.logspace(-1, 1.78, 10)},
        "rp_wp_bins": {"default": np.logspace(-1.0, 1.8, 15),
                       "aemulus": np.logspace(-1, 1.78, 10)},
        "pi_max": {"default": 80},
        "rp_ds_bins": {"default": np.logspace(-1.0, 1.8, 15),
                       "efficient": np.logspace(-1.0, 1.6, 14)},
        "mu_bins": {"default": np.linspace(0, 1, 21),
                    "aemulus": np.linspace(0, 1, 41)},
        "cosmo_obs": {"default": Planck15, "aemulus": None},
        "alpha_c_bins": {"default": np.linspace(0.0, 0.4, 4)},
        "alpha_s_bins": {"default": np.linspace(0.8, 1.2, 4)},
        "conc_gal_bias_bins": {"default": np.geomspace(1.0 / 3.0, 3.0, 4)},
        "sats_per_prim_haloprop": {"default": 2e-13, "efficient": 1e-13},
        "downsample": {"default": 1.0, "efficient": (lambda x: x / 1e13)},
    }

    config_dict = {}
    for parameter, options in registry.items():
        for config in config_list:
            if config in options:
                config_dict[parameter] = options[config]
                break
    return config_dict


def _read_csv(path):
    with open(path, newline="") as stream:
        reader = csv.DictReader(stream)
        return list(reader)


def cosmology(suite, i_cosmo=0):
    """Cosmology of a given simulation (reference: database.py:95-158).

    Returns a :class:`~.cosmology.FlatFLRW` with ``sigma8``/``ns``/``alphas``
    attributes, built from the bundled public release parameter tables.
    """
    if suite == "AbacusSummit":
        rows = _read_csv(_DATA_DIR / "abacus_summit_cosmologies.csv")
        by_num = {int(r["root"][-3:]): r for r in rows}
        if i_cosmo not in by_num:
            raise ValueError(
                f"Cosmology number {i_cosmo} not in AbacusSummit.")
        row = by_num[i_cosmo]
        h = float(row["h"])
        omega_m = float(row["omega_b"]) + float(row["omega_cdm"])
        n_eff = float(row["N_ur"]) + float(row["N_ncdm"])
        m_nu = [float(omega) * _OMEGA_NU_TO_EV
                for omega in row["omega_ncdm"].split(",")]
        # Pad massless species so the species count matches floor(Neff)
        # (reference: database.py:130-131 pads while len < Neff - 1).
        while len(m_nu) < n_eff - 1:
            m_nu.append(0.0)
        return FlatFLRW(
            H0=h * 100, Om0=omega_m / h**2, Ob0=float(row["omega_b"]) / h**2,
            w0=float(row["w0_fld"]), wa=float(row["wa_fld"]), Neff=n_eff,
            m_nu=m_nu, Tcmb0=2.7255, sigma8=float(row["sigma8_cb"]),
            ns=float(row["n_s"]), alphas=float(row["alpha_s"]),
            name=row["root"])

    elif suite == "AemulusAlpha":
        if 0 <= i_cosmo < 40:
            rows = _read_csv(_DATA_DIR / "aemulus_alpha_cosmologies.csv")
            row = rows[i_cosmo]
        elif 0 <= i_cosmo < 47:
            rows = _read_csv(
                _DATA_DIR / "aemulus_alpha_test_cosmologies.csv")
            row = rows[i_cosmo - 40]
        else:
            raise ValueError(f"Unknown cosmology number {i_cosmo}. Must be "
                             "in the range from 0 to 46.")
        h_sq = (float(row["H0"]) / 100) ** 2
        ob0 = float(row["ombh2"]) / h_sq
        om0 = ob0 + float(row["omch2"]) / h_sq
        return FlatFLRW(
            H0=float(row["H0"]), Om0=om0, Ob0=ob0, w0=float(row["w0"]),
            Neff=float(row["Neff"]), Tcmb0=2.7255,
            sigma8=float(row["sigma8"]), ns=float(row["ns"]),
            name=f"AemulusAlpha_{i_cosmo}")
    else:
        raise ValueError(f"Unknown simulation suite {suite}.")


def simulation_name(suite, i_cosmo=0, i_phase=0, config=None):
    """Simulation naming scheme (reference: database.py:161-210)."""
    if suite == "AbacusSummit":
        if config is None:
            config = "base"
        return f"{config}_c{i_cosmo:03d}_ph{i_phase:03d}"
    elif suite == "AemulusAlpha":
        if 0 <= i_cosmo < 40:
            return f"Box{i_cosmo:03d}"
        elif 0 <= i_cosmo < 47:
            if i_phase > 6:
                raise ValueError(f"Unknown phase number {i_phase}.")
            return f"TestBox{i_cosmo - 40:03d}-{i_phase:03d}"
        raise ValueError(f"Unknown cosmology number {i_cosmo}. Must be in "
                         "the range from 0 to 46.")
    raise ValueError(f"Unknown simulation suite {suite}.")


def directory(suite, redshift, i_cosmo=0, i_phase=0, config=None):
    """Database directory for a snapshot (reference: database.py:213-250).

    Layout: ``$TABCORR_DATABASE/suite/name/z`` with the redshift's decimal
    point replaced by 'p'.
    """
    try:
        path = Path(os.environ["TABCORR_DATABASE"])
    except KeyError:
        raise RuntimeError(
            "You must set the TABCORR_DATABASE environment variable.")
    name = simulation_name(suite, i_cosmo=i_cosmo, i_phase=i_phase,
                           config=config)
    return path / suite / name / f"{redshift:.2f}".replace(".", "p")


FORMATS = ("hdf5", "npz")


def read(suite, redshift, tpcf, i_cosmo=0, i_phase=0, sim_config=None,
         tab_config="default", format="hdf5"):
    """Read a published tabulation (reference: database.py:253-286):
    ``{tpcf}_{tab_config}.hdf5``, or the ``.npz`` copy with
    ``format="npz"`` (written by ``Interpolator.write_npz``)."""
    if format not in FORMATS:
        raise ValueError(f"Unknown format {format!r}; use one of {FORMATS}.")
    path = directory(suite, redshift, i_cosmo=i_cosmo, i_phase=i_phase,
                     config=sim_config)
    return Interpolator.read(path / f"{tpcf}_{tab_config}.{format}")


# Backwards-compatible alias (reference: database.py:290).
tabcorr = read
