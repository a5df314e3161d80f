"""Production tabulation pipeline CLI over tabcorr_tpu_torch.

The port of ``scripts/tabulate_snapshot.py`` (the JAX package's copy of
the reference's script): reads a parsed snapshot from the database
directory, loops over the velocity-bias phase-space grid (alpha_c x
alpha_s x conc_gal_bias), tabulates the requested statistic per grid node
(xi -> multipoles 0/2/4, wp, ds, or xi_r -> real-space xi(r)) with
``TabCorr.tabulate`` on ``--device`` (the CUDA pair counter by default),
and assembles the per-node tabulations into the final Interpolator file.

``--format`` picks the files: the reference's HDF5 (default:
``snapshot.hdf5`` in, ``{tpcf}_{i}.hdf5`` and ``{tpcf}_{tab_config}.hdf5``
out; needs h5py) or the port's ``.npz`` copies of the same (numpy alone;
``scripts/torch_parse_snapshot.py --format npz`` writes the snapshot,
``database.read(..., format="npz")`` reads the result).  Nothing picks a
device or a format for the caller: ``--device cuda`` without a card
raises.

Usage:
    python scripts/torch_tabulate_snapshot.py AbacusSummit 0.5 --tpcf wp \
        --tab_config efficient [--device cpu] [--format npz]
"""

import argparse
import csv
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import tabcorr_tpu_torch as tp  # noqa: E402
from tabcorr_tpu_torch import database  # noqa: E402
from tabcorr_tpu_torch.halocat import HaloCatalog, ParticleCatalog  # noqa
from tabcorr_tpu_torch.io import ColumnTable  # noqa: E402
from tabcorr_tpu_torch.mock import (CentralVelocityBiasPhaseSpace,  # noqa
                                    NFWPhaseSpace)
from tabcorr_tpu_torch.ops.multipole import \
    tabcorr_s_mu_to_multipole  # noqa: E402
from torch_parse_snapshot import read_snapshot_table  # noqa: E402


def read_simulation_snapshot(suite, redshift, i_cosmo=0, i_phase=0,
                             config=None, format="hdf5"):
    """Build a HaloCatalog from the database's parsed snapshot
    (``snapshot.hdf5``, or ``snapshot.npz`` with ``format="npz"``).

    Mirrors the reference's reader (scripts/tabulate_snapshot.py:17-67):
    suite-specific mass definitions, concentrations from r_delta / r_s, and
    the optional particle subsample for lensing.
    """
    if format not in database.FORMATS:
        raise ValueError(f"Unknown format {format!r}; use one of "
                         f"{database.FORMATS}.")
    name = database.simulation_name(suite, i_cosmo=i_cosmo,
                                    i_phase=i_phase, config=config)
    path = database.directory(suite, redshift, i_cosmo=i_cosmo,
                              i_phase=i_phase, config=config) / \
        f"snapshot.{format}"
    cosmology = database.cosmology(suite, i_cosmo=i_cosmo)
    halos, meta = read_snapshot_table(path, "halos")
    halos = ColumnTable.from_structured_array(halos)
    ptcls, _ = read_snapshot_table(path, "particles")
    if ptcls is not None:
        ptcls = ColumnTable.from_structured_array(ptcls)

    if suite == "AbacusSummit":
        mdef = "{:.0f}m".format(meta["SODensityL1"])
        lbox = meta["BoxSize"]
        particle_mass = meta["ParticleMassHMsun"]
        n_ptcls = meta["ppd"] ** 3
    else:
        mdef = "200m"
        lbox = 1050
        particle_mass = 3.51e10 * cosmology.Om0 / 0.3
        n_ptcls = 1400 ** 3

    mass_key = f"halo_m{mdef}"
    radius_key = f"halo_r{mdef}"
    table = {
        "halo_x": halos["halo_x"], "halo_y": halos["halo_y"],
        "halo_z": halos["halo_z"], "halo_vx": halos["halo_vx"],
        "halo_vy": halos["halo_vy"], "halo_vz": halos["halo_vz"],
        "halo_upid": np.full(len(halos), -1, dtype=np.int64),
        "halo_nfw_conc": np.asarray(halos[radius_key]) /
        np.asarray(halos["halo_rs"]),
        "halo_mvir": halos[mass_key],
        "halo_rvir": halos[radius_key],
        mass_key: halos[mass_key],
        radius_key: halos[radius_key],
    }
    if "halo_vmax" in halos:
        table["halo_vmax"] = halos["halo_vmax"]

    ptcl_catalog = None
    if ptcls is not None:
        ptcl_catalog = ParticleCatalog(
            ptcls["x"], ptcls["y"], ptcls["z"], Lbox=lbox,
            particle_mass=particle_mass, redshift=redshift,
            n_total=n_ptcls)

    return HaloCatalog(table, Lbox=lbox, particle_mass=particle_mass,
                       redshift=redshift, cosmology=cosmology,
                       simname=name, ptcl_catalog=ptcl_catalog,
                       n_ptcls=n_ptcls)


def write_table(halotab, path):
    """Write one node's tabulation: HDF5 or ``.npz``, by the suffix."""
    if path.suffix == ".npz":
        halotab.write_npz(path)
    else:
        halotab.write(path, overwrite=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Tabulate halo correlation functions.")
    parser.add_argument("suite", choices=["AemulusAlpha", "AbacusSummit"],
                        help="simulation suite")
    parser.add_argument("redshift", type=float,
                        help="simulation redshift")
    parser.add_argument("--cosmo", type=int, default=0,
                        help="simulation cosmology, default is 0")
    parser.add_argument("--phase", type=int, default=0,
                        help="simulation phase, default is 0")
    parser.add_argument("--sim_config", default=None,
                        help="simulation configuration to assume")
    parser.add_argument("--tab_config", default="default",
                        help="tabulation configuration to assume")
    parser.add_argument("--tpcf", default="xi",
                        choices=["xi", "wp", "ds", "xi_r"],
                        help="TPCF to tabulate")
    parser.add_argument("--seed", type=int, default=None,
                        help="random seed for the mock population")
    parser.add_argument("--resume", action="store_true",
                        help="skip grid nodes whose output files already "
                             "exist (file-granularity checkpointing)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the pair counts run: 'cuda' (default, "
                             "the CUDA pair counter; raises without a "
                             "card) or 'cpu' (its plain version)")
    parser.add_argument("--format", choices=database.FORMATS,
                        default="hdf5",
                        help="files read and written: the reference's "
                             "HDF5 (default; needs h5py) or the port's "
                             ".npz (numpy alone)")
    args = parser.parse_args(argv)
    ext = args.format

    config = database.configuration(args.tab_config)
    halocat = read_simulation_snapshot(
        args.suite, args.redshift, i_cosmo=args.cosmo,
        i_phase=args.phase, config=args.sim_config, format=ext)

    mdef = next(key[6:] for key in halocat.halo_table.colnames
                if key.startswith("halo_m") and key.endswith("m")
                and key != "halo_mvir")

    # Statistic-specific grid pruning (reference: :146-151).
    if args.tpcf == "wp" and config["pi_max"] >= 80:
        config["alpha_c_bins"] = [0.0]
    if args.tpcf in ("ds", "xi_r"):
        # ds: reference pruning (scripts/tabulate_snapshot.py:146-151).
        # xi_r: velocity-bias parameters (central velocity noise
        # alpha_c, satellite dispersion scaling alpha_s) only move
        # velocities and cannot affect a real-space statistic.
        config["alpha_c_bins"] = [0.0]
        config["alpha_s_bins"] = [1.0]

    path = database.directory(
        args.suite, args.redshift, i_cosmo=args.cosmo, i_phase=args.phase,
        config=args.sim_config) / args.tab_config
    path.mkdir(parents=True, exist_ok=True)

    grid = np.array(np.meshgrid(
        config["alpha_c_bins"], config["alpha_s_bins"],
        config["conc_gal_bias_bins"])).T.reshape(-1, 3)

    with open(path / f"{args.tpcf}_grid.csv", "w", newline="") as stream:
        writer = csv.writer(stream)
        writer.writerow(["alpha_c", "alpha_s", "conc_gal_bias"])
        writer.writerows(grid)

    for i, (alpha_c, alpha_s, conc_gal_bias) in enumerate(grid):
        if args.resume:
            expected = ([path / f"xi{o}_{i}.{ext}" for o in (0, 2, 4)]
                        if args.tpcf == "xi"
                        else [path / f"{args.tpcf}_{i}.{ext}"])
            if all(f.exists() for f in expected):
                print(f"Skipping grid node {i} (files exist).")
                continue
        cens_prof_model = CentralVelocityBiasPhaseSpace(
            redshift=halocat.redshift, alpha_c=alpha_c)
        sats_prof_model = NFWPhaseSpace(
            redshift=halocat.redshift, conc_gal_bias=conc_gal_bias,
            alpha_s=alpha_s)

        if args.tpcf == "ds":
            prim_haloprop_bins, mode = 300, "cross"
        else:
            prim_haloprop_bins, mode = 30, "auto"

        kwargs = dict(
            mode=mode, cens_prof_model=cens_prof_model,
            sats_prof_model=sats_prof_model, verbose=True,
            sats_per_prim_haloprop=config["sats_per_prim_haloprop"],
            # xi(r) is isotropic without RSD: axis projections are
            # redundant, and distorted coordinates would put velocity
            # anisotropy into a real-space statistic.
            redshift_space_distortions=args.tpcf != "xi_r",
            project_xyz=args.tpcf != "xi_r",
            prim_haloprop_bins=prim_haloprop_bins,
            prim_haloprop_key=f"halo_m{mdef}",
            sec_haloprop_key=("halo_nfw_conc"
                              if args.suite == "AbacusSummit"
                              else "halo_vmax"),
            sec_haloprop_percentile_bins=0.5,
            cosmology_obs=config["cosmo_obs"],
            Num_ptcl_requirement=(299 if args.suite == "AbacusSummit"
                                  else 99),
            downsample=config["downsample"],
            seed=args.seed if args.seed is None else args.seed + i,
            device=args.device)

        if args.tpcf == "xi":
            halotab_s_mu = tp.TabCorr.tabulate(
                halocat, tp.corrfunc.s_mu_tpcf, config["s_bins"],
                config["mu_bins"], **kwargs)
            for order in [0, 2, 4]:
                halotab_multipole = tabcorr_s_mu_to_multipole(
                    halotab_s_mu, config["mu_bins"], order)
                write_table(halotab_multipole, path / f"xi{order}_{i}.{ext}")
        elif args.tpcf == "xi_r":
            halotab = tp.TabCorr.tabulate(
                halocat, tp.corrfunc.tpcf, config["s_bins"], **kwargs)
            write_table(halotab, path / f"xi_r_{i}.{ext}")
        elif args.tpcf == "wp":
            halotab = tp.TabCorr.tabulate(
                halocat, tp.corrfunc.wp, config["rp_wp_bins"],
                config["pi_max"], **kwargs)
            write_table(halotab, path / f"wp_{i}.{ext}")
        elif args.tpcf == "ds":
            ptcl = halocat.ptcl_catalog
            halotab = tp.TabCorr.tabulate(
                halocat, tp.corrfunc.mean_delta_sigma, ptcl.positions,
                ptcl.effective_particle_mass, config["rp_ds_bins"],
                **kwargs)
            write_table(halotab, path / f"ds_{i}.{ext}")

    # Assemble the Interpolator (reference: :240-254); log_eta replaces
    # conc_gal_bias and constant grid axes are dropped.
    param_table = ColumnTable({
        "alpha_c": grid[:, 0], "alpha_s": grid[:, 1],
        "log_eta": np.log10(grid[:, 2])})
    for key in ["alpha_c", "alpha_s", "log_eta"]:
        if len(np.unique(param_table[key])) == 1:
            param_table.remove_column(key)

    statistics = [args.tpcf] if args.tpcf != "xi" else ["xi0", "xi2",
                                                        "xi4"]
    out_dir = database.directory(
        args.suite, args.redshift, i_cosmo=args.cosmo, i_phase=args.phase,
        config=args.sim_config)
    for tpcf in statistics:
        tabcorr_list = [tp.TabCorr.read(path / f"{tpcf}_{i}.{ext}")
                        for i in range(len(grid))]
        halotab = tp.Interpolator(tabcorr_list, param_table)
        out = out_dir / f"{tpcf}_{args.tab_config}.{ext}"
        if ext == "npz":
            halotab.write_npz(out)
        else:
            halotab.write(out, overwrite=True)


if __name__ == "__main__":
    main()
