"""Halo and particle catalog containers (the port's copy of
``tabcorr_tpu/halocat.py``, numpy only).

Astropy/halotools-free equivalents of halotools'
``UserSuppliedHaloCatalog`` / ``UserSuppliedPtclCatalog``, carrying exactly
what the tabulation engine consumes (reference usage:
tabcorr/tabcorr.py:142-158 and scripts/tabulate_snapshot.py:17-67).
"""

from __future__ import annotations

import numpy as np

from .io import ColumnTable


class ParticleCatalog:
    """Dark-matter particle subsample for delta-sigma tabulation."""

    def __init__(self, x, y, z, Lbox, particle_mass, redshift,
                 n_total=None):
        self.ptcl_table = ColumnTable({
            "x": np.asarray(x, dtype=np.float64),
            "y": np.asarray(y, dtype=np.float64),
            "z": np.asarray(z, dtype=np.float64)})
        self.Lbox = Lbox
        self.particle_mass = float(particle_mass)
        self.redshift = float(redshift)
        # Total particles in the parent simulation (for the effective mass
        # of a subsample).
        self.n_total = n_total if n_total is not None else len(x)

    @property
    def positions(self):
        t = self.ptcl_table
        return np.column_stack([t["x"], t["y"], t["z"]])

    @property
    def effective_particle_mass(self):
        """Mass per subsample particle accounting for downsampling."""
        return self.particle_mass * self.n_total / len(self.ptcl_table)


class HaloCatalog:
    """Host-halo catalog for tabulation.

    Parameters
    ----------
    halo_table : ColumnTable or dict
        Must contain positions ``halo_x/y/z``, velocities ``halo_vx/vy/vz``,
        ``halo_upid`` (-1 for host halos) and the primary / secondary halo
        property columns used for binning.
    Lbox : float or array
        Periodic box size [Mpc/h].
    particle_mass : float
        Simulation particle mass [Msun/h].
    redshift : float
    cosmology : tabcorr_tpu_torch.cosmology.FlatFLRW
    simname : str
    ptcl_catalog : ParticleCatalog, optional
    """

    def __init__(self, halo_table, Lbox, particle_mass, redshift,
                 cosmology=None, simname="custom", ptcl_catalog=None,
                 n_ptcls=None):
        if not isinstance(halo_table, ColumnTable):
            halo_table = ColumnTable(
                {k: np.asarray(v) for k, v in halo_table.items()})
        self.halo_table = halo_table
        self.Lbox = np.broadcast_to(
            np.asarray(Lbox, dtype=np.float64), (3,)).copy()
        self.particle_mass = float(particle_mass)
        self.redshift = float(redshift)
        self.cosmology = cosmology
        self.simname = simname
        self.ptcl_catalog = ptcl_catalog
        self.n_ptcls = n_ptcls

        if "halo_upid" not in halo_table:
            halo_table["halo_upid"] = np.full(len(halo_table), -1,
                                              dtype=np.int64)
        if "halo_id" not in halo_table:
            halo_table["halo_id"] = np.arange(len(halo_table))

    @property
    def ptcl_table(self):
        return None if self.ptcl_catalog is None else \
            self.ptcl_catalog.ptcl_table

    def host_halos(self, prim_haloprop_key, num_ptcl_requirement):
        """Host halos above the particle-count mass cut
        (reference: tabcorr/tabcorr.py:155-158)."""
        halos = self.halo_table
        select = (halos["halo_upid"] == -1) & (
            halos[prim_haloprop_key] >
            num_ptcl_requirement * self.particle_mass)
        return halos[select]

    def __repr__(self):
        return (f"HaloCatalog(simname={self.simname}, n_halos="
                f"{len(self.halo_table)}, Lbox={self.Lbox.tolist()}, "
                f"z={self.redshift})")
