"""The ``TabCorr`` tabulation container: I/O, quadrature, prediction.

Reads the reference's HDF5 schema (reference: tabcorr/tabcorr.py:374-463)
and a numpy ``.npz`` copy of it (:meth:`TabCorr.write_npz`), which needs no
``h5py``.  :meth:`TabCorr.table_data` builds the tensors the batched paths
run on; :meth:`TabCorr.predict` is the float64 numpy path that mirrors the
reference math and serves as the port's accuracy oracle on any machine.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .io import ColumnTable, read_attrs
from .models.protocol import CENTRALS
from .ops.predict import AUTO, TableData, quadrature_grid
from .utils.device import numpy_dtype, resolve_device
from .utils.packing import array_to_symmetric_matrix


def _json_value(value):
    """An attribute value as a JSON-serializable Python value."""
    if isinstance(value, bytes):
        return value.decode("utf-8")
    if isinstance(value, np.generic):
        return value.item()
    return value


class TabCorr:
    """Tabulated halo correlation functions and galaxy predictions."""

    def __init__(self):
        self.attrs = {}
        self.gal_type = None
        self.tpcf_matrix = None
        self.tpcf_args = ()
        self.tpcf_kwargs = {}
        self.tpcf_shape = ()
        self._quad_cache = {}
        self._dense_cache = None
        self._table_data_cache = {}

    # ------------------------------------------------------------------
    # I/O
    # ------------------------------------------------------------------
    @classmethod
    def read(cls, fname):
        """Read a tabulation from an ``.npz`` file (written by
        :meth:`write_npz`) or from a reference-schema HDF5 file."""
        if str(fname).endswith(".npz"):
            return cls._read_npz(fname)
        import h5py

        halotab = cls()
        with h5py.File(fname, "r") as fstream:
            halotab.attrs = read_attrs(fstream)
            # Stored float32, up-cast on read like the reference (:399).
            halotab.tpcf_matrix = fstream["tpcf_matrix"][()].astype(
                np.float64)
            halotab.tpcf_args = tuple(
                fstream["tpcf_args"][key][()] for key in fstream["tpcf_args"])
            if "tpcf_kwargs" in fstream:
                for key in fstream["tpcf_kwargs"]:
                    halotab.tpcf_kwargs[key] = fstream["tpcf_kwargs"][key][()]
            halotab.tpcf_shape = tuple(fstream["tpcf_shape"][()])
            halotab.gal_type = ColumnTable.read_hdf5(fstream, "gal_type")
        return halotab

    @classmethod
    def _read_npz(cls, fname):
        halotab = cls()
        with np.load(fname, allow_pickle=False) as data:
            halotab.attrs = json.loads(str(data["attrs"]))
            halotab.tpcf_matrix = data["tpcf_matrix"].astype(np.float64)
            halotab.tpcf_shape = tuple(data["tpcf_shape"])
            halotab.gal_type = ColumnTable.from_structured_array(
                data["gal_type"])
            halotab.tpcf_args = tuple(data[k][()] for k in data.files
                                      if k.startswith("tpcf_args."))
            halotab.tpcf_kwargs = {
                k.split(".", 1)[1]: data[k][()] for k in data.files
                if k.startswith("tpcf_kwargs.")}
        return halotab

    def write_npz(self, fname):
        """Write every field :meth:`read` restores to an uncompressed
        ``.npz``; the matrix is stored in float32, as the HDF5 schema
        stores it."""
        arrays = {
            "attrs": np.array(json.dumps(
                {k: _json_value(v) for k, v in self.attrs.items()})),
            "tpcf_matrix": self.tpcf_matrix.astype(np.float32),
            "tpcf_shape": np.asarray(self.tpcf_shape, dtype=np.int64),
            "gal_type": self.gal_type.as_structured_array(),
        }
        for i, arg in enumerate(self.tpcf_args):
            arrays[f"tpcf_args.arg_{i}"] = np.asarray(arg)
        for key, value in self.tpcf_kwargs.items():
            arrays[f"tpcf_kwargs.{key}"] = np.asarray(value)
        np.savez(fname, **arrays)

    # ------------------------------------------------------------------
    # Derived host-side quantities
    # ------------------------------------------------------------------
    @property
    def mode(self):
        return self.attrs["mode"]

    @property
    def n_bins(self):
        return len(self.gal_type)

    @property
    def n_centrals(self):
        """Number of leading central bins; bins are [centrals..., satellites...]."""
        gal_type = self.gal_type["gal_type"]
        if gal_type.dtype.kind == "S":
            is_cen = gal_type == CENTRALS.encode()
        else:
            is_cen = gal_type == CENTRALS
        n_cen = int(np.sum(is_cen))
        if not np.all(is_cen[:n_cen]):
            raise ValueError("gal_type rows are not ordered "
                             "[centrals..., satellites...].")
        return n_cen

    def _quadrature(self, n_gauss):
        """Cached (log_prim_quad, quad_weight) float64 arrays."""
        if n_gauss not in self._quad_cache:
            if "prim_haloprop_dist_index" in self.gal_type:
                dist_index = self.gal_type["prim_haloprop_dist_index"]
            else:
                # Legacy files: flat measure (reference: tabcorr.py:571-574).
                dist_index = np.full(self.n_bins, -1.0)
            self._quad_cache[n_gauss] = quadrature_grid(
                self.gal_type["log_prim_haloprop_min"],
                self.gal_type["log_prim_haloprop_max"],
                dist_index, n_gauss)
        return self._quad_cache[n_gauss]

    def dense_matrix(self):
        """The stored matrix in its dense contraction form (float64).

        Auto mode: (n_xi, n_bins, n_bins) symmetric; cross mode: unchanged
        (n_xi, n_bins).  Cached; assigning ``tpcf_matrix`` anew is not
        tracked, so a changed table is read into a new ``TabCorr``.
        """
        if self.mode != AUTO:
            return self.tpcf_matrix
        if self._dense_cache is None:
            self._dense_cache = array_to_symmetric_matrix(self.tpcf_matrix)
        return self._dense_cache

    def table_data(self, n_gauss=10, dtype=torch.float32, *,
                   device) -> TableData:
        """The tabulation as tensors on ``device`` (cached per arguments).

        In float32 the float64 node residual ``log_prim_quad_lo`` is kept,
        so occupations are evaluated at the float64 node positions.
        """
        device = resolve_device(device)
        key = (n_gauss, dtype, device)
        if key not in self._table_data_cache:
            np_dtype = numpy_dtype(dtype)
            log_quad, weight = self._quadrature(n_gauss)
            log_quad_lo = None
            if np.dtype(np_dtype).itemsize < 8:
                hi64 = log_quad.astype(np_dtype).astype(np.float64)
                log_quad_lo = log_quad - hi64
            self._table_data_cache[key] = TableData.from_numpy(
                dict(tpcf_dense=self.dense_matrix(),
                     n_h=self.gal_type["n_h"],
                     log_prim_quad=log_quad,
                     quad_weight=weight,
                     sec_perc=self.gal_type["sec_haloprop_percentile"],
                     log_prim_quad_lo=log_quad_lo),
                mode=self.mode, tpcf_shape=self.tpcf_shape,
                n_centrals=self.n_centrals, device=device, dtype=dtype)
        return self._table_data_cache[key]

    # ------------------------------------------------------------------
    # Float64 host path (the reference's math; the accuracy oracle)
    # ------------------------------------------------------------------
    def mean_occupation(self, model, n_gauss_prim=10, check_consistency=True):
        """Mean occupation per bin (reference: tabcorr/tabcorr.py:465-578)."""
        if check_consistency:
            self._check_consistency(model)
        log_quad, weight = self._quadrature(n_gauss_prim)
        prim = 10.0 ** log_quad
        sec = np.repeat(self.gal_type["sec_haloprop_percentile"],
                        n_gauss_prim).reshape(prim.shape)
        n_cen = self.n_centrals
        occ = np.empty_like(prim)
        occ[:n_cen] = model.mean_occupation_centrals(
            prim_haloprop=prim[:n_cen].ravel(),
            sec_haloprop_percentile=sec[:n_cen].ravel()
        ).reshape(prim[:n_cen].shape)
        occ[n_cen:] = model.mean_occupation_satellites(
            prim_haloprop=prim[n_cen:].ravel(),
            sec_haloprop_percentile=sec[n_cen:].ravel()
        ).reshape(prim[n_cen:].shape)
        return np.sum(weight * occ, axis=-1)

    def _check_consistency(self, model):
        """Model/tabulation consistency (reference: tabcorr.py:496-535)."""
        if sorted(model.gal_types) != ["centrals", "satellites"]:
            raise ValueError(
                "The model instance must only have centrals and satellites "
                "as galaxy types.")
        if getattr(model, "prim_haloprop_key", None) != \
                self.attrs["prim_haloprop_key"]:
            raise ValueError("Mismatch in the primary halo properties of "
                             "the model and the TabCorr instance.")
        sec_key = getattr(model, "sec_haloprop_key", None)
        if sec_key is not None and sec_key != self.attrs["sec_haloprop_key"]:
            raise ValueError("Mismatch in the secondary halo properties of "
                             "the model and the TabCorr instance.")
        if abs(model.redshift - self.attrs["redshift"]) >= 0.05:
            raise ValueError("Mismatch in the redshift of the model and "
                             "the TabCorr instance.")

    def predict(self, model, n_gauss_prim=10, check_consistency=True):
        """(ngal, xi) for a model in float64 (reference: tabcorr.py:580-683)."""
        mean_occ = self.mean_occupation(model, n_gauss_prim=n_gauss_prim,
                                        check_consistency=check_consistency)
        ngal = mean_occ * np.asarray(self.gal_type["n_h"], dtype=np.float64)
        total = np.sum(ngal)
        dense = self.dense_matrix()
        if self.mode == AUTO:
            xi = np.einsum("kij,i,j->k", dense, ngal, ngal) / total**2
        else:
            xi = dense @ ngal / total
        return total, xi.reshape(self.tpcf_shape)

    def __repr__(self):
        return (f"TabCorr(tpcf={self.attrs.get('tpcf')}, mode="
                f"{self.attrs.get('mode')}, n_bins={self.n_bins}, "
                f"tpcf_shape={self.tpcf_shape})")
