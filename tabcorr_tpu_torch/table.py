"""The ``TabCorr`` tabulation container: tabulation, I/O, quadrature,
prediction.

Reads and writes the reference's HDF5 schema (reference:
tabcorr/tabcorr.py:374-463; h5py is imported at the call) and a numpy
``.npz`` copy of it (:meth:`TabCorr.write_npz`), which needs no
``h5py``.  :meth:`TabCorr.table_data` builds the tensors the batched paths
run on; :meth:`TabCorr.predict` is the float64 numpy path that mirrors the
reference math and serves as the port's accuracy oracle on any machine.
"""

from __future__ import annotations

import itertools
import json

import numpy as np
import torch

from .io import ColumnTable, read_attrs
from .models.protocol import CENTRALS
from .ops.predict import AUTO, TableData, quadrature_grid
from .utils.device import check_dtype, host_tensor, resolve_device
from .utils.packing import array_to_symmetric_matrix


# The reference schema's attributes, in its order (tabcorr/tabcorr.py:
# 418-463); extra attributes that are not None follow.
FILE_ATTRS = ("tpcf", "mode", "simname", "redshift", "Num_ptcl_requirement",
              "prim_haloprop_key", "sec_haloprop_key")


def stored_args(tpcf_args, tpcf_kwargs, max_args_size):
    """The tpcf arguments a file keeps: every one but an array of
    ``max_args_size`` elements or more (a Delta Sigma table's particle
    positions), as the reference writer drops them (tabcorr/tabcorr.py:
    450-459).  Returns ({"arg_i": value}, {key: value})."""
    def kept(value):
        return (not isinstance(value, np.ndarray) or
                np.prod(value.shape) < max_args_size)
    return ({f"arg_{i}": a for i, a in enumerate(tpcf_args) if kept(a)},
            {k: v for k, v in tpcf_kwargs.items() if kept(v)})


def import_h5py(what):
    """h5py, or an ImportError naming it and the ``.npz`` writer."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            f"{what} writes HDF5 and needs h5py, which is not installed; "
            "write_npz writes the same fields without it.") from exc
    return h5py


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
        self._gal_type = None
        self._gal_type_version = 0
        self._tpcf_matrix = None
        self._matrix_version = 0
        self.tpcf_args = ()
        self.tpcf_kwargs = {}
        self.tpcf_shape = ()
        self._quad_cache = {}
        self._dense_cache = None
        self._table_data_cache = {}

    # Version counters key the derived-data caches (tabcorr_tpu/table.py:
    # 35-66): assigning ``tpcf_matrix`` or ``gal_type`` anew invalidates
    # them.  An edit in place is not seen: reassign, or clear_caches().
    @property
    def tpcf_matrix(self):
        return self._tpcf_matrix

    @tpcf_matrix.setter
    def tpcf_matrix(self, value):
        self._tpcf_matrix = value
        self._matrix_version += 1

    @property
    def gal_type(self):
        return self._gal_type

    @gal_type.setter
    def gal_type(self, value):
        self._gal_type = value
        self._gal_type_version += 1
        # The quadrature derives from the gal_type columns only.
        self._quad_cache = {}

    def clear_caches(self):
        """Forget the derived data (after ``tpcf_matrix`` or ``gal_type``
        was edited in place)."""
        self._quad_cache = {}
        self._dense_cache = None
        self._table_data_cache = {}

    @classmethod
    def tabulate(cls, halocat, tpcf, *tpcf_args, **kwargs):
        """Tabulate correlation functions for a halo catalog: see
        :func:`tabcorr_tpu_torch.tabulate.tabulate` (signature-compatible
        with the reference, tabcorr/tabcorr.py:24-34; the pair counts run
        on ``device``, 'cuda' by default)."""
        from .tabulate import tabulate as _tabulate
        return _tabulate(cls, halocat, tpcf, *tpcf_args, **kwargs)

    # ------------------------------------------------------------------
    # I/O
    # ------------------------------------------------------------------
    @classmethod
    def read(cls, fname):
        """Read a tabulation from an ``.npz`` file (written by
        :meth:`write_npz`) or from a reference-schema HDF5 file."""
        if str(fname).endswith(".npz"):
            with np.load(fname, allow_pickle=False) as data:
                return cls.from_npz_arrays(data)
        import h5py

        with h5py.File(fname, "r") as fstream:
            return cls.read_hdf5_group(fstream)

    @classmethod
    def read_hdf5_group(cls, group):
        """Read a tabulation from an open h5py file or group."""
        halotab = cls()
        halotab.attrs = read_attrs(group)
        # Stored float32, up-cast on read like the reference (:399).
        halotab.tpcf_matrix = group["tpcf_matrix"][()].astype(np.float64)
        halotab.tpcf_args = tuple(
            group["tpcf_args"][key][()] for key in group["tpcf_args"])
        if "tpcf_kwargs" in group:
            for key in group["tpcf_kwargs"]:
                halotab.tpcf_kwargs[key] = group["tpcf_kwargs"][key][()]
        halotab.tpcf_shape = tuple(group["tpcf_shape"][()])
        halotab.gal_type = ColumnTable.read_hdf5(group, "gal_type")
        return halotab

    @classmethod
    def from_npz_arrays(cls, data, prefix=""):
        """A tabulation from the arrays :meth:`npz_arrays` made, each
        name preceded by ``prefix`` (a mapping or an open ``.npz``)."""
        def names(start):
            return [k for k in data.keys() if k.startswith(prefix + start)]

        halotab = cls()
        halotab.attrs = json.loads(str(data[prefix + "attrs"]))
        halotab.tpcf_matrix = data[prefix + "tpcf_matrix"].astype(np.float64)
        halotab.tpcf_shape = tuple(data[prefix + "tpcf_shape"])
        halotab.gal_type = ColumnTable.from_structured_array(
            data[prefix + "gal_type"])
        halotab.tpcf_args = tuple(data[k][()] for k in names("tpcf_args."))
        halotab.tpcf_kwargs = {k[len(prefix):].split(".", 1)[1]: data[k][()]
                               for k in names("tpcf_kwargs.")}
        return halotab

    def npz_arrays(self, prefix="", max_args_size=1000000):
        """Every field :meth:`from_npz_arrays` restores, as numpy arrays
        named ``prefix + field``; the matrix in float32 and the tpcf
        arguments below ``max_args_size`` elements only, as :meth:`write`
        stores them."""
        arrays = {
            "attrs": np.array(json.dumps(
                {k: _json_value(v) for k, v in self.attrs.items()})),
            "tpcf_matrix": self.tpcf_matrix.astype(np.float32),
            "tpcf_shape": np.asarray(self.tpcf_shape, dtype=np.int64),
            "gal_type": self.gal_type.as_structured_array(),
        }
        args, kwargs = stored_args(self.tpcf_args, self.tpcf_kwargs,
                                   max_args_size)
        for name, arg in args.items():
            arrays[f"tpcf_args.{name}"] = np.asarray(arg)
        for key, value in kwargs.items():
            arrays[f"tpcf_kwargs.{key}"] = np.asarray(value)
        return {prefix + k: v for k, v in arrays.items()}

    def write_npz(self, fname, max_args_size=1000000):
        """Write :meth:`npz_arrays` to an uncompressed ``.npz``."""
        np.savez(fname, **self.npz_arrays(max_args_size=max_args_size))

    def write(self, fname, overwrite=False, max_args_size=1000000,
              matrix_dtype=np.float32):
        """Write in the reference's HDF5 schema (tabcorr/tabcorr.py:
        418-463): the reference's attributes, then any other that is not
        None; the matrix in ``matrix_dtype``; the tpcf arguments below
        ``max_args_size`` elements; ``gal_type``.  ``fname`` is a path
        (created with mode "w-" unless ``overwrite``) or an open h5py file
        or group.  Needs h5py (:meth:`write_npz` does not)."""
        h5py = import_h5py("TabCorr.write")
        if isinstance(fname, h5py.Group):
            self.write_hdf5_group(fname, max_args_size, matrix_dtype)
            return
        with h5py.File(fname, "w" if overwrite else "w-") as fstream:
            self.write_hdf5_group(fstream, max_args_size, matrix_dtype)

    def write_hdf5_group(self, group, max_args_size=1000000,
                         matrix_dtype=np.float32):
        """Write the tabulation into an open h5py file or group."""
        for key in FILE_ATTRS:
            group.attrs[key] = self.attrs[key]
        for key, value in self.attrs.items():
            if key not in FILE_ATTRS and value is not None:
                group.attrs[key] = value
        group["tpcf_matrix"] = self.tpcf_matrix.astype(matrix_dtype)
        args, kwargs = stored_args(self.tpcf_args, self.tpcf_kwargs,
                                   max_args_size)
        for name, arg in args.items():
            group[f"tpcf_args/{name}"] = arg
        for key, value in kwargs.items():
            group[f"tpcf_kwargs/{key}"] = value
        group["tpcf_shape"] = np.asarray(self.tpcf_shape, dtype=np.int64)
        self.gal_type.write_hdf5(group, "gal_type")

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
        (n_xi, n_bins).  Cached per matrix version.
        """
        if self.mode != AUTO:
            return self.tpcf_matrix
        if (self._dense_cache is None or
                self._dense_cache[0] != self._matrix_version):
            self._dense_cache = (self._matrix_version,
                                 array_to_symmetric_matrix(self.tpcf_matrix))
        return self._dense_cache[1]

    def table_data(self, n_gauss=10, dtype=torch.float32, *,
                   device="cuda") -> TableData:
        """The tabulation as tensors on ``device`` (cached per arguments
        and per version of ``tpcf_matrix`` and ``gal_type``).

        ``dtype`` is bfloat16, float32 or float64.  Below float64 the
        float64 node residual ``log_prim_quad_lo`` (``log_quad`` less its
        rounded node, itself rounded to ``dtype``) is kept, so occupations
        are evaluated at the float64 node positions.
        """
        device = resolve_device(device)
        key = (n_gauss, check_dtype(dtype), device, self._matrix_version,
               self._gal_type_version)
        if key not in self._table_data_cache:
            log_quad, weight = self._quadrature(n_gauss)
            log_quad_lo = None
            if dtype.itemsize < 8:
                hi64 = host_tensor(log_quad, dtype).double().numpy()
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

    def predict(self, model, separate_gal_type=False, n_gauss_prim=10,
                check_consistency=True):
        """(ngal, xi) for a model in float64 (reference: tabcorr.py:580-683).

        ``model`` may also be a raw mean-occupation ``ndarray`` per bin
        (the Interpolator's route, reference: tabcorr.py:616-621).  With
        ``separate_gal_type`` both come back as per-galaxy-type dicts.
        """
        if isinstance(model, np.ndarray):
            mean_occ = model
        else:
            mean_occ = self.mean_occupation(
                model, n_gauss_prim=n_gauss_prim,
                check_consistency=check_consistency)
        ngal = mean_occ * np.asarray(self.gal_type["n_h"], dtype=np.float64)
        total = np.sum(ngal)
        dense = self.dense_matrix()
        if not separate_gal_type:
            if self.mode == AUTO:
                xi = np.einsum("kij,i,j->k", dense, ngal, ngal) / total**2
            else:
                xi = dense @ ngal / total
            return total, xi.reshape(self.tpcf_shape)

        mask_c = np.zeros_like(ngal)
        mask_c[:self.n_centrals] = 1.0
        n_c, n_s = ngal * mask_c, ngal * (1.0 - mask_c)
        ngal_dict = {"centrals": np.sum(n_c), "satellites": np.sum(n_s)}
        xi_dict = {}
        if self.mode == AUTO:
            pairs = itertools.combinations_with_replacement(
                [("centrals", n_c), ("satellites", n_s)], 2)
            for (name_1, v_1), (name_2, v_2) in pairs:
                factor = 1.0 if name_1 == name_2 else 2.0
                xi = factor * np.einsum("kij,i,j->k", dense, v_1, v_2)
                xi_dict[f"{name_1}-{name_2}"] = (
                    xi / total**2).reshape(self.tpcf_shape)
        else:
            for name, vec in [("centrals", n_c), ("satellites", n_s)]:
                xi_dict[name] = (dense @ vec / total).reshape(self.tpcf_shape)
        return ngal_dict, xi_dict

    def make_predictor(self, model, **kwargs):
        """Batched predictor for this tabulation: see
        :func:`tabcorr_tpu_torch.predictor.make_predictor`."""
        from .predictor import make_predictor
        return make_predictor(self, model, **kwargs)

    def __repr__(self):
        return (f"TabCorr(tpcf={self.attrs.get('tpcf')}, mode="
                f"{self.attrs.get('mode')}, n_bins={self.n_bins}, "
                f"tpcf_shape={self.tpcf_shape})")
