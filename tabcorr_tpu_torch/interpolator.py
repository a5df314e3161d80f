"""Parameter-grid interpolation of tabulations.

Port of ``tabcorr_tpu/interpolator.py`` (reference:
tabcorr/interpolator.py:11-216): an :class:`Interpolator` holds N
``TabCorr`` instances on a full rectangular parameter grid and
cubic-spline-interpolates their predictions across it.

* :func:`spline_interpolation_matrix`, :func:`spline_interpolate` and
  :meth:`Interpolator.predict` are the float64 numpy host path with the
  reference's semantics (the out-of-range ``ValueError`` included); they
  are the port's accuracy oracle.
* :func:`spline_eval` is the tensor evaluation the batched predictors use
  (``predictor.py``): NaN outside the grid unless ``extrapolate``.

The not-a-knot spline is built per interval in the local shifted basis
``(x - x_k)^p``, as tabcorr_tpu builds it.  Files are read from the
reference HDF5 schema (and written to it, :meth:`Interpolator.write`) or
from the ``.npz`` copy :meth:`write_npz` makes, which needs no h5py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.interpolate import CubicSpline

from .io import ColumnTable
from .table import TabCorr, import_h5py


def spline_interpolation_matrix(xp):
    """Not-a-knot cubic-spline coefficient-from-values matrices.

    Returns ``a`` of shape (n_intervals, 4, n_points): for interval ``k``
    and values ``y`` the spline at ``x`` in that interval is
    ``sum_p sum_j a[k, p, j] y[j] (x - xp[k])^p``.
    """
    xp = np.asarray(xp, dtype=np.float64)
    if len(xp) < 4:
        raise ValueError("Cannot perform spline interpolation with less "
                         "than 4 values.")
    # CubicSpline on identity y-vectors yields the linear map from values
    # to local polynomial coefficients; the default bc_type is not-a-knot.
    spline = CubicSpline(xp, np.eye(len(xp)), axis=0)
    # spline.c has shape (4, n_intervals, n_points) in descending powers.
    return np.ascontiguousarray(np.transpose(spline.c[::-1], (1, 0, 2)))


def _locate_interval(x, xp):
    """Interval index with reference edge semantics (interpolator.py:319-321)."""
    i = np.digitize(x, xp) - 1
    if x == xp[-1]:
        i = len(xp) - 2
    return i


def spline_interpolate(x, xp, a, yp, extrapolate=False):
    """Evaluate one or more (multi-dimensional) not-a-knot splines.

    Host float64 path (reference: tabcorr/interpolator.py:275-331):
    interpolates ``yp`` along its first ``len(x)`` axes, one grid axis per
    pass; raises if out of range and ``extrapolate`` is False, else clamps
    to the edge spline.
    """
    if not isinstance(xp, list):
        xp = [xp]
    if not isinstance(a, list):
        a = [a]
    x = np.atleast_1d(x)
    for xi, ai, xpi in zip(x, a, xp):
        i = _locate_interval(xi, xpi)
        if i < 0 or i >= len(xpi) - 1:
            if not extrapolate:
                raise ValueError(
                    "The x-coordinates are outside of the interpolation "
                    "range and extrapolation is turned off.")
            i = min(max(i, 0), len(xpi) - 2)
        dx = xi - xpi[i]
        yp = np.einsum("pj,j...,p->...", ai[i], yp, dx ** np.arange(4))
    return yp


def spline_eval(x, xp, a, yp, extrapolate=True):
    """Tensor spline evaluation along the leading axis of ``yp``.

    ``x`` may carry batch axes: the result has shape ``x.shape +
    yp.shape[1:]``.  With ``extrapolate=True`` out-of-range ``x`` clamps
    to the edge splines; with ``extrapolate=False`` the result is NaN
    outside [xp[0], xp[-1]] -- the batched analog of the reference's
    out-of-range ValueError, so an MCMC walker outside the grid poisons
    its likelihood instead of silently clamping.

    Operands of mixed types are promoted, as tabcorr_tpu's ``jnp``
    arithmetic promotes them; the result has the promoted type, computed
    in float32 where that is bfloat16.  (The conversion is exact, so the
    interval search and the range test see the values tabcorr_tpu
    compares.)
    """
    dtype = functools.reduce(torch.promote_types,
                             (x.dtype, xp.dtype, a.dtype, yp.dtype))
    wide = torch.float32 if dtype == torch.bfloat16 else dtype
    x, xp, a, yp = (v.to(wide) for v in (x, xp, a, yp))
    x = x.contiguous()
    i = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0,
                    xp.shape[0] - 2)
    dx = x - xp[i]
    # Powers by multiplication, as tabcorr_tpu takes them.
    powers = torch.stack([torch.ones_like(dx), dx, dx * dx, dx * dx * dx],
                         dim=-1)
    weights = torch.einsum("...pj,...p->...j", a[i], powers)
    out = torch.tensordot(weights, yp, dims=([-1], [0]))
    if not extrapolate:
        in_range = (x >= xp[0]) & (x <= xp[-1])
        in_range = in_range.reshape(in_range.shape + (1,) * (yp.dim() - 1))
        out = torch.where(in_range, out, torch.nan)
    return out.to(dtype)


class Interpolator:
    """Interpolation of multiple TabCorr instances over a parameter grid."""

    def __init__(self, tabcorr_list, param_dict_table):
        if len(tabcorr_list) != len(param_dict_table):
            raise ValueError("The number of TabCorr instances does not match"
                             " the number of entries in 'param_dict_table'.")
        self.tabcorr_list = list(tabcorr_list)
        if not isinstance(param_dict_table, ColumnTable):
            param_dict_table = ColumnTable(
                {k: np.asarray(v) for k, v in dict(param_dict_table).items()})
        self.param_dict_table = param_dict_table.copy()

        self.keys = [k for k in self.param_dict_table.colnames
                     if k != "tabcorr_index"]
        self.xp = []
        self.a = []
        for key in self.keys:
            self.xp.append(np.sort(np.unique(self.param_dict_table[key])))
            self.a.append(spline_interpolation_matrix(self.xp[-1]))

        # Grid validation (reference: tabcorr/interpolator.py:45-57).
        rows = np.stack([self.param_dict_table[k] for k in self.keys], axis=1)
        n_grid = int(np.prod([len(xp) for xp in self.xp]))
        if (n_grid != len(self.param_dict_table) or
                len(np.unique(rows, axis=0)) != len(rows)):
            raise ValueError(
                "The 'param_dict_table' does not describe a grid.")

        if "tabcorr_index" not in self.param_dict_table:
            self.param_dict_table["tabcorr_index"] = np.arange(
                len(self.param_dict_table))
        self.param_dict_table.sort(self.keys)

        # Identical halo binnings share one mean occupation (reference:
        # interpolator.py:63-70).
        digests = [t.gal_type.as_structured_array().tobytes()
                   for t in self.tabcorr_list]
        seen = {}
        self.unique_gal_type_index = []
        self.unique_gal_type_inverse = np.empty(len(digests), dtype=int)
        for i, digest in enumerate(digests):
            if digest not in seen:
                seen[digest] = len(self.unique_gal_type_index)
                self.unique_gal_type_index.append(i)
            self.unique_gal_type_inverse[i] = seen[digest]

    # ------------------------------------------------------------------
    @classmethod
    def read(cls, fname):
        """Read an interpolator from a reference-schema HDF5 file
        (interpolator.py:72-96) or from an ``.npz`` :meth:`write_npz`
        wrote."""
        if str(fname).endswith(".npz"):
            with np.load(fname, allow_pickle=False) as data:
                param_dict_table = ColumnTable.from_structured_array(
                    data["param_dict_table"])
                tabcorr_list = [
                    TabCorr.from_npz_arrays(data, prefix=f"tabcorr_{i}.")
                    for i in range(len(param_dict_table))]
            return cls(tabcorr_list, param_dict_table)
        import h5py

        with h5py.File(fname, "r") as fstream:
            param_dict_table = ColumnTable.read_hdf5(
                fstream, "param_dict_table")
            param_dict_table.sort("tabcorr_index")
            param_dict_table.remove_column("tabcorr_index")
            tabcorr_list = [TabCorr.read_hdf5_group(fstream[f"tabcorr_{i}"])
                            for i in range(len(param_dict_table))]
        return cls(tabcorr_list, param_dict_table)

    def write_npz(self, fname, max_args_size=1000000):
        """Write the grid table and every node's tabulation to one
        uncompressed ``.npz`` (matrices in float32 and tpcf arguments
        below ``max_args_size`` elements, as :meth:`write` stores them).
        The grid table is stored in node order, without ``tabcorr_index``,
        as :meth:`read` hands it to the constructor."""
        table = self.param_dict_table.copy()
        table.sort("tabcorr_index")
        table.remove_column("tabcorr_index")
        arrays = {"param_dict_table": table.as_structured_array()}
        for i, tab in enumerate(self.tabcorr_list):
            arrays.update(tab.npz_arrays(prefix=f"tabcorr_{i}.",
                                         max_args_size=max_args_size))
        np.savez(fname, **arrays)

    def write(self, fname, overwrite=False, max_args_size=1000000,
              matrix_dtype=np.float32):
        """Write in the reference's HDF5 schema (interpolator.py:98-122):
        ``param_dict_table`` (with ``tabcorr_index``), then each node's
        tabulation in group ``tabcorr_i`` (:meth:`TabCorr.write`).  Mode
        "w-" unless ``overwrite``.  Needs h5py (:meth:`write_npz` does
        not)."""
        h5py = import_h5py("Interpolator.write")
        with h5py.File(fname, "w" if overwrite else "w-") as fstream:
            self.param_dict_table.write_hdf5(fstream, "param_dict_table")
            for i, tab in enumerate(self.tabcorr_list):
                tab.write_hdf5_group(fstream.create_group(f"tabcorr_{i}"),
                                     max_args_size, matrix_dtype)

    # ------------------------------------------------------------------
    def predict(self, model, separate_gal_type=False, n_gauss_prim=10,
                extrapolate=False, check_consistency=True):
        """Interpolated float64 prediction (reference:
        interpolator.py:124-216); the grid coordinates are read from
        ``model.param_dict``."""
        x_model = np.empty(len(self.keys))
        for i, key in enumerate(self.keys):
            try:
                x_model[i] = model.param_dict[key]
            except KeyError:
                raise ValueError(
                    f"The key {key} is not present in the parameter "
                    "dictionary of the model.")

        mean_occupation = [
            self.tabcorr_list[i].mean_occupation(
                model, n_gauss_prim=n_gauss_prim,
                check_consistency=check_consistency)
            for i in self.unique_gal_type_index]

        results = []
        for i in range(len(self.param_dict_table)):
            k = self.param_dict_table["tabcorr_index"][i]
            results.append(self.tabcorr_list[k].predict(
                mean_occupation[self.unique_gal_type_inverse[k]],
                separate_gal_type=separate_gal_type))

        grid_shape = [len(xp) for xp in self.xp]
        output = []
        for i in range(2):
            if separate_gal_type:
                out = {}
                for key in results[0][i].keys():
                    data = np.array([r[i][key] for r in results])
                    data = data.reshape(grid_shape + list(data.shape[1:]))
                    out[key] = spline_interpolate(
                        x_model, self.xp, self.a, data,
                        extrapolate=extrapolate)
                output.append(out)
            else:
                data = np.array([r[i] for r in results])
                data = data.reshape(grid_shape + list(data.shape[1:]))
                output.append(spline_interpolate(
                    x_model, self.xp, self.a, data, extrapolate=extrapolate))
        return tuple(output)

    def make_predictor(self, model, **kwargs):
        """Batched predictor through the grid splines
        (:func:`tabcorr_tpu_torch.predictor.make_predictor`)."""
        from .predictor import make_predictor
        return make_predictor(self, model, **kwargs)

    def __repr__(self):
        return (f"Interpolator(keys={self.keys}, "
                f"grid={[len(xp) for xp in self.xp]}, "
                f"n_tables={len(self.tabcorr_list)})")
