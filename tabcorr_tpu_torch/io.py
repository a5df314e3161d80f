"""Column tables and HDF5 attributes in the reference's file layout.

The reference stores tables via ``astropy.table.Table.write(..., path=...)``,
a plain HDF5 dataset with a numpy structured dtype (reference:
tabcorr/tabcorr.py:414,463).  Nothing here imports ``h5py``: the HDF5
reader and writers in ``table.py`` and ``interpolator.py`` import it and
pass open groups in, so the ``.npz`` route needs numpy alone.
"""

from __future__ import annotations

import numpy as np


class ColumnTable:
    """Minimal ordered column table (astropy.table.Table stand-in):
    named 1-D numpy columns of equal length, read from and written to a
    numpy structured array."""

    def __init__(self, data=None):
        self._cols: dict[str, np.ndarray] = {}
        if data is not None:
            for key, value in data.items():
                self[key] = value

    @property
    def colnames(self) -> list[str]:
        return list(self._cols.keys())

    def __contains__(self, key):
        return key in self._cols

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        # Row selection with a mask or an index array: a new table.
        out = ColumnTable()
        for name, col in self._cols.items():
            out._cols[name] = col[key]
        return out

    def __setitem__(self, key, value):
        value = np.asarray(value)
        if value.ndim == 0:
            value = np.repeat(value, len(self)) if self._cols else value[None]
        if self._cols and len(value) != len(self):
            raise ValueError(
                f"Column {key!r} has length {len(value)}, expected "
                f"{len(self)}.")
        self._cols[key] = value

    def __len__(self):
        if not self._cols:
            return 0
        return len(next(iter(self._cols.values())))

    def __iter__(self):
        return iter(self._cols)

    def remove_column(self, key):
        del self._cols[key]

    def copy(self):
        out = ColumnTable()
        for name, col in self._cols.items():
            out._cols[name] = col.copy()
        return out

    def sort(self, keys):
        """Sort the rows in place by ``keys`` (the first is the primary
        key), with ``np.lexsort`` as tabcorr_tpu sorts them."""
        if isinstance(keys, str):
            keys = [keys]
        order = np.lexsort([self._cols[k] for k in reversed(keys)])
        for name in self._cols:
            self._cols[name] = self._cols[name][order]

    def as_structured_array(self) -> np.ndarray:
        # dtype.str drops the metadata h5py attaches to string dtypes,
        # which .npy files cannot store.
        dtype = [(name, np.dtype(col.dtype.str), col.shape[1:])
                 for name, col in self._cols.items()]
        out = np.empty(len(self), dtype=dtype)
        for name, col in self._cols.items():
            out[name] = col
        return out

    def as_array(self):
        """The table as a numpy structured array (astropy's name)."""
        return self.as_structured_array()

    @classmethod
    def from_structured_array(cls, arr: np.ndarray) -> "ColumnTable":
        out = cls()
        for name in arr.dtype.names:
            out._cols[name] = np.ascontiguousarray(arr[name])
        return out

    @classmethod
    def read_hdf5(cls, group, path: str) -> "ColumnTable":
        """Read a structured dataset (written by astropy or tabcorr_tpu)
        from an open h5py group."""
        return cls.from_structured_array(group[path][()])

    def write_hdf5(self, group, path: str):
        """Write as a structured dataset (the reference's astropy layout)
        into an open h5py group."""
        group[path] = self.as_structured_array()


def vstack(tables) -> ColumnTable:
    """Stack tables with identical columns vertically."""
    out = ColumnTable()
    for name in tables[0].colnames:
        out[name] = np.concatenate([t[name] for t in tables])
    return out


def read_attrs(group) -> dict:
    """Read HDF5 attributes, decoding bytes to str."""
    attrs = {}
    for key in group.attrs.keys():
        value = group.attrs[key]
        if isinstance(value, bytes):
            value = value.decode("utf-8")
        attrs[key] = value
    return attrs
