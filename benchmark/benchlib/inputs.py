"""What both sides are handed: raw tables, as stored, and the HOD model.

A :class:`RawTable` holds a table as its file stores it (or as the
benchmark made it from the seed): the packed matrices, the bins' columns
and the grid's nodes.  The program is built from these through its own
API; the reference reads them directly.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np


@dataclass
class RawTable:
    matrix: np.ndarray       # (n_nodes, n_xi, n_stored) float64
    columns: dict            # the bins' columns
    mode: str
    tpcf_shape: tuple
    redshift: float
    grid: tuple | None = None    # (keys, values (n_nodes, n_keys))


def read_npz(path):
    """A table from TabCorr's ``write_npz`` schema, read with numpy."""
    with np.load(path, allow_pickle=False) as d:
        attrs = json.loads(str(d["attrs"]))
        gal = d["gal_type"]
        return RawTable(matrix=d["tpcf_matrix"].astype(np.float64)[None],
                        columns={k: np.array(gal[k])
                                 for k in gal.dtype.names},
                        mode=attrs["mode"],
                        tpcf_shape=tuple(int(s) for s in d["tpcf_shape"]),
                        redshift=float(attrs["redshift"]))


def hod_model(config, redshift):
    """The port's model of the configuration, at its fiducial point."""
    import tabcorr_tpu_torch as tt
    spec = config["model"]
    model = getattr(tt, spec["class"])(redshift=redshift, **spec["kwargs"])
    model.param_dict.update(config["fiducial"])
    return model
