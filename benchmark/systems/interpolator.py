"""A configuration of one Interpolator grid through ``make_predictor``.

The configuration's ``grid`` names a table generator (``tables/<name>.py``)
and its sizes; the tables are made from the seed on the device and handed
to both sides: the program gets them as TabCorr objects in an
``Interpolator`` (float32 ``engine='fused'``: the grid spline's node
weights, then one launch of the grid kernel a call), the reference as the
raw arrays.
"""

from __future__ import annotations

import torch

from benchlib.inputs import RawTable, hod_model
from benchlib.manifest import load
from benchlib.traffic import generator


def inputs(config, seed, device):
    grid = config["grid"]
    cols, matrices, keys, values = load("tables", grid["generator"]).make(
        grid, generator(seed, "tables", device), device)
    return [RawTable(matrix=matrices,
                     columns=cols, mode="auto",
                     tpcf_shape=tuple(grid["tpcf_shape"]),
                     redshift=float(grid["redshift"]), grid=(keys, values))]


def interpolator(raw):
    """The port's Interpolator over ``raw``'s nodes."""
    import tabcorr_tpu_torch as tt
    from tabcorr_tpu_torch.io import ColumnTable
    keys, values = raw.grid
    tabs = []
    for matrix in raw.matrix:
        t = tt.TabCorr()
        t.gal_type = ColumnTable(raw.columns)
        t.attrs = {"mode": raw.mode, "tpcf": "synthetic",
                   "redshift": raw.redshift, "simname": "synthetic",
                   "Num_ptcl_requirement": 300,
                   "prim_haloprop_key": "halo_mvir",
                   "sec_haloprop_key": "halo_nfw_conc"}
        t.tpcf_shape = raw.tpcf_shape
        t.tpcf_matrix = matrix
        tabs.append(t)
    table = ColumnTable({k: values[:, a] for a, k in enumerate(keys)})
    return tt.Interpolator(tabs, table)


def program(config, raw, device, precision="float32"):
    """``(predict_all, base_params)`` as for a TabCorr configuration; the
    control ``precision="bf16"`` is the port's bfloat16 grid route."""
    import tabcorr_tpu_torch as tt
    interp = interpolator(raw[0])
    hod = hod_model(config, raw[0].redshift)
    accuracy = config["tables"][0]["accuracy"]
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    predict = tt.make_predictor(interp, hod, dtype=dtype, engine="fused",
                                accuracy=accuracy, device=device)
    return (lambda params: [predict(params)]), dict(hod.param_dict)

