"""A configuration of one Interpolator file through ``make_predictor``.

The configuration's one table names an Interpolator ``.npz`` (the
``write_npz`` schema: ``param_dict_table`` and each node's
``tabcorr_<i>.*`` arrays) under the benchmark's ``data/``.  The program
reads it with ``Interpolator.read`` (float32 ``engine='fused'``: the grid
spline's node weights, then the kernels of the model's route a call); the
reference reads the same file's raw arrays with numpy.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from benchlib.inputs import RawTable, hod_model
from benchlib.manifest import ROOT


def read_grid(path):
    """The raw grid of an Interpolator ``.npz``: every node's matrix as
    (n_nodes, n_xi, n_stored) float64, the shared bins' columns, the mode,
    shape and redshift, and the grid's keys and (n_nodes, n_keys) values
    in node order."""
    with np.load(path, allow_pickle=False) as d:
        grid = d["param_dict_table"]
        keys = list(grid.dtype.names)
        values = np.stack([grid[k] for k in keys], axis=1).astype(np.float64)
        n_nodes = len(grid)
        attrs = json.loads(str(d["tabcorr_0.attrs"]))
        gal = d["tabcorr_0.gal_type"]
        for i in range(1, n_nodes):
            if not np.array_equal(d[f"tabcorr_{i}.gal_type"], gal):
                raise ValueError(f"{path}: the nodes' halo bins differ")
        matrix = np.stack([d[f"tabcorr_{i}.tpcf_matrix"]
                           for i in range(n_nodes)]).astype(np.float64)
        return RawTable(matrix=matrix,
                        columns={k: np.array(gal[k])
                                 for k in gal.dtype.names},
                        mode=attrs["mode"],
                        tpcf_shape=tuple(int(s) for s in
                                         d["tabcorr_0.tpcf_shape"]),
                        redshift=float(attrs["redshift"]),
                        grid=(keys, values))


def inputs(config, seed, device):
    """The raw grid, read from its file (the seed changes nothing), its
    nodes' values rounded to float32 as the program's grid holds them, so
    that both sides test a parameter against the same edges."""
    raw = read_grid(ROOT / config["tables"][0]["file"])
    keys, values = raw.grid
    raw.grid = (keys, values.astype(np.float32).astype(np.float64))
    return [raw]


def program(config, raw, device, precision="float32"):
    """``(predict_all, base_params)`` as for a TabCorr configuration; the
    control ``precision="bf16"`` is the port's bfloat16 Interpolator
    route.  Refuses a port that predicts a number outside the model's
    domain (:func:`refuse_outside_the_domain`)."""
    import tabcorr_tpu_torch as tt
    interp = tt.Interpolator.read(ROOT / config["tables"][0]["file"])
    hod = hod_model(config, raw[0].redshift)
    accuracy = config["tables"][0]["accuracy"]
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    predict = tt.make_predictor(interp, hod, dtype=dtype, engine="fused",
                                accuracy=accuracy, device=device)
    refuse_outside_the_domain(predict, config, dtype, device)
    return (lambda params: [predict(params)]), dict(hod.param_dict)


def refuse_outside_the_domain(predict, config, dtype, device):
    """Exit unless ``predict`` gives NaN at the fiducial point with a
    central scatter of -0.2, as the reference does: no log-normal has a
    width below zero.  The ensemble's proposals reach such points, so a
    port that predicts a number there fails every comparison; it fails
    here, at once, before its rate is measured."""
    params = {k: torch.tensor([float(v)], dtype=dtype, device=device)
              for k, v in config["fiducial"].items()}
    params["scatter_model_param1"].fill_(-0.2)
    ngal, _ = predict(params)
    if not bool(torch.isnan(ngal).all()):
        raise SystemExit("benchmark: the port predicts a number at a "
                         "central scatter below zero, where the reference "
                         "is undefined")
