"""A configuration of TabCorr tables, joint, through one predictor.

The configuration's ``tables`` name ``.npz`` files (TabCorr's ``write_npz``
schema) under the benchmark's ``data/``.  The program reads each with
``TabCorr.read`` and predicts them together with ``make_multi_predictor``
(float32: one launch of the bundle kernel a call); the reference reads the
same files' raw arrays.
"""

from __future__ import annotations

import torch

from benchlib.inputs import hod_model, read_npz
from benchlib.manifest import ROOT


def inputs(config, seed, device):
    """The raw tables, read from their files (the seed changes nothing)."""
    return [read_npz(ROOT / t["file"]) for t in config["tables"]]


def program(config, raw, device, precision="float32"):
    """``(predict_all, base_params)``: the port's predictor of every table
    (``params -> [(ngal, xi), ...]``) and the model's parameters.

    ``precision="bf16"`` is the control: the port's bfloat16 route
    (``engine='auto'`` in bfloat16: the bfloat16 contraction kernel a
    table on the card)."""
    import tabcorr_tpu_torch as tt
    tabs = [tt.TabCorr.read(ROOT / t["file"]) for t in config["tables"]]
    hod = hod_model(config, raw[0].redshift)
    accuracy = tuple(t["accuracy"] for t in config["tables"])
    if precision == "bf16":
        predict = tt.make_multi_predictor(
            tabs, hod, dtype=torch.bfloat16, engine="auto",
            accuracy=accuracy, device=device)
    else:
        predict = tt.make_multi_predictor(tabs, hod, accuracy=accuracy,
                                          device=device)
    return predict, dict(hod.param_dict)
