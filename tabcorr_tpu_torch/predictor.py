"""Batched prediction: the port's main entry points.

:func:`make_multi_predictor` turns several tabulations plus an HOD model
into one function

    f(params: dict[str, (B,) tensor]) -> [(ngal (B,), xi (B, *tpcf_shape)), ...]

that evaluates every statistic for a whole parameter batch -- on a CUDA
device through one launch of the hand-written bundle kernel
(``ops.fused``).  :func:`make_predictor` is the plain tensor path for one
tabulation.
"""

from __future__ import annotations

import torch

from .models.protocol import occupation_functions
from .ops import fused
from .ops.predict import mean_occupation, predict_from_occupation
from .table import TabCorr
from .utils.device import resolve_device

__all__ = ["occupation_functions", "make_predictor", "make_multi_predictor",
           "params_batch"]


def make_predictor(halotab: TabCorr, model, n_gauss=10, dtype=torch.float32,
                   *, device):
    """Batched predictor for one tabulation through plain tensor ops.

    Returns ``f(params dict of (B,) tensors) -> (ngal (B,), xi (B,
    *tpcf_shape))``.  ``dtype=torch.float64`` matches the float64 host
    path to rounding.
    """
    table = halotab.table_data(n_gauss=n_gauss, dtype=dtype, device=device)
    occ_cen, occ_sat = occupation_functions(model)

    def predict(params):
        mean_occ = mean_occupation(table, occ_cen, occ_sat, params)
        ngal, xi = predict_from_occupation(table, mean_occ)
        return ngal, xi.reshape(xi.shape[:-1] + table.tpcf_shape)

    return predict


def make_multi_predictor(objs, model, n_gauss=10, *, device,
                         engine="bundle", accuracy=None):
    """Joint predictor over several tabulations (e.g. wp + xi_0/2/4 + ds).

    Parameters
    ----------
    objs : sequence of TabCorr
    model : HodModel
        A :class:`~.models.zheng07.Zheng07Model` for the CUDA kernel.
    n_gauss : int, optional
        Gauss-Legendre nodes per halo bin. Default 10.
    device : str or torch.device
        Where the tables live and the batch runs ('cpu' or 'cuda').
    engine : str, optional
        'bundle' (default): on a CUDA device one launch of the bundle
        kernel per call, on the CPU its plain version.  'plain': the plain
        tensor version on any device (tests and timing).
    accuracy : sequence of str, optional
        One contract per table, 'elementwise' (default) or 'scaled'.
        Both run at full float32 precision.

    Returns
    -------
    callable
        ``f(params dict of (B,) float32 tensors) -> [(ngal, xi), ...]``,
        float32 throughout.
    """
    device = resolve_device(device)
    if engine not in ("bundle", "plain"):
        raise ValueError(f"Unknown engine: {engine!r}")
    accuracy = fused.check_accuracy(accuracy, len(objs))
    tables = [obj.table_data(n_gauss=n_gauss, dtype=torch.float32,
                             device=device) for obj in objs]
    if engine == "bundle":
        return fused.make_fused_bundle_predictor(tables, model, accuracy)
    if device.type == "cuda":
        # The plain version's matmuls must stay full float32 (TF32 keeps
        # ~10 mantissa bits).
        torch.backends.cuda.matmul.allow_tf32 = False
    consts = [fused.bundle_table_constants(t) for t in tables]
    occ_cen, occ_sat = occupation_functions(model)

    def predict_plain(params):
        return fused.shaped(consts, fused.bundle_predict_plain(
            consts, params, occ_cen, occ_sat))

    return predict_plain


def params_batch(model, overrides=None, batch_shape=(), dtype=torch.float32,
                 *, device):
    """A batched parameter dict from a model's ``param_dict``.

    ``overrides`` maps names to arrays of ``batch_shape``; every other
    parameter is broadcast from the model's current value.
    """
    device = resolve_device(device)
    overrides = overrides or {}
    out = {}
    for key, value in model.param_dict.items():
        if key in overrides:
            out[key] = torch.as_tensor(overrides[key], dtype=dtype,
                                       device=device)
        else:
            out[key] = torch.full(batch_shape, value, dtype=dtype,
                                  device=device)
    for key in overrides:
        if key not in out:
            out[key] = torch.as_tensor(overrides[key], dtype=dtype,
                                       device=device)
    return out
