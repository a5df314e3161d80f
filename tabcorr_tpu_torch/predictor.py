"""Batched prediction: the port's entry points.

:func:`make_predictor` turns a :class:`~.table.TabCorr` or an
:class:`~.interpolator.Interpolator` plus an HOD model into one function

    f(params: dict[str, (B,) tensor]) -> (ngal (B,), xi (B, *tpcf_shape))

that evaluates a whole parameter batch.  Its engines:

* 'fused' -- on a CUDA device a hand-written kernel per call (``ops.fused``):
  for a TabCorr the densities (the occupation kernel of the HOD families,
  else tensor ops), then the contraction kernel;
  for an Interpolator the grid kernel with the grid spline folded in, or,
  for auto tables too wide for its packed layout (more than 127 bins), the
  slab kernel and then the grid spline in tensor ops.  On the CPU the same
  call runs the kernels' plain versions.
* 'fused' in bfloat16 -- tabcorr_tpu's bf16 route: parameters rounded to
  bfloat16, the densities in tensor ops rounded to bfloat16, then the
  bfloat16 contraction kernel (``ops.fused.contraction_bf16_launch``), for
  an Interpolator over every node's rows and then the grid spline.
* 'plain' -- tensor ops only: per node mean occupation and contraction,
  then the grid splines (the reference pipeline, heterogeneous node
  binnings included; reference: tabcorr/interpolator.py:124-216).
* 'auto' (default) -- 'fused' on CUDA where the object, model and dtype
  allow it, 'plain' otherwise.

The fused engines take every model whose ``supports_fused_engine`` is true,
as tabcorr_tpu's do (``tabcorr_tpu/predictor.py:474-498``): zheng07 and its
decoration are evaluated inside the kernels, every other model's densities
ahead of them: by the occupation kernel for the SHMR, CLF and
quiescent/active families and their decorations, in tensor ops for any
other model (``ops.fused.kernel_model``, ``ops.fused.OccupationFamily``).
A model whose flag is false (the non-parametric HOD) runs the plain engine
under 'auto' and raises under 'fused' and 'bundle'.

Every entry point runs on the CUDA device unless ``device="cpu"`` is
passed; without a card it raises (``utils.device.resolve_device``).

:func:`make_multi_predictor` evaluates several tabulations at once: through
one launch of the bundle kernel, or (``engine='auto'``) one predictor per
member where the bundle does not take them (Interpolators, float64).

The kernels compute no gradient; autograd runs through the plain engine,
in float64 for the gradient samplers (``mcmc.run_hmc``, ``mcmc.run_nuts``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .interpolator import Interpolator, spline_eval
from .models.protocol import occupation_functions
from .ops import fused
from .ops.predict import (TableData, mean_occupation, predict_from_occupation,
                          predict_from_occupation_separate, promoted_einsum)
from .table import TabCorr
from .utils.device import host_tensor, resolve_device

__all__ = ["occupation_functions", "make_predictor", "make_multi_predictor",
           "multi_engine_for", "make_occupation_predictor", "params_batch",
           "stacked_grid", "grid_node_weights"]

ENGINES = ("auto", "fused", "plain")


def _tabcorr_predict_fn(halotab, model, n_gauss, dtype, separate_gal_type,
                        device):
    table = halotab.table_data(n_gauss=n_gauss, dtype=dtype, device=device)
    occ_cen, occ_sat = occupation_functions(model)

    def predict(params):
        mean_occ = mean_occupation(table, occ_cen, occ_sat, params)
        if separate_gal_type:
            return predict_from_occupation_separate(table, mean_occ)
        ngal, xi = predict_from_occupation(table, mean_occ)
        return ngal, xi.reshape(xi.shape[:-1] + table.tpcf_shape)

    return predict


def _pad_table_data(table: TableData, n_cen, n_sat) -> TableData:
    """Pad a TableData to (n_cen centrals + n_sat satellites) bins.

    Bins are ordered [centrals..., satellites...]; zero bins are inserted
    after each block.  Padded bins carry quad_weight = 0 (mean occupation
    exactly 0), n_h = 0 and zero matrix rows and columns, so they add
    nothing to any contraction; this lets Interpolator nodes with
    different halo binnings share one stack (reference: interpolator.py:
    63-70).
    """
    old_cen = table.n_centrals
    pad_c = n_cen - old_cen
    pad_s = n_sat - (table.n_bins - old_cen)
    if pad_c == 0 and pad_s == 0:
        return table
    if pad_c < 0 or pad_s < 0:
        raise ValueError("Cannot pad to fewer bins.")

    def pad_axis(x, axis):
        if x is None:
            return None
        parts = []
        for lo, hi, pad in ((0, old_cen, pad_c),
                            (old_cen, x.shape[axis], pad_s)):
            parts.append(x.narrow(axis, lo, hi - lo))
            shape = list(x.shape)
            shape[axis] = pad
            parts.append(x.new_zeros(shape))
        return torch.cat(parts, dim=axis)

    dense = pad_axis(table.tpcf_dense, 1)
    if table.mode == "auto":
        dense = pad_axis(dense, 2)
    return dataclasses.replace(
        table, tpcf_dense=dense, n_h=pad_axis(table.n_h, 0),
        log_prim_quad=pad_axis(table.log_prim_quad, 0),
        quad_weight=pad_axis(table.quad_weight, 0),
        sec_perc=pad_axis(table.sec_perc, 0), n_centrals=n_cen,
        log_prim_quad_lo=pad_axis(table.log_prim_quad_lo, 0))


def _spline_constants(interp, dtype, device):
    """The grid's abscissae and spline matrices in ``dtype`` on
    ``device`` (bfloat16 rounded once from float64, as tabcorr_tpu's
    ``xp_dev`` and ``a_dev``)."""
    xp = [host_tensor(x, dtype).to(device) for x in interp.xp]
    a = [host_tensor(x, dtype).to(device) for x in interp.a]
    return tuple(interp.keys), xp, a


def _axis_weights(x, xp, a, extrapolate):
    """(B, len(xp)) weights of one grid axis: the spline applied to the
    identity ordinates (float32 at least: bfloat16 weights are not
    rounded)."""
    eye = torch.eye(xp.shape[0], device=xp.device,
                    dtype=torch.promote_types(xp.dtype, torch.float32))
    return spline_eval(x, xp, a, eye, extrapolate=extrapolate)


def _spline_over_grid(params, keys, xp_dev, a_dev, grid_shape, values,
                      extrapolate=True):
    """Reduce the grid axes of ``values`` (B, n_nodes, ...), one spline
    pass per key; returns (B, ...) in tabcorr_tpu's result type (that of
    the values, parameters and constants together), computed in float32
    where that is bfloat16."""
    dtype = values.dtype
    y = values.reshape(values.shape[:1] + tuple(grid_shape) +
                       values.shape[2:])
    for key, xp, a in zip(keys, xp_dev, a_dev):
        dtype = torch.promote_types(
            dtype, torch.promote_types(params[key].dtype, xp.dtype))
        w = _axis_weights(params[key], xp, a, extrapolate)
        y = promoted_einsum("bj,bj...->b...", w, y)
    return y.to(dtype)


def _grid_node_weights(params, keys, xp_dev, a_dev, extrapolate=True):
    """Per-sample node weights (B, n_nodes) of the multi-axis grid spline.

    Each spline pass is linear in its ordinates, so the whole grid
    reduction is one weight vector per sample: the outer product of the
    axis weights, flattened in C (grid) order, so that
    ``_spline_over_grid(values) == node_weights @ values`` up to float32
    summation order.  NaN (``extrapolate=False`` outside the grid) appears
    in every weight of the offending sample.
    """
    w = None
    for key, xp, a in zip(keys, xp_dev, a_dev):
        wk = _axis_weights(params[key], xp, a, extrapolate)
        w = wk if w is None else (
            w[:, :, None] * wk[:, None, :]).reshape(w.shape[0], -1)
    return w


def _grid_order(interp):
    """Node indices in grid order (the sorted ``param_dict_table``)."""
    return [int(i) for i in interp.param_dict_table["tabcorr_index"]]


def _interpolator_predict_fn(interp, model, n_gauss, dtype,
                             separate_gal_type, extrapolate, device):
    """The plain engine: tensor-op occupation once per unique halo
    binning, every node's contraction, then the grid splines."""
    order = _grid_order(interp)
    tables = [interp.tabcorr_list[i].table_data(
        n_gauss=n_gauss, dtype=dtype, device=device) for i in order]
    # Heterogeneous node binnings: zero-pad every node to the widest
    # (centrals, satellites) blocks so that the occupations stack.
    n_cen = max(t.n_centrals for t in tables)
    n_sat = max(t.n_bins - t.n_centrals for t in tables)
    tables = [_pad_table_data(t, n_cen, n_sat) for t in tables]
    unique_nodes = [order.index(i) if i in order else 0
                    for i in interp.unique_gal_type_index]
    inverse_for_node = [int(interp.unique_gal_type_inverse[i])
                        for i in order]
    occ_cen, occ_sat = occupation_functions(model)
    keys, xp_dev, a_dev = _spline_constants(interp, dtype, device)
    grid_shape = tuple(len(xp) for xp in interp.xp)

    def spline(params, values):
        return _spline_over_grid(params, keys, xp_dev, a_dev, grid_shape,
                                 values, extrapolate)

    def predict(params):
        occ_unique = torch.stack([
            mean_occupation(tables[k], occ_cen, occ_sat, params)
            for k in unique_nodes])
        occ_nodes = [occ_unique[u] for u in inverse_for_node]
        if separate_gal_type:
            per_node = [predict_from_occupation_separate(t, o)
                        for t, o in zip(tables, occ_nodes)]
            return tuple(
                {key: spline(params, torch.stack(
                    [out[part][key] for out in per_node], dim=1))
                 for key in per_node[0][part]}
                for part in (0, 1))
        per_node = [predict_from_occupation(t, o)
                    for t, o in zip(tables, occ_nodes)]
        ngal = spline(params, torch.stack([n for n, _ in per_node], dim=1))
        xi = spline(params, torch.stack([x for _, x in per_node], dim=1))
        return ngal, xi.reshape(xi.shape[:1] + tables[0].tpcf_shape)

    return predict


def stacked_grid(interp, n_gauss=10, *, device="cuda", dtype=torch.float32):
    """An Interpolator whose nodes share one halo binning as one TableData
    of ``dtype`` (float32 or bfloat16): every node's statistic rows
    stacked in grid order on the statistic axis.  Returns (stacked table,
    n_nodes, one node's tpcf_shape)."""
    if len(interp.unique_gal_type_index) != 1:
        raise ValueError("engine='fused' requires all Interpolator nodes "
                         "to share one halo binning.")
    tables = [interp.tabcorr_list[i].table_data(
        n_gauss=n_gauss, dtype=dtype, device=device)
        for i in _grid_order(interp)]
    base = tables[0]
    stacked = dataclasses.replace(
        base, tpcf_dense=torch.cat([t.tpcf_dense for t in tables]),
        tpcf_shape=(len(tables) * base.tpcf_dense.shape[0],))
    return stacked, len(tables), base.tpcf_shape


def grid_node_weights(interp, params, extrapolate=False):
    """(B, n_nodes) float32 weights of the grid spline for the batch
    ``params``, on its device (NaN rows outside the grid unless
    ``extrapolate``)."""
    device = next(iter(params.values())).device
    keys, xp_dev, a_dev = _spline_constants(interp, torch.float32, device)
    return _grid_node_weights(params, keys, xp_dev, a_dev, extrapolate)


def _interpolator_fused_predict_fn(interp, model, n_gauss, extrapolate,
                                   accuracy, device, mesh=None,
                                   batch_axis="dp"):
    """The fused engine for an Interpolator whose nodes share one halo
    binning.  Packed layout (:func:`~.ops.fused.grid_layout_for`): one
    grid kernel per call evaluates the occupation, every node's
    contraction and the grid spline (folded in as per-sample node
    weights).  Slab layout: one slab kernel per call gives every node's
    statistics, then the grid spline runs in tensor ops (reference route:
    tabcorr_tpu/predictor.py:322-346).  Samples outside the grid get NaN
    ngal and xi, as the plain engine's splined ngal does.  With a
    ``mesh``, each rank takes its rows of the global batch (node weights,
    kernel and spline alike; ``ops.fused.rank_rows``)."""
    stacked, n_nodes, tpcf_shape = stacked_grid(interp, n_gauss,
                                                device=device)
    keys, xp_dev, a_dev = _spline_constants(interp, torch.float32, device)
    if fused.grid_layout_for(stacked) == "slab":
        node_fn = fused.make_fused_grid_predictor(
            stacked, n_nodes, model, accuracy=accuracy, layout="slab")
        grid_shape = tuple(len(xp) for xp in interp.xp)

        def predict_slab(params):
            batch = next(iter(params.values())).shape[0]
            total, xi_nodes = node_fn(params)
            xi = _spline_over_grid(params, keys, xp_dev, a_dev, grid_shape,
                                   xi_nodes, extrapolate)
            # NaN spline weights (outside the grid) show as NaN rows of xi;
            # they poison ngal too, as in the packed route.
            total = torch.where(torch.isnan(xi.sum(dim=-1)), torch.nan, total)
            return total, xi.reshape((batch,) + tuple(tpcf_shape))

        return fused.rank_rows(predict_slab, mesh, batch_axis)

    node_fn = fused.make_fused_grid_predictor(
        stacked, n_nodes, model, accuracy=accuracy, fold_spline=True)

    def predict_batch(params):
        batch = next(iter(params.values())).shape[0]
        nw = _grid_node_weights(params, keys, xp_dev, a_dev, extrapolate)
        total, xi = node_fn(params, nw)
        # ngal is the same at every node of a shared binning, so in-grid
        # samples pass it through exactly; out-of-grid samples are
        # poisoned like their xi (reference: interpolator.py:196-205).
        total = torch.where(torch.isnan(nw.sum(dim=-1)), torch.nan, total)
        return total, xi.reshape((batch,) + tuple(tpcf_shape))

    return fused.rank_rows(predict_batch, mesh, batch_axis)


def _interpolator_bf16_predict_fn(obj, model, n_gauss, extrapolate,
                                   accuracy, device):
    """The fused engine in bfloat16 for an Interpolator, tabcorr_tpu's
    route step for step (``tabcorr_tpu/predictor.py:352-390``): the
    parameters rounded to bfloat16, the densities in tensor ops on the
    bfloat16 table, the bfloat16 contraction kernel
    (``ops.fused.contraction_bf16_launch``) over every node's rows
    stacked, then the grid spline in bfloat16 over (B, n_nodes, n_xi),
    NaN outside the grid with ngal poisoned in those rows.  ngal and xi
    are bfloat16.  (A TabCorr's bfloat16 route is
    ``ops.fused.make_fused_predictor`` on its bfloat16 table.)"""
    stacked, n_nodes, tpcf_shape = stacked_grid(
        obj, n_gauss, device=device, dtype=torch.bfloat16)
    contract = fused.make_fused_contraction(stacked, accuracy)
    keys, xp_dev, a_dev = _spline_constants(obj, torch.bfloat16, device)
    grid_shape = tuple(len(xp) for xp in obj.xp)

    def predict_bf16(params):
        p = {k: v.to(torch.bfloat16) for k, v in params.items()}
        total, xi_nodes = contract(fused.bf16_densities(stacked, model, p))
        batch = total.shape[0]
        xi = _spline_over_grid(p, keys, xp_dev, a_dev, grid_shape,
                               xi_nodes.reshape(batch, n_nodes, -1),
                               extrapolate)
        total = torch.where(torch.isnan(xi.sum(dim=-1)), torch.nan, total)
        return fused.refuse_gradient(
            (total, xi.reshape((batch,) + tuple(tpcf_shape))), params)

    return predict_bf16


def _fused_kernel_takes(obj, dtype=torch.float32):
    """Whether a CUDA kernel takes ``obj``'s shapes in ``dtype``."""
    tab = obj if isinstance(obj, TabCorr) else obj.tabcorr_list[0]
    n_xi = int(np.prod(tab.tpcf_shape))
    if dtype == torch.bfloat16:
        rows = n_xi if isinstance(obj, TabCorr) else n_xi * len(
            obj.tabcorr_list)
        return fused.contraction_bf16_takes(tab.n_bins, rows)
    if isinstance(obj, TabCorr):
        return fused.contraction_fits(tab.n_bins, n_xi)
    return fused.grid_kernel_takes(tab.n_bins, tab.mode, n_xi)


def _fused_eligible(obj, model, dtype, separate_gal_type, vectorized=True):
    return (vectorized and not separate_gal_type and
            dtype in (torch.float32, torch.bfloat16) and
            getattr(model, "supports_fused_engine", True) and
            (isinstance(obj, TabCorr) or
             len(obj.unique_gal_type_index) == 1))


def _auto_engine(obj, model, dtype, separate_gal_type, device,
                 vectorized=True):
    """The engine 'auto' picks: 'fused' on CUDA where the object, model
    and dtype allow it and a kernel takes the shapes, else 'plain'."""
    return ("fused" if device.type == "cuda" and
            _fused_eligible(obj, model, dtype, separate_gal_type,
                            vectorized) and
            _fused_kernel_takes(obj, dtype) else "plain")


def _unbatched(predict, dtype, device):
    """``predict`` over a dict of 0-d tensors: each parameter gets a batch
    axis of 1, which every output loses again.  Traceable by
    ``torch.vmap``, which maps the 0-d parameters."""
    def drop(x):
        if isinstance(x, dict):
            return {k: drop(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(drop(v) for v in x)
        return x[0]

    def predict_one(params):
        return drop(predict({
            k: (v if torch.is_tensor(v) else
                torch.tensor(v, dtype=dtype, device=device)).reshape(1)
            for k, v in params.items()}))

    return predict_one


def make_predictor(obj, model, n_gauss=10, dtype=torch.float32,
                   separate_gal_type=False, vectorized=True, engine="auto",
                   extrapolate=False, accuracy="elementwise", mesh=None,
                   batch_axis="dp", *, device="cuda"):
    """Batched predictor for a tabulation or an interpolator.

    Parameters
    ----------
    obj : TabCorr or Interpolator
    model : HodModel
        Supplies the occupation functions; an Interpolator's grid keys are
        read from the parameter dict too.
    n_gauss : int, optional
        Gauss-Legendre nodes per halo bin. Default 10.
    dtype : torch.dtype, optional
        float32 (the kernels' type), float64 (plain engine; matches the
        float64 host path to rounding) or bfloat16 (tabcorr_tpu's bf16
        routes: bfloat16 tables; the plain engine's occupation in float32
        and float32 results, the fused engine's bfloat16 contraction
        kernel and bfloat16 results).
    separate_gal_type : bool, optional
        Per-galaxy-type dicts (plain engine).
    vectorized : bool, optional
        True (default): the callable maps dicts of (B,) tensors.  False:
        dicts of 0-d tensors (or floats) to (ngal 0-d, xi tpcf_shape), on
        the plain engine; ``torch.vmap`` maps it over a batch.
    engine : str, optional
        'fused', 'plain' or 'auto' (default; see the module docstring).
        'fused' takes float32 or bfloat16, ``vectorized``, no
        ``separate_gal_type``, a model whose ``supports_fused_engine`` is
        true, and an Interpolator only if its nodes share one halo
        binning.  It computes no gradient (``ops.fused.NO_GRADIENT``):
        autograd runs through the plain engine, in float64 for the
        samplers of :mod:`.mcmc`.
    extrapolate : bool, optional
        Interpolators only.  False (default) gives NaN for parameters
        outside the grid -- pair it with a log posterior that maps
        non-finite predictions to -inf; True clamps to the edge splines.
    accuracy : str, optional
        Fused-engine contract, 'elementwise' or 'scaled'.  A wide
        Interpolator's 'scaled' route runs the 3xTF32 tensor-core slab
        kernel (``ops.fused.grid_kernel_for``); the packed grid kernel
        contracts in float64 and a TabCorr's contraction kernel in full
        float32, under both contracts.
    mesh : DeviceMesh, optional
        The float32 fused Interpolator path only: split the batch over
        ``batch_axis`` of a mesh (:mod:`tabcorr_tpu_torch.parallel`); ``f``
        takes the global batch, the same on every rank, and returns this
        rank's rows, one kernel launch a call and no collective.  For a
        TabCorr use :func:`make_multi_predictor` (``mesh=``) or
        ``parallel.make_sharded_predict`` (dp x tp).
    batch_axis : str, optional
        The mesh dimension the batch is split over (default 'dp').
    device : str or torch.device, optional
        Where the tables live and the batch runs: 'cuda' (default) or
        'cpu'.

    Returns
    -------
    callable
        ``f(params dict of (B,) tensors) -> (ngal, xi)``; with
        ``vectorized=False``, of 0-d tensors.
    """
    device = resolve_device(device)
    if engine not in ENGINES:
        raise ValueError(f"Unknown engine: {engine!r}")
    if not isinstance(obj, (TabCorr, Interpolator)):
        raise TypeError(f"Cannot build a predictor for {type(obj)}.")
    fused_eligible = _fused_eligible(obj, model, dtype, separate_gal_type,
                                     vectorized)
    if engine == "auto":
        engine = _auto_engine(obj, model, dtype, separate_gal_type, device,
                              vectorized)
    if mesh is not None:
        if not isinstance(obj, Interpolator):
            raise ValueError(
                "mesh is supported on the fused Interpolator path; for a "
                "TabCorr use make_multi_predictor(..., mesh=...).")
        if engine != "fused" or dtype != torch.float32:
            raise ValueError("mesh requires the float32 fused Interpolator "
                             "path (engine='fused', dtype=torch.float32).")
    if engine == "fused":
        if not fused_eligible:
            raise ValueError(
                "engine='fused' requires float32 or bfloat16, "
                "vectorized=True, separate_gal_type=False, a model whose "
                "supports_fused_engine is true, and a TabCorr or an "
                "Interpolator whose nodes share one halo binning.")
        if isinstance(obj, Interpolator) and dtype == torch.bfloat16:
            return _interpolator_bf16_predict_fn(obj, model, n_gauss,
                                                 extrapolate, accuracy,
                                                 device)
        if isinstance(obj, Interpolator):
            return _interpolator_fused_predict_fn(obj, model, n_gauss,
                                                  extrapolate, accuracy,
                                                  device, mesh, batch_axis)
        table = obj.table_data(n_gauss=n_gauss, dtype=dtype, device=device)
        return fused.make_fused_predictor(table, model, accuracy)
    if isinstance(obj, Interpolator):
        predict = _interpolator_predict_fn(obj, model, n_gauss, dtype,
                                           separate_gal_type, extrapolate,
                                           device)
    else:
        predict = _tabcorr_predict_fn(obj, model, n_gauss, dtype,
                                      separate_gal_type, device)
    return predict if vectorized else _unbatched(predict, dtype, device)


MULTI_ENGINES = ("auto", "bundle", "plain")


def _float32_tabcorrs(objs, dtype):
    return dtype == torch.float32 and all(isinstance(obj, TabCorr)
                                          for obj in objs)


def multi_engine_for(objs, model, dtype, device):
    """The engine ``make_multi_predictor(engine='auto')`` picks: 'bundle'
    on a CUDA device for float32 TabCorr members, a model whose
    ``supports_fused_engine`` is true and tables one bundle launch takes
    (the counterpart of tabcorr_tpu's shared VMEM budget,
    ``tabcorr_tpu/predictor.py:559-563``); else 'members', one
    ``make_predictor(engine='auto')`` per member."""
    return ("bundle" if torch.device(device).type == "cuda" and
            _float32_tabcorrs(objs, dtype) and
            getattr(model, "supports_fused_engine", True) and
            fused.bundle_takes([(obj.n_bins, int(np.prod(obj.tpcf_shape)))
                                for obj in objs])
            else "members")


def make_multi_predictor(objs, model, n_gauss=10, dtype=torch.float32, *,
                         device="cuda", engine="bundle", accuracy=None,
                         mesh=None, batch_axis="dp"):
    """Joint predictor over several tabulations (e.g. wp + xi_0/2/4 + ds).

    Parameters
    ----------
    objs : sequence of TabCorr or Interpolator
    model : HodModel
        Under 'bundle' a model whose ``supports_fused_engine`` is true
        (``ops.fused.kernel_model``: zheng07 and its decoration in the
        kernel, any other model's densities ahead of it, from the
        occupation kernel or tensor ops); any model under 'plain' and
        'auto'.
    n_gauss : int, optional
        Gauss-Legendre nodes per halo bin. Default 10.
    dtype : torch.dtype, optional
        float32 (default; 'bundle' and 'plain' take only it) or float64
        ('auto': every member on the plain engine, differentiable).
    device : str or torch.device, optional
        Where the tables live and the batch runs: 'cuda' (default) or
        'cpu'.
    engine : str, optional
        'bundle' (default): float32 TabCorr members only; on a CUDA device
        one launch of the bundle kernel per call, on the CPU its plain
        version.  'plain': that plain version on any device (tests and
        timing).  'auto': 'bundle' where :func:`multi_engine_for` allows
        it, else one ``make_predictor(obj, model, n_gauss, dtype,
        engine='auto')`` per member (tabcorr_tpu's 'xla' engine): on the
        card the contraction kernel for a float32 TabCorr, the grid or
        slab kernel for a float32 Interpolator, the plain engine in
        float64; on the CPU the plain versions.
    accuracy : sequence of str, optional
        One contract per member, 'elementwise' (default) or 'scaled'
        (see :func:`make_predictor`).
    mesh : DeviceMesh, optional
        Split the batch over ``batch_axis`` of a mesh
        (:mod:`tabcorr_tpu_torch.parallel`) under every engine: ``f`` takes
        the global batch, the same on every rank, and returns this rank's
        rows, with no collective (the bundle: one launch a call on the
        rank's rows, tables whole on every rank).
    batch_axis : str, optional
        The mesh dimension the batch is split over (default 'dp').

    Returns
    -------
    callable
        ``f(params dict of (B,) tensors) -> [(ngal, xi), ...]`` in
        ``dtype``.
    """
    device = resolve_device(device)
    if engine not in MULTI_ENGINES:
        raise ValueError(f"Unknown engine: {engine!r}")
    accuracy = fused.check_accuracy(accuracy, len(objs))
    if engine == "auto":
        engine = multi_engine_for(objs, model, dtype, device)
    if engine == "members":
        fns = [make_predictor(obj, model, n_gauss, dtype, engine="auto",
                              accuracy=acc, device=device)
               for obj, acc in zip(objs, accuracy)]
        return fused.rank_rows(lambda params: [fn(params) for fn in fns],
                               mesh, batch_axis)
    if not _float32_tabcorrs(objs, dtype):
        raise ValueError(
            f"engine={engine!r} requires float32 and TabCorr members; "
            "engine='auto' takes Interpolators and float64.")
    tables = [obj.table_data(n_gauss=n_gauss, dtype=torch.float32,
                             device=device) for obj in objs]
    if engine == "bundle":
        return fused.make_fused_bundle_predictor(tables, model, accuracy,
                                                 mesh, batch_axis)
    consts = [fused.bundle_table_constants(t) for t in tables]
    occ_cen, occ_sat = occupation_functions(model)

    def predict_plain(params):
        return fused.shaped(consts, fused.bundle_predict_plain(
            consts, params, occ_cen, occ_sat))

    return fused.rank_rows(predict_plain, mesh, batch_axis)


def make_occupation_predictor(obj, dtype=torch.float32,
                              separate_gal_type=False, *, device="cuda"):
    """Batched predictor over raw per-bin mean-occupation vectors.

    The statistic is a quadratic (auto) or linear (cross) form in the
    occupation vector, so this skips the occupation model entirely
    (reference: tabcorr/tabcorr.py:616-621, predict with an ndarray).
    Returns ``f(occ (..., n_bins)) -> (ngal (...,), xi (..., *shape))``
    with bins ordered [centrals..., satellites...] like
    :meth:`TabCorr.mean_occupation`; ``separate_gal_type`` returns the
    per-type dicts instead.
    """
    table = (obj.table_data(n_gauss=1, dtype=dtype, device=device)
             if isinstance(obj, TabCorr) else obj)

    def f(occ):
        occ = torch.as_tensor(occ, dtype=dtype, device=table.n_h.device)
        shape = occ.shape[:-1] + tuple(table.tpcf_shape)
        if separate_gal_type:
            ngal_dict, xi_dict = predict_from_occupation_separate(table, occ)
            return ngal_dict, {k: v.reshape(shape)
                               for k, v in xi_dict.items()}
        ngal, xi = predict_from_occupation(table, occ)
        return ngal, xi.reshape(shape)

    return f


def params_batch(model, overrides=None, batch_shape=(), dtype=torch.float32,
                 *, device="cuda"):
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
