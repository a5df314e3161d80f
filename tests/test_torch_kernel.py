"""The CUDA kernels (bundle, contraction, grid, slab, slab_tc)
against their plain PyTorch versions, for zheng07, the assembly-bias
decorated model, and every other model through its densities (model code
2).

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py
"""

import dataclasses
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tabcorr_tpu_torch import (AssembiasLeauthaud11Model,
                               AssembiasZheng07Model,
                               AssembiasZuMandelbaum15Model, Interpolator,
                               Leauthaud11Model, TabCorr, Zheng07Model,
                               ZuMandelbaum15Model, make_multi_predictor,
                               make_predictor, occupation_functions,
                               params_batch)
from tabcorr_tpu_torch.io import ColumnTable
from tabcorr_tpu_torch.models.leauthaud11 import (_d_log_mh_d_log_mstar,
                                                  behroozi10_log_halo_mass,
                                                  fshmr_log_mstar)
from tabcorr_tpu_torch.models.zu_mandelbaum15 import (_behroozi_coeff_dict,
                                                      zu15_log_halo_mass,
                                                      zu15_log_mstar)
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.ops.predict import TableData, quadrature_grid
from tabcorr_tpu_torch.predictor import stacked_grid
from tabcorr_tpu_torch.utils import build
from tabcorr_tpu_torch.utils.synthetic import synthetic_tabcorr

pytestmark = pytest.mark.gpu

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


STRENGTHS = ("mean_occupation_centrals_assembias_param1",
             "mean_occupation_satellites_assembias_param1")


def _params(model, batch, seed, device, strength=None):
    """zheng07 parameters around threshold -18; for the decorated model
    strengths uniform in [-1, 1], or all equal to ``strength``."""
    rng = np.random.default_rng(seed)
    overrides = {
        "logMmin": 11.35 + 0.3 * rng.normal(size=batch),
        "sigma_logM": 0.25 + 0.05 * rng.uniform(size=batch),
        "logM0": 11.2 + 0.3 * rng.normal(size=batch),
        "logM1": 12.4 + 0.3 * rng.normal(size=batch),
        "alpha": 0.83 + 0.1 * rng.normal(size=batch)}
    if isinstance(model, AssembiasZheng07Model):
        for name in STRENGTHS:
            overrides[name] = (rng.uniform(-1.0, 1.0, batch)
                               if strength is None else
                               np.full(batch, strength))
    return params_batch(model, overrides, (batch,), device=device)


def _model(kind, **kw):
    if kind == "zheng07":
        return Zheng07Model(threshold=-20, **kw)
    return AssembiasZheng07Model(threshold=-20, **kw)


def _assert_close(got, want, what):
    """ngal: 1e-6 relative; xi: 2e-6 of each row's largest element (the
    two differ in summation order and transcendental rounding only)."""
    for (ng, xi), (ng_p, xi_p) in zip(got, want):
        ng, ng_p = ng.double().cpu(), ng_p.double().cpu()
        assert float(((ng - ng_p).abs() / ng_p.abs()).max()) <= 1e-6, what
        xi = xi.double().cpu().reshape(xi.shape[0], -1)
        xi_p = xi_p.double().cpu().reshape(xi.shape[0], -1)
        scaled = (xi - xi_p).abs().amax(1) / xi_p.abs().amax(1)
        assert float(scaled.max()) <= 2e-6, what


@pytest.mark.parametrize("batch", [13, 4096 + 37])
def test_kernel_matches_plain_on_bench_tables(cuda, batch):
    wp = TabCorr.read(DATA / "bolplanck_wp.npz")
    xi = TabCorr.read(DATA / "synthetic_xi_ell.npz")
    model = Zheng07Model(threshold=-18, redshift=wp.attrs["redshift"])
    kernel = make_multi_predictor([wp, xi], model, device=cuda)
    plain = make_multi_predictor([wp, xi], model, device=cuda,
                                 engine="plain")
    params = _params(model, batch, 1, cuda)
    before = fused.BUNDLE_LAUNCHES
    got = kernel(params)
    torch.cuda.synchronize()
    assert fused.BUNDLE_LAUNCHES == before + 1
    assert got[0][1].shape == (batch, 19) and got[1][1].shape == (batch, 3, 14)
    _assert_close(got, plain(params), "bench tables")


def _synthetic_table(mode, n_bins, n_centrals, n_xi, seed, device):
    """Odd shapes; secondary percentiles alternate 0.25 / 0.75."""
    rng = np.random.default_rng(seed)
    log_min = np.linspace(10.8, 14.6, n_bins) + 0.01 * rng.normal(size=n_bins)
    log_quad, weight = quadrature_grid(log_min, log_min + 0.2,
                                       rng.uniform(-1.9, -1.5, n_bins), 10)
    hi64 = log_quad.astype(np.float32).astype(np.float64)
    if mode == "auto":
        a = rng.normal(size=(n_xi, n_bins, n_bins))
        dense = 3.0 + 0.5 * (a + np.swapaxes(a, 1, 2))
    else:
        dense = 3.0 + rng.normal(size=(n_xi, n_bins))
    return TableData.from_numpy(
        dict(tpcf_dense=dense, n_h=10.0 ** rng.uniform(-6, -2, n_bins),
             log_prim_quad=log_quad, quad_weight=weight,
             sec_perc=np.where(np.arange(n_bins) % 2, 0.25, 0.75),
             log_prim_quad_lo=log_quad - hi64),
        mode=mode, tpcf_shape=(n_xi,), n_centrals=n_centrals,
        device=device, dtype=torch.float32)


@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
@pytest.mark.parametrize("modulate", [False, True])
def test_kernel_matches_plain_on_odd_shapes(cuda, modulate, kind):
    # Odd bin counts (padding of every tile dimension), both modes in one
    # launch, a ragged batch, and zheng07's central modulation.
    tables = [_synthetic_table("auto", 37, 17, 5, 2, cuda),
              _synthetic_table("cross", 45, 20, 3, 3, cuda),
              _synthetic_table("auto", 130, 64, 11, 4, cuda)]
    model = _model(kind, modulate_with_cenocc=modulate)
    consts = [fused.bundle_table_constants(t) for t in tables]
    occ = occupation_functions(model)
    predict = fused.make_fused_bundle_predictor(tables, model)
    params = _params(model, 77, 5, cuda)
    got = predict(params)
    want = fused.shaped(consts, fused.bundle_predict_plain(consts, params,
                                                           *occ))
    _assert_close(got, want, f"synthetic, {kind}, modulate={modulate}")


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    table = _synthetic_table("auto", 37, 17, 5, 2, cuda)
    consts = [fused.slab_tc_table_constants(table, 1)]
    pmat = torch.ones((8, 5), device=cuda)
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat.double())
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat.t().contiguous().t())
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat.cpu())
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat[:, :4].contiguous())
    # The decorated model reads 7 columns.
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat, fused.KernelModel(code=1))


# ----------------------------------------------------------------------
# The contraction kernel (B3)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode,n_bins,n_centrals,n_xi,batch", [
    ("auto", 37, 17, 5, 77), ("cross", 45, 20, 3, 13),
    ("auto", 130, 64, 11, 4096 + 37)])
def test_contraction_kernel_matches_plain(cuda, mode, n_bins, n_centrals,
                                          n_xi, batch):
    table = _synthetic_table(mode, n_bins, n_centrals, n_xi, 6, cuda)
    rng = np.random.default_rng(7)
    ngal = torch.tensor(10.0 ** rng.uniform(-6, -2, (batch, n_bins)),
                        dtype=torch.float32, device=cuda)
    contract = fused.make_fused_contraction(table)
    consts = fused.bundle_table_constants(table)
    before = fused.CONTRACTION_LAUNCHES
    got = contract(ngal)
    torch.cuda.synchronize()
    assert fused.CONTRACTION_LAUNCHES == before + 1
    _assert_close([got], [fused.contraction_plain(consts, ngal)],
                  f"contraction {mode} {n_bins}")


def test_fused_tabcorr_predictor_runs_the_contraction_kernel(cuda):
    wp = TabCorr.read(DATA / "bolplanck_wp.npz")
    model = Zheng07Model(threshold=-18, redshift=wp.attrs["redshift"])
    predict = make_predictor(wp, model, engine="fused", device=cuda)
    assert make_predictor(wp, model, device=cuda).__qualname__ == \
        predict.__qualname__   # 'auto' picks the kernel on CUDA
    params = _params(model, 1000, 8, cuda)
    before = fused.CONTRACTION_LAUNCHES
    got = predict(params)
    torch.cuda.synchronize()
    assert fused.CONTRACTION_LAUNCHES == before + 1
    plain = make_multi_predictor([wp], model, device=cuda, engine="plain")
    _assert_close([got], plain(params), "fused TabCorr predictor")


def test_contraction_wrapper_rejects_bad_inputs(cuda):
    table = _synthetic_table("auto", 37, 17, 5, 2, cuda)
    contract = fused.make_fused_contraction(table)
    ngal = torch.ones((8, 37), device=cuda)
    with pytest.raises(ValueError):
        contract(ngal.double())
    with pytest.raises(ValueError):
        contract(ngal[:, :36].contiguous())
    with pytest.raises(ValueError):
        contract(ngal.cpu())
    # The kernel reads the half layout of one node, not the plain version's
    # dense one.
    with pytest.raises(ValueError, match="half layout"):
        fused.contraction_launch(fused.bundle_table_constants(table), ngal)
    grid = _grid_table(2, 12, 2, 7, "auto", 13, cuda)
    with pytest.raises(ValueError, match="1 node"):
        fused.contraction_launch(fused.slab_tc_table_constants(grid, 2),
                                 torch.ones((8, grid.n_bins), device=cuda))


# ----------------------------------------------------------------------
# The grid kernel (B2)
# ----------------------------------------------------------------------
def _grid_table(n_nodes, n_prim, n_sec, n_xi, mode, seed, device):
    """A stacked grid of n_nodes synthetic tables sharing one binning."""
    tables = []
    for j in range(n_nodes):
        t = synthetic_tabcorr(np.random.default_rng(seed), n_prim, n_sec,
                              n_xi, mode)
        t.tpcf_matrix = t.tpcf_matrix * (1.0 + 0.1 * np.random.default_rng(
            1000 * seed + j).normal(size=t.tpcf_matrix.shape))
        tables.append(t.table_data(device=device))
    return dataclasses.replace(
        tables[0], tpcf_dense=torch.cat([t.tpcf_dense for t in tables]),
        tpcf_shape=(n_nodes * n_xi,))


def _assert_grid_close(got, want, nan_rows=(), scale=None):
    """NaN exactly in ``nan_rows``; elsewhere ngal 1e-6 relative and xi
    within 2e-6 of ``scale`` per row (default: the row's largest |xi|).
    Folded with weights of both signs, the sum can cancel far below its
    terms, so the fold's scale is sum_node |w| max_k |xi_node|."""
    (ng, xi), (ng_p, xi_p) = got, want
    nan = torch.zeros(xi.shape[0], dtype=torch.bool)
    nan[list(nan_rows)] = True
    xi = xi.double().cpu().reshape(xi.shape[0], -1)
    xi_p = xi_p.double().cpu().reshape(xi.shape[0], -1)
    assert bool(torch.isnan(xi[nan]).all())
    assert bool(torch.isfinite(xi[~nan]).all())
    ng, ng_p = ng.double().cpu(), ng_p.double().cpu()
    assert float(((ng - ng_p).abs() / ng_p.abs()).max()) <= 1e-6
    if scale is None:
        scale = xi_p.abs().amax(1)
    err = (xi - xi_p).abs().amax(1) / scale.double().cpu()
    assert float(err[~nan].max()) <= 2e-6


@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
@pytest.mark.parametrize("mode", ["auto", "cross"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("batch", [8, 131])
def test_grid_kernel_matches_plain(cuda, mode, fold, batch, kind):
    n_nodes = 6
    table = _grid_table(n_nodes, 12, 2, 7, mode, 13, cuda)
    model = _model(kind)
    predict = fused.make_fused_grid_predictor(table, n_nodes, model,
                                              fold_spline=fold)
    g = fused.grid_table_constants(table, n_nodes)
    params = _params(model, batch, 9, cuda)
    nw = None
    if fold:
        rng = np.random.default_rng(3)
        nw = torch.tensor(rng.normal(size=(batch, n_nodes)),
                          dtype=torch.float32, device=cuda)
        nw[3] = torch.nan
    before = fused.GRID_LAUNCHES
    got = predict(params, nw) if fold else predict(params)
    torch.cuda.synchronize()
    assert fused.GRID_LAUNCHES == before + 1
    assert got[1].shape == ((batch, 7) if fold else (batch, n_nodes, 7))
    occ = occupation_functions(model)
    want = fused.grid_predict_plain(g, params, nw, *occ)
    scale = None
    if fold:
        nodes = fused.grid_predict_plain(g, params, None, *occ)[1]
        scale = (nw.abs()[:, :, None] * nodes.abs()).sum(1).amax(1)
    _assert_grid_close(got, want, nan_rows=(3,) if fold else (), scale=scale)


def test_grid_kernel_takes_1104_cross_bins(cuda):
    # The 'efficient' Delta Sigma grid: the densities of 64 rows would not
    # fit in shared memory, so the kernel takes 32-row blocks.
    interp = Interpolator.read(DATA / "ds_efficient.npz")
    assert fused.grid_block_rows(1104, 13) == 32
    model = Zheng07Model(threshold=-21, redshift=0.5,
                         prim_haloprop_key="halo_m258m")
    model.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
    tables = [interp.tabcorr_list[i].table_data(device=cuda)
              for i in interp.param_dict_table["tabcorr_index"]]
    table = dataclasses.replace(
        tables[0], tpcf_dense=torch.cat([t.tpcf_dense for t in tables]),
        tpcf_shape=(4 * 13,))
    predict = fused.make_fused_grid_predictor(table, 4, model,
                                              fold_spline=True)
    g = fused.grid_table_constants(table, 4)
    params = _params(model, 301, 10, cuda)
    nw = torch.tensor(np.random.default_rng(4).dirichlet(np.ones(4), 301),
                      dtype=torch.float32, device=cuda)
    got = predict(params, nw)
    want = fused.grid_predict_plain(g, params, nw,
                                    *occupation_functions(model))
    _assert_grid_close(got, want)


@pytest.mark.parametrize("fold", [False, True])
def test_grid_kernel_takes_16_row_blocks(cuda, fold):
    """A 1400-bin cross grid: only 16 rows' densities fit in a block."""
    n_nodes = 3
    table = _grid_table(n_nodes, 350, 2, 5, "cross", 17, cuda)
    assert fused.grid_block_rows(1400, 5) == 16
    model = _model("assembias")
    predict = fused.make_fused_grid_predictor(table, n_nodes, model,
                                              fold_spline=fold)
    g = fused.grid_table_constants(table, n_nodes)
    params = _params(model, 131, 9, cuda)
    nw = torch.tensor(np.random.default_rng(4).dirichlet(np.ones(n_nodes),
                                                         131),
                      dtype=torch.float32, device=cuda) if fold else None
    before = fused.GRID_LAUNCHES
    got = predict(params, nw) if fold else predict(params)
    torch.cuda.synchronize()
    assert fused.GRID_LAUNCHES == before + 1
    _assert_grid_close(got, fused.grid_predict_plain(
        g, params, nw, *occupation_functions(model)))


def _ds_efficient_grid(kind, device):
    """The 'efficient' Delta Sigma grid stacked for the grid kernels (cross,
    1104 bins, 4 nodes of 13 rows) and its model."""
    interp = Interpolator.read(DATA / "ds_efficient.npz")
    model = {"zheng07": Zheng07Model, "assembias": AssembiasZheng07Model}[
        kind](threshold=-21, redshift=0.5, prim_haloprop_key="halo_m258m")
    model.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
    tables = [interp.tabcorr_list[i].table_data(device=device)
              for i in interp.param_dict_table["tabcorr_index"]]
    return dataclasses.replace(
        tables[0], tpcf_dense=torch.cat([t.tpcf_dense for t in tables]),
        tpcf_shape=(4 * 13,)), model


def _spread_bins(table, n):
    """A cross table cut to n of its bins, spread evenly over them, the
    central bins still first."""
    keep = np.unique(np.round(np.linspace(0, table.n_bins - 1, n)).astype(
        np.int64))
    assert len(keep) == n
    n_centrals = int(np.sum(keep < table.n_centrals))
    keep = torch.tensor(keep, device=table.n_h.device)
    lo = table.log_prim_quad_lo
    return dataclasses.replace(
        table, tpcf_dense=table.tpcf_dense[:, keep], n_h=table.n_h[keep],
        log_prim_quad=table.log_prim_quad[keep],
        quad_weight=table.quad_weight[keep], sec_perc=table.sec_perc[keep],
        log_prim_quad_lo=None if lo is None else lo[keep],
        n_centrals=n_centrals)


@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
@pytest.mark.parametrize("shape", ["auto 60 bins", "cross 1104 bins",
                                   "cross 1400 bins"])
def test_grid_kernels_share_the_occupation_bit_for_bit(cuda, shape, kind):
    """The occupation's tolerance: ngal of the grid kernel and of the FP32
    slab kernel on the same inputs is bit-identical (both run zheng07.cuh's
    occupation_phase, its loops unrolled by kOccUnroll, and sum each row's
    densities in double in bin order), and the grid kernel's is within
    2^-22 relative of the plain version's (tensor ops round the
    transcendental functions elsewhere).  The slab kernel's block takes
    neither cross table, so there the two kernels meet on 640 of the
    table's bins, the grid kernel in 32-row blocks, as at 1104 bins."""
    if shape.startswith("auto"):
        n_nodes, table, model = 2, _grid_table(2, 15, 2, 7, "auto", 13,
                                               cuda), _model(kind)
    elif shape == "cross 1104 bins":
        (table, model), n_nodes = _ds_efficient_grid(kind, cuda), 4
    else:
        n_nodes, table, model = 3, _grid_table(3, 350, 2, 5, "cross", 17,
                                               cuda), _model(kind)
    g = fused.grid_table_constants(table, n_nodes)
    hod = fused.KernelModel.of(model)
    params = _params(model, 4096 + 37, 12, cuda)
    pmat = fused._param_matrix(params, hod)
    ngal = fused.grid_launch(g, pmat, None, hod)[0]
    want = fused.grid_predict_plain(g, params, None,
                                    *occupation_functions(model))[0]
    rel = ((ngal.double() - want.double()).abs() / want.double().abs()).max()
    assert float(rel) <= 2.0 ** -22, float(rel)
    shared = (table if fused.contraction_fits(g.n_bins, g.n_xi) else
              _spread_bins(table, 640))
    assert (shared is table) == shape.startswith("auto")
    assert fused.contraction_fits(shared.n_bins, g.n_xi)
    if shared is not table:
        g = fused.grid_table_constants(shared, n_nodes)
        assert fused.grid_block_rows(g.n_bins, g.n_xi) == 32
        ngal = fused.grid_launch(g, pmat, None, hod)[0]
    ngal_slab = fused.slab_launch(
        fused.slab_tc_table_constants(shared, n_nodes), pmat, hod)[0]
    torch.cuda.synchronize()
    assert torch.equal(ngal, ngal_slab)


def test_fused_interpolator_nan_outside_the_grid(cuda):
    interp = Interpolator.read(DATA / "ds_efficient.npz")
    model = Zheng07Model(threshold=-21, redshift=0.5,
                         prim_haloprop_key="halo_m258m")
    model.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
    predict = make_predictor(interp, model, engine="fused", device=cuda)
    params = params_batch(model, {"log_eta": np.array(
        [0.1, 0.9, -0.2, -0.5], np.float32)}, (4,), device=cuda)
    before = fused.GRID_LAUNCHES
    ngal, xi = predict(params)
    assert fused.GRID_LAUNCHES == before + 1
    ngal, xi = ngal.cpu(), xi.cpu().reshape(4, -1)
    out = torch.tensor([False, True, False, True])
    assert bool(torch.isnan(ngal[out]).all() and torch.isnan(xi[out]).all())
    assert bool(torch.isfinite(ngal[~out]).all() and
                torch.isfinite(xi[~out]).all())


def test_grid_wrapper_rejects_bad_inputs(cuda):
    table = _grid_table(3, 8, 1, 3, "auto", 1, cuda)
    g = fused.grid_table_constants(table, 3)
    pmat = torch.ones((8, 5), device=cuda)
    with pytest.raises(ValueError):
        fused.grid_launch(g, pmat.double())
    with pytest.raises(ValueError):
        fused.grid_launch(g, pmat.cpu())
    with pytest.raises(ValueError):
        fused.grid_launch(g, pmat, torch.ones((8, 2), device=cuda))
    # Shapes the C entry point refuses come back as a launch error, and a
    # table whose 16-row block does not fit in shared memory raises.
    before = fused.GRID_LAUNCHES
    with pytest.raises(RuntimeError, match="grid kernel launch failed"):
        fused.grid_launch(dataclasses.replace(g, npair=g.npair + 1), pmat)
    wide = fused.grid_table_constants(_grid_table(1, 750, 2, 1, "cross", 1,
                                                  cuda), 1)
    assert wide.n_bins == 3000 and fused.grid_block_rows(3000, 1) is None
    with pytest.raises(ValueError, match="shared memory"):
        fused.grid_launch(wide, pmat)
    assert fused.GRID_LAUNCHES == before


# ----------------------------------------------------------------------
# The slab kernel (B4), and the decoration in every kernel
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
@pytest.mark.parametrize("mode,n_prim,n_xi,batch", [
    ("auto", 12, 7, 131), ("cross", 11, 5, 8), ("auto", 40, 6, 4096 + 37)])
def test_slab_kernel_matches_plain(cuda, mode, n_prim, n_xi, batch, kind):
    n_nodes = 5
    table = _grid_table(n_nodes, n_prim, 2, n_xi, mode, 13, cuda)
    model = _model(kind)
    predict = fused.make_fused_grid_predictor(table, n_nodes, model,
                                              layout="slab")
    s = fused.slab_table_constants(table, n_nodes)
    params = _params(model, batch, 9, cuda)
    before = fused.SLAB_LAUNCHES
    got = predict(params)
    torch.cuda.synchronize()
    assert fused.SLAB_LAUNCHES == before + 1
    assert got[1].shape == (batch, n_nodes, n_xi)
    want = fused.slab_predict_plain(s, params, *occupation_functions(model))
    _assert_grid_close(got, want)


def test_auto_layout_runs_the_slab_kernel_on_160_bins(cuda):
    table = _grid_table(3, 40, 2, 6, "auto", 5, cuda)
    assert table.n_bins == 160 and fused.grid_layout_for(table) == "slab"
    model = _model("assembias")
    before = (fused.GRID_LAUNCHES, fused.SLAB_LAUNCHES)
    got = fused.make_fused_grid_predictor(table, 3, model)(
        _params(model, 77, 4, cuda))
    torch.cuda.synchronize()
    assert (fused.GRID_LAUNCHES, fused.SLAB_LAUNCHES) == (before[0],
                                                          before[1] + 1)
    assert got[1].shape == (77, 3, 6)


@pytest.mark.parametrize("kernel", ["bundle", "grid", "slab"])
def test_assembias_strength_moves_the_kernel_output(cuda, kernel):
    model = _model("assembias")
    if kernel == "bundle":
        xi = TabCorr.read(DATA / "synthetic_xi_ell.npz")
        predict = make_multi_predictor([xi], model, device=cuda)

        def run(params):
            return predict(params)[0][1]
    else:
        table = _grid_table(4, 12, 2, 7, "auto", 13, cuda)
        predict = fused.make_fused_grid_predictor(table, 4, model,
                                                  layout=kernel.replace(
                                                      "grid", "packed"))

        def run(params):
            return predict(params)[1]
    xi_0 = run(_params(model, 64, 2, cuda, strength=0.0)).double()
    xi_8 = run(_params(model, 64, 2, cuda, strength=0.8)).double()
    xi_0, xi_8 = xi_0.reshape(64, -1), xi_8.reshape(64, -1)
    scaled = (xi_8 - xi_0).abs().amax(1) / xi_0.abs().amax(1)
    assert float(scaled.min()) > 1e-4


def test_wide_interpolator_runs_the_slab_kernel(cuda):
    # 128 bins: too many for the packed layout; 'auto' on CUDA picks the
    # fused engine, which runs the slab kernel and the spline.
    tabs = []
    for j in range(4):
        t = synthetic_tabcorr(np.random.default_rng(5), 32, 2, 3, "auto")
        t.tpcf_matrix = t.tpcf_matrix * (1.0 + 0.1 * np.random.default_rng(
            50 + j).normal(size=t.tpcf_matrix.shape))
        tabs.append(t)
    interp = Interpolator(tabs, ColumnTable(
        {"log_eta": [-0.4, -0.1, 0.2, 0.4]}))
    model = _model("assembias", redshift=0.0)
    model.param_dict["log_eta"] = 0.0
    predict = make_predictor(interp, model, device=cuda)
    plain = make_predictor(interp, model, engine="plain", device=cuda)
    params = _params(model, 300, 6, cuda)
    eta = np.random.default_rng(7).uniform(-0.35, 0.35, 300)
    eta[[3, 200]] = [0.5, -0.6]
    params["log_eta"] = torch.tensor(eta, dtype=torch.float32, device=cuda)
    before = fused.SLAB_LAUNCHES
    got = predict(params)
    torch.cuda.synchronize()
    assert fused.SLAB_LAUNCHES == before + 1
    want = plain(params)
    out = torch.zeros(300, dtype=torch.bool)
    out[[3, 200]] = True
    for ngal, xi in (got, want):
        ngal, xi = ngal.cpu(), xi.cpu().reshape(300, -1)
        assert bool(torch.isnan(ngal[out]).all() and
                    torch.isnan(xi[out]).all())
        assert bool(torch.isfinite(ngal[~out]).all() and
                    torch.isfinite(xi[~out]).all())
    inside = torch.nonzero(~out).flatten().to(cuda)
    _assert_grid_close([a[inside] for a in got], [a[inside] for a in want])


def test_slab_wrapper_rejects_bad_inputs(cuda):
    table = _grid_table(3, 8, 1, 3, "auto", 1, cuda)
    s = fused.slab_tc_table_constants(table, 3)
    pmat = torch.ones((8, 5), device=cuda)
    with pytest.raises(ValueError, match="half layout"):
        fused.slab_launch(fused.slab_table_constants(table, 3), pmat)
    with pytest.raises(RuntimeError, match="slab kernel launch failed"):
        fused.slab_launch(dataclasses.replace(s, n_nodes=0), pmat)
    with pytest.raises(ValueError):
        fused.slab_launch(s, pmat.double())
    with pytest.raises(ValueError):
        fused.slab_launch(s, pmat.cpu())
    with pytest.raises(ValueError):
        fused.slab_launch(s, pmat, fused.KernelModel(code=1))
    with pytest.raises(ValueError, match="takes no fused engine"):
        fused.make_fused_grid_predictor(table, 3, HodModelStandIn(),
                                        layout="slab")


class HodModelStandIn(Zheng07Model):
    """A zheng07 subclass that takes no fused engine: no kernel runs it,
    not even from its densities."""

    supports_fused_engine = False


# ----------------------------------------------------------------------
# slab_tc (3xTF32 on the tensor cores), B4's 'scaled' tier
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
@pytest.mark.parametrize("mode,n_prim,n_xi,batch", [
    ("auto", 12, 7, 131), ("cross", 11, 5, 8), ("auto", 40, 6, 4096 + 37)])
def test_slab_tc_kernel_matches_plain(cuda, mode, n_prim, n_xi, batch, kind):
    n_nodes = 5
    table = _grid_table(n_nodes, n_prim, 2, n_xi, mode, 13, cuda)
    model = _model(kind)
    predict = fused.make_fused_grid_predictor(table, n_nodes, model,
                                              accuracy="scaled",
                                              layout="slab")
    s = fused.slab_table_constants(table, n_nodes)
    params = _params(model, batch, 9, cuda)
    before = (fused.SLAB_LAUNCHES, fused.SLAB_TC_LAUNCHES)
    got = predict(params)
    torch.cuda.synchronize()
    assert (fused.SLAB_LAUNCHES, fused.SLAB_TC_LAUNCHES) == (before[0],
                                                             before[1] + 1)
    assert got[1].shape == (batch, n_nodes, n_xi)
    want = fused.slab_predict_plain(s, params, *occupation_functions(model))
    _assert_grid_close(got, want)


@pytest.mark.parametrize("mode,n_prim,n_xi,width,block", [
    ("auto", 100, 6, 8, 1), ("cross", 100, 5, 8, 1), ("auto", 12, 7, 16, 2),
    ("auto", 55, 6, 16, 2)])
def test_slab_tc_blocks_and_widths(cuda, mode, n_prim, n_xi, width, block):
    """slab_tc's 64-row blocks of one consumer warpgroup (400 bins: 128
    rows' densities leave no room for 3 ring slots), its 128-row blocks,
    and the block-triangular layout at 16-bin tiles."""
    n_nodes = 3
    table = _grid_table(n_nodes, n_prim, 2, n_xi, mode, 13, cuda)
    wgs, _ = fused.slab_tc_config(table.n_bins, n_xi)
    assert wgs == block
    model = _model("assembias")
    hod = fused.KernelModel.of(model)
    s = fused.slab_split_table_constants(table, n_nodes, width=width)
    params = _params(model, 131, 9, cuda)
    before = fused.SLAB_TC_LAUNCHES
    got = fused.slab_tc_launch(s, fused._param_matrix(params, hod), hod)
    torch.cuda.synchronize()
    assert fused.SLAB_TC_LAUNCHES == before + 1
    want = fused.slab_predict_plain(fused.slab_table_constants(
        table, n_nodes), params, *occupation_functions(model))
    _assert_grid_close(got, want)


def test_tc_wrappers_reject_bad_inputs_and_raise_on_launch_errors(cuda):
    table = _grid_table(3, 8, 1, 3, "auto", 1, cuda)
    s = fused.slab_split_table_constants(table, 3)
    pmat = torch.ones((8, 5), device=cuda)
    with pytest.raises(ValueError, match="split"):
        fused.slab_tc_launch(fused.slab_tc_table_constants(table, 3), pmat)
    with pytest.raises(ValueError):
        fused.slab_tc_launch(s, pmat.double())
    with pytest.raises(ValueError):
        fused.slab_tc_launch(s, pmat.cpu())
    with pytest.raises(ValueError):
        fused.slab_tc_launch(s, pmat, hod=fused.KernelModel(code=1))
    # Shapes the C entry point refuses come back as a launch error.
    before = fused.SLAB_TC_LAUNCHES
    with pytest.raises(RuntimeError, match="slab_tc kernel launch failed"):
        fused.slab_tc_launch(dataclasses.replace(s, n_nodes=0), pmat)
    assert fused.SLAB_TC_LAUNCHES == before


def _cancelling_table(mode, n_bins, n_xi, seed, device):
    """One node whose statistic k has entries uniform in [-1, 1] plus a
    mean running from 0.02 to 2 over k: elements from heavy cancellation
    to none.  Returns the table and its float64 matrices."""
    t = _synthetic_table(mode, n_bins, n_bins // 2, n_xi, seed, device)
    rng = np.random.default_rng(seed + 100)
    mean = np.linspace(0.02, 2.0, n_xi)
    if mode == "auto":
        a = rng.uniform(-1, 1, (n_xi, n_bins, n_bins))
        dense = 0.5 * (a + np.swapaxes(a, 1, 2)) + mean[:, None, None]
    else:
        dense = rng.uniform(-1, 1, (n_xi, n_bins)) + mean[:, None]
    return dataclasses.replace(t, tpcf_dense=torch.tensor(
        dense, dtype=torch.float32, device=device)), dense


@pytest.mark.parametrize("mode,layout", [("cross", "packed"),
                                         ("auto", "packed"),
                                         ("auto", "slab")])
def test_both_tiers_per_element_error_by_cancellation(cuda, mode, layout):
    """Per-element relative error of each tier's kernel against the plain
    version, by each element's cancellation kappa = sum |terms| / |sum|
    (float64, from the plain densities): for the packed layout the FP64
    grid kernel (both contracts), for the slab layout the FP32 slab kernel
    ('elementwise') and slab_tc ('scaled').  Every kernel meets 1e-6 per
    element wherever kappa < 5.  Two more references separate
    what the error is made of: the float64 contraction of the same
    float32 densities over the float64 table, and over the float32
    table the kernels read (their own operands, so what is left against
    it is summation and the densities' differences).  Run with -s for
    the tables of maxima."""
    batch = 4096
    table, dense = _cancelling_table(mode, 60, 40, 7, cuda)
    model = _model("zheng07")
    params = _params(model, batch, 11, cuda)
    occ = occupation_functions(model)
    plain = (fused.slab_table_constants(table, 1) if layout == "slab"
             else fused.grid_table_constants(table, 1))
    n = fused._plain_ngal(plain, {k: v[:, None, None]
                                  for k, v in params.items()},
                          *occ).double().cpu().numpy()
    dense32 = table.tpcf_dense.double().cpu().numpy()

    def contract(f):
        if mode == "auto":
            return np.einsum("bi,kij,bj->bk", n, f, n)
        return n @ f.T

    total, terms, total32 = contract(dense), contract(np.abs(dense)), \
        contract(dense32)
    kappa = terms / np.abs(total)
    want = (fused.slab_predict_plain(plain, params, *occ) if layout == "slab"
            else fused.grid_predict_plain(plain, params, None, *occ))[1]
    want = want.double().cpu().numpy().reshape(batch, -1)
    tot = n.sum(axis=1, keepdims=True)
    den = tot * tot if mode == "auto" else tot
    refs = {"the plain version": want,
            "float64 of the float32 densities": total / den,
            "float64 over the kernels' operands": total32 / den}
    edges = (1, 2, 5, 10, 30)
    bins = [(kappa >= lo) & (kappa < hi)
            for lo, hi in zip(edges[:-1], edges[1:])]
    if layout == "slab":
        kernels = {name: fused.make_fused_grid_predictor(
            table, 1, model, accuracy=accuracy, layout=layout)
            for name, accuracy in (("slab", "elementwise"),
                                   ("slab_tc", "scaled"))}
    else:
        hod = fused.KernelModel.of(model)
        pmat = fused._param_matrix(params, hod)
        kernels = {"grid (FP64)": lambda _: fused.grid_launch(plain, pmat,
                                                              hod=hod)}
    maxima = {what: {} for what in refs}
    for name, predict in kernels.items():
        got = predict(params)[1].double().cpu().numpy().reshape(batch, -1)
        for what, ref in refs.items():
            rel = np.abs(got - ref) / np.abs(ref)
            maxima[what][name] = [float(rel[b].max()) if b.any() else np.nan
                                  for b in bins]
    for what, table_of in maxima.items():
        print(f"\n{mode} {layout}, max per-element relative error against "
              f"{what} for kappa in {list(zip(edges[:-1], edges[1:]))}: " +
              "; ".join(f"{a} {', '.join(f'{e:.3e}' for e in m)}"
                        for a, m in table_of.items()))
    for name, m in maxima["the plain version"].items():
        assert max(m[:2]) <= 1e-6, (name, m)


@pytest.mark.parametrize("accuracy", ["scaled", "elementwise"])
@pytest.mark.parametrize("wide", [False, True])
def test_fused_interpolator_launches_the_tiers_kernels(cuda, accuracy,
                                                       wide):
    """make_predictor(engine='fused') on an Interpolator: the packed
    layout runs only the grid kernel under both contracts; the slab layout
    only slab_tc under 'scaled', only the FP32 slab under 'elementwise'."""
    tabs = []
    for j in range(4):
        t = synthetic_tabcorr(np.random.default_rng(5), 32 if wide else 10,
                              2 if wide else 1, 3, "auto")
        t.tpcf_matrix = t.tpcf_matrix * (1.0 + 0.1 * np.random.default_rng(
            50 + j).normal(size=t.tpcf_matrix.shape))
        tabs.append(t)
    interp = Interpolator(tabs, ColumnTable(
        {"log_eta": [-0.4, -0.1, 0.2, 0.4]}))
    model = _model("assembias", redshift=0.0)
    model.param_dict["log_eta"] = 0.0
    predict = make_predictor(interp, model, engine="fused",
                             accuracy=accuracy, device=cuda)
    plain = make_predictor(interp, model, engine="plain", device=cuda)
    params = _params(model, 200, 6, cuda)
    params["log_eta"] = torch.tensor(
        np.random.default_rng(7).uniform(-0.35, 0.35, 200),
        dtype=torch.float32, device=cuda)
    names = ("GRID_LAUNCHES", "SLAB_LAUNCHES", "SLAB_TC_LAUNCHES")
    before = [getattr(fused, n) for n in names]
    got = predict(params)
    torch.cuda.synchronize()
    grew = [getattr(fused, n) - b for n, b in zip(names, before)]
    assert grew == ([1, 0, 0] if not wide else
                    [0, 0, 1] if accuracy == "scaled" else [0, 1, 0])
    _assert_grid_close(got, plain(params))


# ----------------------------------------------------------------------
# The FP32 contraction's blocks, and the bundle under both contracts
# ----------------------------------------------------------------------
def _odd_tables(device):
    """Odd bin counts (padding of every tile dimension), both modes."""
    return [_synthetic_table("auto", 37, 17, 5, 2, device),
            _synthetic_table("cross", 45, 20, 3, 3, device),
            _synthetic_table("auto", 130, 64, 11, 4, device)]


def _bundle_plain(tables, model, params):
    consts = [fused.bundle_table_constants(t) for t in tables]
    return fused.shaped(consts, fused.bundle_predict_plain(
        consts, params, *occupation_functions(model)))


@pytest.mark.parametrize("stage_steps", [4, 2])
@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
def test_fp32_kernels_at_every_ring_stage(cuda, monkeypatch, kind,
                                          stage_steps):
    """bundle, contraction and slab with ring stages of 32 and 16 K rows
    (the smaller one is taken where shared memory is short), ragged
    batches, auto and cross."""
    monkeypatch.setattr(fused, "_FP32_STAGE_STEPS", (stage_steps,))
    model = _model(kind)
    tables = _odd_tables(cuda)
    params = _params(model, 77, 5, cuda)
    before = fused.BUNDLE_LAUNCHES
    got = fused.make_fused_bundle_predictor(tables, model)(params)
    torch.cuda.synchronize()
    assert fused.BUNDLE_LAUNCHES == before + 1
    _assert_close(got, _bundle_plain(tables, model, params),
                  f"bundle, {stage_steps} steps")
    rng = np.random.default_rng(7)
    for table in tables[1:]:
        ngal = torch.tensor(10.0 ** rng.uniform(-6, -2, (131, table.n_bins)),
                            dtype=torch.float32, device=cuda)
        got = fused.make_fused_contraction(table)(ngal)
        want = fused.contraction_plain(fused.bundle_table_constants(table),
                                       ngal)
        _assert_close([got], [want], f"contraction, {stage_steps} steps")
    for mode, n_prim, n_xi, batch in (("auto", 12, 7, 131),
                                      ("cross", 11, 5, 8)):
        grid = _grid_table(5, n_prim, 2, n_xi, mode, 13, cuda)
        p = _params(model, batch, 9, cuda)
        before = fused.SLAB_LAUNCHES
        got = fused.make_fused_grid_predictor(grid, 5, model,
                                              layout="slab")(p)
        torch.cuda.synchronize()
        assert fused.SLAB_LAUNCHES == before + 1
        _assert_grid_close(got, fused.slab_predict_plain(
            fused.slab_table_constants(grid, 5), p,
            *occupation_functions(model)))


@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
@pytest.mark.parametrize("accuracy,batch", [
    (("scaled", "scaled", "scaled"), 77),
    (("elementwise", "scaled", "elementwise"), 4096 + 37),
    (None, 13)])
def test_bundle_kernel_runs_every_contract(cuda, accuracy, batch, kind):
    """The bundle kernel under every mix of contracts, auto and cross in
    one launch, held to the plain version: the tables on the FP32 route
    (every 'elementwise' table, and cross tables under 'scaled') keep the
    bits of the all-'elementwise' launch; the 'scaled' auto tables run on
    the tensor cores, within the 'scaled' contract."""
    model = _model(kind, modulate_with_cenocc=kind == "zheng07")
    tables = _odd_tables(cuda)
    params = _params(model, batch, 5, cuda)
    routes = fused.bundle_routes(tables, accuracy)
    before = (fused.BUNDLE_LAUNCHES, fused.BUNDLE_TC_TABLES)
    got = fused.make_fused_bundle_predictor(tables, model, accuracy)(params)
    torch.cuda.synchronize()
    assert (fused.BUNDLE_LAUNCHES, fused.BUNDLE_TC_TABLES) == (
        before[0] + 1, before[1] + routes.count("tc"))
    want = _bundle_plain(tables, model, params)
    _assert_close(got, want, f"bundle {accuracy}")
    for route, (_, xi), (_, xi_p) in zip(routes, got, want):
        if route == "tc":
            assert _scaled_error(xi, xi_p) <= 1e-6
    default = fused.make_fused_bundle_predictor(tables, model)(params)
    for route, (ng, xi), (ng0, xi0) in zip(routes, got, default):
        if route == "fp32":
            assert torch.equal(ng, ng0) and torch.equal(xi, xi0)
        else:
            torch.testing.assert_close(ng, ng0, rtol=1e-7, atol=0)


def test_bundle_runs_the_headline_contract(cuda):
    wp = TabCorr.read(DATA / "bolplanck_wp.npz")
    xi = TabCorr.read(DATA / "synthetic_xi_ell.npz")
    model = AssembiasZheng07Model(threshold=-18,
                                  redshift=wp.attrs["redshift"])
    kernel = make_multi_predictor([wp, xi], model, device=cuda,
                                  accuracy=("elementwise", "scaled"))
    plain = make_multi_predictor([wp, xi], model, device=cuda,
                                 engine="plain")
    params = _params(model, 4096 + 37, 1, cuda)
    before = fused.BUNDLE_LAUNCHES
    got = kernel(params)
    torch.cuda.synchronize()
    assert fused.BUNDLE_LAUNCHES == before + 1
    want = plain(params)
    _assert_close(got, want, "bench tables, headline contract")
    # wp per element.
    rel = ((got[0][1] - want[0][1]).abs() / want[0][1].abs()).max()
    assert float(rel) <= 2e-6


# ----------------------------------------------------------------------
# The bundle's tensor-core route: 'scaled' auto tables in 3xTF32 on wgmma
# ----------------------------------------------------------------------
CONFIG = (Path(__file__).absolute().parents[1] / "benchmark" / "configs" /
          "zheng07_wp_xiell.json")


def _box_params(model, batch, seed, device):
    """zheng07 parameters uniform over the flat priors of the
    zheng07_wp_xiell benchmark configuration."""
    import json
    bounds = json.loads(CONFIG.read_text())["bounds"]
    rng = np.random.default_rng(seed)
    return params_batch(model, {k: rng.uniform(*b, batch)
                                for k, b in bounds.items()}, (batch,),
                        device=device)


def _scaled_error(xi, want):
    """The largest error of xi (B, ...) against ``want``, scaled by each
    row's largest element of ``want``."""
    xi = xi.double().cpu().reshape(xi.shape[0], -1)
    want = want.double().cpu().reshape(xi.shape[0], -1)
    return float(((xi - want).abs().amax(1) / want.abs().amax(1)).max())


def _host_scaled_error(tab, model, params, xi, rows):
    """xi's largest error over ``rows`` against the float64 host path at
    the float32 parameters the kernel read, scaled by the row's largest
    element."""
    worst = 0.0
    for i in rows:
        for k in model.param_dict:
            model.param_dict[k] = float(params[k][i])
        want = np.ravel(tab.predict(model, check_consistency=False)[1])
        got = xi[i].double().cpu().numpy().ravel()
        worst = max(worst, float(np.max(np.abs(got - want)) /
                                 np.max(np.abs(want))))
    return worst


@pytest.mark.parametrize("batch", [13, 4096 + 37])
def test_bundle_tc_route_on_the_bench_tables(cuda, batch):
    """wp 'elementwise' + xi_ell 'scaled', one launch with one table on the
    tensor cores, over the configuration's box: against the plain version
    (ngal 1e-6, wp 2e-6 per element, xi_ell 1e-6 scaled), xi_ell within
    1e-6 scaled of the float64 host path, and wp and its ngal bit for bit
    those of the all-'elementwise' launch."""
    (wp, xi), _ = _bench_tables(cuda)
    model = Zheng07Model(threshold=-18, redshift=wp.attrs["redshift"])
    mixed = make_multi_predictor([wp, xi], model, device=cuda,
                                 accuracy=("elementwise", "scaled"))
    fp32 = make_multi_predictor([wp, xi], model, device=cuda)
    plain = make_multi_predictor([wp, xi], model, device=cuda,
                                 engine="plain")
    params = _box_params(model, batch, 21, cuda)
    before = (fused.BUNDLE_LAUNCHES, fused.BUNDLE_TC_TABLES)
    got = mixed(params)
    torch.cuda.synchronize()
    assert (fused.BUNDLE_LAUNCHES, fused.BUNDLE_TC_TABLES) == (
        before[0] + 1, before[1] + 1)
    ref = fp32(params)
    torch.cuda.synchronize()
    assert fused.BUNDLE_TC_TABLES == before[1] + 1
    _assert_close_strict(got, plain(params), per_element=(0,))
    assert torch.equal(got[0][0], ref[0][0])
    assert torch.equal(got[0][1], ref[0][1])
    torch.testing.assert_close(got[1][0], ref[1][0], rtol=1e-7, atol=0)
    rows = range(0, batch, max(1, batch // 16))
    err = _host_scaled_error(xi, model, params, got[1][1], rows)
    print(f"bundle tensor-core route, xi_ell vs float64 host: {err:.3e} "
          "scaled")
    assert err <= 1e-6


def test_bundle_tc_route_keeps_nan_rows(cuda):
    """Rows whose parameters are NaN come out NaN on both routes; every
    other row is what the launch without them gives, bit for bit."""
    (wp, xi), _ = _bench_tables(cuda)
    model = Zheng07Model(threshold=-18, redshift=wp.attrs["redshift"])
    predict = make_multi_predictor([wp, xi], model, device=cuda,
                                   accuracy=("elementwise", "scaled"))
    params = {k: v.clone()
              for k, v in _box_params(model, 4096 + 37, 22, cuda).items()}
    clean = predict(params)
    rows = torch.tensor([0, 63, 64, 2049, 4132], device=cuda)
    for k in ("logMmin", "sigma_logM"):
        params[k][rows] = float("nan")
    got = predict(params)
    torch.cuda.synchronize()
    nan = torch.zeros(4096 + 37, dtype=torch.bool, device=cuda)
    nan[rows] = True
    for (ng, x), (ng0, x0) in zip(got, clean):
        x, x0 = x.reshape(x.shape[0], -1), x0.reshape(x0.shape[0], -1)
        assert bool(torch.isnan(ng[nan]).all())
        assert bool(torch.isnan(x[nan]).all())
        assert torch.equal(ng[~nan], ng0[~nan])
        assert torch.equal(x[~nan], x0[~nan])


@pytest.mark.parametrize("kind", ["assembias", "leauthaud11",
                                  "zheng07_subclass"])
def test_bundle_tc_route_for_model_codes_1_and_2(cuda, kind):
    """The decorated zheng07 (model code 1, in the kernel) and densities
    in (code 2: the occupation kernel's, or tensor ops') on the mixed
    route, against the plain contraction of the same densities."""
    objs, tables = _bench_tables(cuda)
    if kind == "assembias":
        model = AssembiasZheng07Model(threshold=-18,
                                      redshift=objs[0].attrs["redshift"])
        params = _params(model, 4096 + 37, 23, cuda)
    else:
        model = _family(kind)
        params = _family_params(model, 4096 + 37, 23, cuda)
    hod = fused.KernelModel.of(model)
    assert hod.code == (1 if kind == "assembias" else fused.DENSITY_IN)
    predict = make_multi_predictor(objs, model, device=cuda,
                                   accuracy=("elementwise", "scaled"))
    before = (fused.BUNDLE_LAUNCHES, fused.BUNDLE_TC_TABLES)
    got = predict(params)
    torch.cuda.synchronize()
    assert (fused.BUNDLE_LAUNCHES, fused.BUNDLE_TC_TABLES) == (
        before[0] + 1, before[1] + 1)
    if kind == "assembias":
        want = make_multi_predictor(objs, model, device=cuda,
                                    engine="plain")(params)
    else:
        want = fused.shaped(tables, [fused.contraction_plain(
            fused.bundle_table_constants(t), fused.kernel_densities(
                fused.slab_tc_table_constants(t, 1), t, model, hod,
                params).t()) for t in tables])
    _assert_close_strict(got, want, per_element=(0,))
    fp32 = make_multi_predictor(objs, model, device=cuda)(params)
    assert torch.equal(got[0][1], fp32[0][1])


def _bundle_sass():
    """{function name: SASS} of the built bundle library."""
    fused._bundle_lib()
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path("bundle"))],
                          capture_output=True, text=True, check=True).stdout
    return {f.split("\n", 1)[0].strip(): f
            for f in re.split(r"\n\s+Function : ", sass)[1:]}


def test_bundle_tc_instantiations_are_wgmma_on_tma(cuda):
    """cuobjdump -sass of the built bundle library: each of the three
    tensor-core instantiations of bundle_kernel (one a model code) issues
    HGMMA in TF32, takes its stages through mbarriers (SYNCS) and moves
    registers between its warpgroups (USETMAXREG); the three FP32-only
    instantiations issue no HGMMA and no SYNCS."""
    funcs = {k: v for k, v in _bundle_sass().items()
             if "bundle_kernel" in k}
    tc = [f for k, f in funcs.items() if "ELb1E" in k]
    fp32 = [f for k, f in funcs.items() if "ELb0E" in k]
    assert len(tc) == 3 and len(fp32) == 3, list(funcs)
    for f in tc:
        assert re.search(r"HGMMA\.64x128x8\.F32\.TF32", f)
        assert "SYNCS" in f and "USETMAXREG" in f
    for f in fp32:
        assert "HGMMA" not in f and "SYNCS" not in f


def test_fp32_and_tc_kernels_take_768_bins(cuda):
    """Where the FP32 block's 32-row ring does not fit: 16-row stages for
    bundle, contraction and slab, and 64-row blocks of one consumer
    warpgroup with 3 ring slots for slab_tc."""
    assert fused.fp32_stage_steps(768, 5) == 2
    assert fused.slab_tc_config(768, 5) == (1, 3)
    grid = _grid_table(2, 192, 2, 5, "auto", 21, cuda)
    assert grid.n_bins == 768
    model = _model("assembias")
    params = _params(model, 131, 9, cuda)
    occ = occupation_functions(model)
    want = fused.slab_predict_plain(fused.slab_table_constants(grid, 2),
                                    params, *occ)
    for accuracy in ("elementwise", "scaled"):
        got = fused.make_fused_grid_predictor(grid, 2, model,
                                              accuracy=accuracy,
                                              layout="slab")(params)
        _assert_grid_close(got, want)
    table = dataclasses.replace(grid, tpcf_dense=grid.tpcf_dense[:5],
                                tpcf_shape=(5,))
    small = _synthetic_table("cross", 45, 20, 3, 3, cuda)
    want = _bundle_plain([table, small], model, params)
    for accuracy in (None, ("scaled", "elementwise")):
        got = fused.make_fused_bundle_predictor([table, small], model,
                                                accuracy)(params)
        _assert_close(got, want, f"768 bins, {accuracy}")


def test_bundle_wrapper_raises_on_what_it_does_not_take(cuda):
    tables = _odd_tables(cuda)[:2]
    consts = [fused.slab_tc_table_constants(t, 1) for t in tables]
    pmat = torch.ones((8, 5), device=cuda)
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat.double())
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat.cpu())
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat, hod=fused.KernelModel(code=1))
    with pytest.raises(ValueError, match="half layout"):
        fused.bundle_launch([fused.bundle_table_constants(t) for t in tables],
                            pmat)
    grid = _grid_table(2, 12, 2, 7, "auto", 13, cuda)
    with pytest.raises(ValueError, match="1 node"):
        fused.bundle_launch([fused.slab_tc_table_constants(grid, 2)], pmat)
    with pytest.raises(ValueError, match="1 to 4 tables"):
        fused.bundle_launch(consts * 3, pmat)
    # Too many bins for the block: no quiet step down to the plain version.
    wide = _synthetic_table("auto", 1600, 800, 2, 5, cuda)
    for accuracy in (None, ("scaled",)):
        with pytest.raises(ValueError, match="shared memory"):
            fused.make_fused_bundle_predictor([wide], _model("zheng07"),
                                              accuracy)
    # Shapes and ring stages the C entry points refuse come back as a
    # launch error.
    before = fused.BUNDLE_LAUNCHES
    bad = [dataclasses.replace(consts[0], n_centrals=38), consts[1]]
    with pytest.raises(RuntimeError, match="bundle kernel launch failed"):
        fused.bundle_launch(bad, pmat)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(fused, "_FP32_STAGE_STEPS", (3,))
        with pytest.raises(RuntimeError, match="bundle kernel launch failed"):
            fused.bundle_launch(consts, pmat)
    assert fused.BUNDLE_LAUNCHES == before


# ----------------------------------------------------------------------
# Densities in (model code 2): the kernels contract the occupation
# kernel's densities, or for a model it does not evaluate densities
# computed in tensor ops
# ----------------------------------------------------------------------
class _Zheng07Subclass(Zheng07Model):
    """A zheng07 subclass: code 2, never code 0."""


def _family(kind):
    return {"leauthaud11": Leauthaud11Model(threshold=10.5),
            "zu15": ZuMandelbaum15Model(threshold=10.5,
                                        prim_haloprop_key="halo_mvir"),
            "assembias_leauthaud11": AssembiasLeauthaud11Model(
                threshold=10.5),
            "assembias_zu15": AssembiasZuMandelbaum15Model(threshold=10.5),
            "zheng07_subclass": _Zheng07Subclass(threshold=-18)}[kind]


def _family_params(model, batch, seed, device):
    """Every parameter within ~1% of the model's value, assembly-bias
    strengths uniform in [-1, 1]."""
    rng = np.random.default_rng(seed)
    overrides = {k: (rng.uniform(-1.0, 1.0, batch) if "assembias" in k else
                     v + 0.01 * abs(v) * rng.normal(size=batch))
                 for k, v in model.param_dict.items()}
    return params_batch(model, overrides, (batch,), device=device)


def _assert_close_strict(got, want, per_element=()):
    """The kernels' limits against their plain versions on the same
    densities: ngal 1e-6 relative; xi 1e-6 of each row's largest element,
    or 2e-6 relative per element for the tables in ``per_element`` (wp)."""
    for t, ((ng, xi), (ng_p, xi_p)) in enumerate(zip(got, want)):
        ng, ng_p = ng.double().cpu(), ng_p.double().cpu()
        assert float(((ng - ng_p).abs() / ng_p.abs()).max()) <= 1e-6, t
        xi = xi.double().cpu().reshape(xi.shape[0], -1)
        xi_p = xi_p.double().cpu().reshape(xi.shape[0], -1)
        if t in per_element:
            assert float(((xi - xi_p).abs() / xi_p.abs()).max()) <= 2e-6, t
        else:
            scaled = (xi - xi_p).abs().amax(1) / xi_p.abs().amax(1)
            assert float(scaled.max()) <= 1e-6, t


def _bench_tables(device):
    wp = TabCorr.read(DATA / "bolplanck_wp.npz")
    xi = TabCorr.read(DATA / "synthetic_xi_ell.npz")
    return [wp, xi], [t.table_data(device=device) for t in (wp, xi)]


@pytest.mark.parametrize("kind", ["leauthaud11", "zu15",
                                  "assembias_leauthaud11",
                                  "zheng07_subclass"])
def test_bundle_density_in_matches_plain(cuda, kind):
    objs, tables = _bench_tables(cuda)
    model = _family(kind)
    assert fused.KernelModel.of(model).code == fused.DENSITY_IN
    predict = make_multi_predictor(objs, model, device=cuda)
    params = _family_params(model, 4096 + 37, 3, cuda)
    before = fused.BUNDLE_LAUNCHES
    got = predict(params)
    torch.cuda.synchronize()
    assert fused.BUNDLE_LAUNCHES == before + 1
    # The plain contraction of the densities the kernel read (the
    # occupation kernel's, or the subclass's tensor-op ones).
    hod = fused.KernelModel.of(model)
    assert (hod.family is None) == (kind == "zheng07_subclass")
    want = [fused.contraction_plain(
        fused.bundle_table_constants(t), fused.kernel_densities(
            fused.slab_tc_table_constants(t, 1), t, model, hod, params).t())
        for t in tables]
    _assert_close_strict(got, fused.shaped(tables, want), per_element=(0,))


def _zheng07_inputs(table, kind, batch, device):
    """Code 0/1's parameter matrix, and the same rows' tensor-op densities
    in code 2's (n_bins, B) layout."""
    model = _model(kind)
    params = _params(model, batch, 12, device)
    hod = fused.KernelModel.of(model)
    return (fused._param_matrix(params, hod), hod,
            fused.occupation_density(table, model, params).t().contiguous())


@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
def test_bundle_density_in_equals_the_in_kernel_occupation(cuda, kind):
    _, tables = _bench_tables(cuda)
    consts = [fused.slab_tc_table_constants(t, 1) for t in tables]
    model = _model(kind)
    params = _params(model, 4096 + 37, 12, cuda)
    hod = fused.KernelModel.of(model)
    dens = [fused.occupation_density(t, model, params).t().contiguous()
            for t in tables]
    before = fused.BUNDLE_LAUNCHES
    code0 = fused.bundle_launch(consts, fused._param_matrix(params, hod),
                                hod)
    code2 = fused.bundle_launch(consts, dens, fused.KernelModel(code=2))
    torch.cuda.synchronize()
    assert fused.BUNDLE_LAUNCHES == before + 2
    _assert_close_strict(code2, code0, per_element=(0,))


@pytest.mark.parametrize("shape", ["auto 48 bins", "cross 1104 bins",
                                   "cross 1400 bins"])
@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
def test_grid_density_in_equals_the_in_kernel_occupation(cuda, shape, kind):
    """At 64-, 32- and 16-row blocks, folded, a NaN row."""
    if shape == "cross 1104 bins":
        table, _ = _ds_efficient_grid(kind, cuda)
        n_nodes = 4
    else:
        n_nodes = 6 if shape.startswith("auto") else 3
        table = (_grid_table(n_nodes, 12, 2, 7, "auto", 13, cuda)
                 if shape.startswith("auto") else
                 _grid_table(n_nodes, 350, 2, 5, "cross", 17, cuda))
    g = fused.grid_table_constants(table, n_nodes)
    assert fused.grid_block_rows(g.n_bins, g.n_xi) == {
        "auto 48 bins": 64, "cross 1104 bins": 32, "cross 1400 bins": 16}[
            shape]
    pmat, hod, dens = _zheng07_inputs(table, kind, 131, cuda)
    nw = torch.tensor(np.random.default_rng(4).dirichlet(np.ones(n_nodes),
                                                         131),
                      dtype=torch.float32, device=cuda)
    nw[5] = torch.nan
    before = fused.GRID_LAUNCHES
    code0 = fused.grid_launch(g, pmat, nw, hod)
    code2 = fused.grid_launch(g, dens, nw, fused.KernelModel(code=2))
    torch.cuda.synchronize()
    assert fused.GRID_LAUNCHES == before + 2
    assert bool(torch.isnan(code2[1][5]).all())
    keep = torch.arange(131, device=cuda) != 5
    _assert_close_strict([[a[keep] for a in code2]],
                         [[a[keep] for a in code0]])


@pytest.mark.parametrize("shape", ["auto 48 bins", "cross 1104 bins",
                                   "cross 1400 bins"])
@pytest.mark.parametrize("fold", [False, True])
def test_grid_density_in_matches_plain(cuda, shape, fold):
    if shape == "cross 1104 bins":
        table, _ = _ds_efficient_grid("zheng07", cuda)
        n_nodes = 4
    else:
        n_nodes = 6 if shape.startswith("auto") else 3
        table = (_grid_table(n_nodes, 12, 2, 7, "auto", 13, cuda)
                 if shape.startswith("auto") else
                 _grid_table(n_nodes, 350, 2, 5, "cross", 17, cuda))
    model = _family("assembias_leauthaud11")
    predict = fused.make_fused_grid_predictor(table, n_nodes, model,
                                              fold_spline=fold)
    g = fused.grid_table_constants(table, n_nodes)
    params = _family_params(model, 131, 5, cuda)
    nw = None
    if fold:
        nw = torch.tensor(np.random.default_rng(3).normal(
            size=(131, n_nodes)), dtype=torch.float32, device=cuda)
        nw[3] = torch.nan
    before = fused.GRID_LAUNCHES
    got = predict(params, nw) if fold else predict(params)
    torch.cuda.synchronize()
    assert fused.GRID_LAUNCHES == before + 1
    dens = fused.kernel_densities(g, table, model,
                                  fused.KernelModel.of(model), params).t()
    want = fused.grid_contract_plain(g, dens, nw)
    scale = None
    if fold:
        nodes = fused.grid_contract_plain(g, dens)[1]
        scale = (nw.abs()[:, :, None] * nodes.abs()).sum(1).amax(1)
    _assert_grid_close(got, want, nan_rows=(3,) if fold else (), scale=scale)


@pytest.mark.parametrize("accuracy", ["elementwise", "scaled"])
@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
def test_slab_density_in_equals_the_in_kernel_occupation(cuda, accuracy,
                                                         kind):
    table = _grid_table(3, 40, 2, 6, "auto", 5, cuda)
    s = fused.grid_constants(table, 3, "slab", accuracy, "cuda")
    launch = {"elementwise": fused.slab_launch,
              "scaled": fused.slab_tc_launch}[accuracy]
    pmat, hod, dens = _zheng07_inputs(table, kind, 4096 + 37, cuda)
    code0 = launch(s, pmat, hod)
    code2 = launch(s, dens, fused.KernelModel(code=2))
    _assert_close_strict([code2], [code0])


@pytest.mark.parametrize("accuracy", ["elementwise", "scaled"])
@pytest.mark.parametrize("mode,n_prim,n_xi,batch", [
    ("auto", 40, 6, 4096 + 37), ("cross", 11, 5, 8)])
def test_slab_density_in_matches_plain(cuda, accuracy, mode, n_prim, n_xi,
                                       batch):
    n_nodes = 3
    table = _grid_table(n_nodes, n_prim, 2, n_xi, mode, 5, cuda)
    model = _family("assembias_zu15")
    predict = fused.make_fused_grid_predictor(table, n_nodes, model,
                                              accuracy=accuracy,
                                              layout="slab")
    counter = {"elementwise": "SLAB_LAUNCHES",
               "scaled": "SLAB_TC_LAUNCHES"}[accuracy]
    params = _family_params(model, batch, 6, cuda)
    before = getattr(fused, counter)
    got = predict(params)
    torch.cuda.synchronize()
    assert getattr(fused, counter) == before + 1
    dens = fused.kernel_densities(
        fused.slab_tc_table_constants(table, n_nodes), table, model,
        fused.KernelModel.of(model), params).t()
    want = fused.slab_contract_plain(
        fused.slab_table_constants(table, n_nodes), dens)
    _assert_grid_close(got, want)


def test_fused_interpolator_density_in_nan_outside_the_grid(cuda):
    tabs = []
    for j in range(4):
        t = synthetic_tabcorr(np.random.default_rng(21), 12, 2, 7, "auto")
        t.tpcf_matrix = t.tpcf_matrix * (1.0 + 0.1 * np.random.default_rng(
            50 + j).normal(size=t.tpcf_matrix.shape))
        tabs.append(t)
    interp = Interpolator(tabs, ColumnTable(
        {"log_eta": [-0.4, -0.1, 0.2, 0.4]}))
    model = _family("leauthaud11")
    model.param_dict["log_eta"] = 0.0
    predict = make_predictor(interp, model, device=cuda)
    plain = make_predictor(interp, model, engine="plain", device=cuda)
    params = _family_params(model, 300, 8, cuda)
    eta = np.random.default_rng(7).uniform(-0.35, 0.35, 300)
    eta[[3, 200]] = [0.5, -0.6]
    params["log_eta"] = torch.tensor(eta, dtype=torch.float32, device=cuda)
    before = fused.GRID_LAUNCHES
    got = predict(params)
    torch.cuda.synchronize()
    assert fused.GRID_LAUNCHES == before + 1
    out = torch.zeros(300, dtype=torch.bool)
    out[[3, 200]] = True
    for ngal, xi in (got, plain(params)):
        ngal, xi = ngal.cpu(), xi.cpu().reshape(300, -1)
        assert bool(torch.isnan(ngal[out]).all() and
                    torch.isnan(xi[out]).all())
        assert bool(torch.isfinite(ngal[~out]).all() and
                    torch.isfinite(xi[~out]).all())


def test_density_in_wrappers_reject_bad_inputs(cuda):
    _, tables = _bench_tables(cuda)
    consts = [fused.slab_tc_table_constants(t, 1) for t in tables]
    code2 = fused.KernelModel(code=2)
    dens = [torch.ones((t.n_bins, 8), device=cuda) for t in tables]
    with pytest.raises(ValueError, match="one .* per table"):
        fused.bundle_launch(consts, dens[:1], code2)
    with pytest.raises(ValueError, match="densities must be"):
        fused.bundle_launch(consts, [dens[1], dens[0]], code2)
    with pytest.raises(ValueError, match="densities must be"):
        fused.bundle_launch(consts, [d.t().contiguous() for d in dens],
                            code2)
    with pytest.raises(ValueError, match="differ in batch"):
        fused.bundle_launch(consts, [dens[0], dens[1][:, :7].contiguous()],
                            code2)
    with pytest.raises(ValueError, match="densities must be"):
        fused.bundle_launch(consts, [dens[0].double(), dens[1]], code2)
    with pytest.raises(ValueError, match="contiguous"):
        fused.bundle_launch(consts, [dens[0], dens[1].t().contiguous().t()],
                            code2)
    table = _grid_table(3, 8, 1, 3, "auto", 1, cuda)
    g = fused.grid_table_constants(table, 3)
    bad = torch.ones((table.n_bins + 1, 8), device=cuda)
    with pytest.raises(ValueError, match="densities must be"):
        fused.grid_launch(g, bad, None, code2)
    for launch, s in ((fused.slab_launch,
                       fused.slab_tc_table_constants(table, 3)),
                      (fused.slab_tc_launch,
                       fused.slab_split_table_constants(table, 3))):
        with pytest.raises(ValueError, match="densities must be"):
            launch(s, bad, code2)
        with pytest.raises(ValueError, match="CUDA"):
            launch(s, bad[1:].cpu(), code2)


# ----------------------------------------------------------------------
# The occupation kernel of the HOD families (csrc/occupation.cu)
# ----------------------------------------------------------------------
OCCUPATION_KINDS = ("leauthaud11", "leauthaud11 z=0.5 unmodulated", "zu15",
                    "tinker13 all", "tinker13 quiescent", "tinker13 active",
                    "tinker13 5 control masses", "cacciato09",
                    "assembias_leauthaud11", "assembias_zu15",
                    "assembias_tinker13 quiescent",
                    "assembias_tinker13 active", "assembias_cacciato09")


def _occupation_model(kind, package=None):
    """The model of an occupation case, of the port (``package`` None) or
    of ``package`` (a module with the same model classes)."""
    decorated = kind.startswith("assembias_")
    name = kind.removeprefix("assembias_")
    pre = "Assembias" if decorated else ""
    import tabcorr_tpu_torch as ttt
    ttt = package or ttt
    if name.startswith("leauthaud11"):
        kw = (dict(redshift=0.5, modulate_with_cenocc=False)
              if "z=0.5" in name else {})
        return getattr(ttt, pre + "Leauthaud11Model")(threshold=10.5, **kw)
    if name == "zu15":
        return getattr(ttt, pre + "ZuMandelbaum15Model")(
            threshold=10.5, prim_haloprop_key="halo_mvir")
    if name.startswith("tinker13"):
        sfr = name.split()[1] if name.split()[1] in (
            "all", "quiescent", "active") else "active"
        kw = (dict(quiescent_fraction_abscissa=(11.5, 12.5, 13.5, 14.5,
                                                15.5))
              if "control" in name else {})
        return getattr(ttt, pre + "Tinker13Model")(
            threshold=10.5, sfr_designation=sfr, redshift=0.3, **kw)
    return getattr(ttt, pre + "Cacciato09Model")(
        threshold=10.0, prim_haloprop_key="halo_mvir")


def _occupation_params(model, batch, seed, device):
    """Every parameter within ~2% of the model's value (ordinates within
    0.05), strengths uniform in [-1, 1]; row 0 at the model's values."""
    rng = np.random.default_rng(seed)
    overrides = {}
    for k, v in model.param_dict.items():
        if "assembias" in k:
            o = rng.uniform(-1.0, 1.0, batch)
        elif "ordinates" in k:
            o = v + 0.05 * rng.uniform(-1.0, 1.0, batch)
        else:
            o = v + 0.02 * abs(v) * rng.uniform(-1.0, 1.0, batch)
        o[0] = v
        overrides[k] = o
    return params_batch(model, overrides, (batch,), device=device)


def _density_errors(got, want):
    """Per element |got - want| / (|want| + 1e-6 * the row's largest
    |want|): relative, floored at 1e-6 of the row."""
    got, want = got.double(), want.double()
    floor = 1e-6 * want.abs().amax(1, keepdim=True)
    return float(((got - want).abs() / (want.abs() + floor)).max())


def _assert_occupation_close(got_rows, table, table64, model, params):
    """(B, n_bins) kernel densities against the plain version (float32
    tensor ops) at tabcorr_tpu's fused-against-XLA bar (1e-4 relative +
    2e-6 of the row's largest), and against the float64 tensor path at
    1e-6 (the kernel evaluates the nodes in float64 and rounds once), where
    it is the more exact side of the comparison with plain."""
    plain = fused.occupation_density(table, model, params)
    d = (got_rows.double() - plain.double()).abs()
    bar = 1e-4 * plain.double().abs() + 2e-6 * plain.double().abs().amax(
        1, keepdim=True)
    assert bool((d <= bar).all()), float((d / bar).max())
    _assert_occupation_exact(got_rows, table, table64, model, params, plain)


def _assert_occupation_exact(got_rows, table, table64, model, params,
                             plain=None):
    """The float64 half of :func:`_assert_occupation_close`: finite, within
    1e-6 of the float64 tensor path and no further from it than the plain
    version (down to 2e-7).  Alone where the plain float32 version is
    itself off float64 by more than its bar with the kernel (nearly flat
    relations, roots held at the bracket's ends)."""
    if plain is None:
        plain = fused.occupation_density(table, model, params)
    want64 = fused.occupation_density(
        table64, model, {k: v.double() for k, v in params.items()})
    assert bool(torch.isfinite(got_rows).all())
    assert _density_errors(got_rows, want64) <= 1e-6
    assert _density_errors(got_rows, want64) <= max(
        2e-7, _density_errors(plain, want64))


@pytest.mark.parametrize("kind", OCCUPATION_KINDS)
def test_occupation_kernel_matches_plain_and_float64(cuda, kind):
    """Every family case on wp (its central and satellite bins share their
    units): the densities against plain and float64; both layouts hold the
    same bits."""
    tab = TabCorr.read(DATA / "bolplanck_wp.npz")
    table = tab.table_data(device=cuda)
    model = _occupation_model(kind)
    fam = fused.OccupationFamily.of(model)
    assert fam is not None and fused.KernelModel.of(model).family == fam
    params = _occupation_params(model, 4096 + 37, 11, cuda)
    c = fused.slab_tc_table_constants(table, 1)
    cols = fused.family_columns(params, fam)
    before = fused.OCCUPATION_LAUNCHES
    got, = fused.occupation_launch(c.occupation_plan, fam, cols,
                                   consts=[c])
    rows, = fused.occupation_launch(c.occupation_plan, fam, cols,
                                    bin_major=False)
    torch.cuda.synchronize()
    assert fused.OCCUPATION_LAUNCHES == before + 2
    assert got.shape == (table.n_bins, 4096 + 37)
    assert torch.equal(got.t(), rows)
    _assert_occupation_close(rows, table, tab.table_data(
        device=cuda, dtype=torch.float64), model, params)


@pytest.mark.parametrize("kind", ["leauthaud11", "zu15", "tinker13 active",
                                  "assembias_tinker13 quiescent",
                                  "assembias_cacciato09"])
def test_occupation_kernel_serves_a_bundle_in_one_launch(cuda, kind):
    """wp and xi_ell (split above and below) from one launch over their
    joint plan, each table against its plain and float64 densities, both
    layouts; the bundle predictor launches the kernel once per call."""
    objs, tables = _bench_tables(cuda)
    model = _occupation_model(kind)
    fam = fused.OccupationFamily.of(model)
    params = _occupation_params(model, 4096 + 37, 13, cuda)
    consts = [fused.slab_tc_table_constants(t, 1) for t in tables]
    plan = fused.occupation_plan(consts)
    cols = fused.family_columns(params, fam)
    before = fused.OCCUPATION_LAUNCHES
    got = fused.occupation_launch(plan, fam, cols, consts=consts)
    rows = fused.occupation_launch(plan, fam, cols, bin_major=False)
    torch.cuda.synchronize()
    assert fused.OCCUPATION_LAUNCHES == before + 2
    assert [tuple(d.shape) for d in got] == [(60, 4096 + 37),
                                             (120, 4096 + 37)]
    for d, r, obj, table in zip(got, rows, objs, tables):
        assert torch.equal(d.t(), r)
        _assert_occupation_close(r, table, obj.table_data(
            device=cuda, dtype=torch.float64), model, params)
    predict = make_multi_predictor(objs, model, device=cuda)
    before = (fused.OCCUPATION_LAUNCHES, fused.BUNDLE_LAUNCHES)
    predict(params)
    torch.cuda.synchronize()
    assert (fused.OCCUPATION_LAUNCHES, fused.BUNDLE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)


def test_occupation_kernel_on_a_wide_cross_table(cuda):
    """1104 bins (a table of the 'efficient' Delta Sigma grid), decorated,
    on the grid kernel's constants, against float64."""
    tab = Interpolator.read(DATA / "ds_efficient.npz").tabcorr_list[0]
    table = tab.table_data(device=cuda)
    model = AssembiasLeauthaud11Model(threshold=10.5, redshift=0.5)
    fam = fused.OccupationFamily.of(model)
    params = _occupation_params(model, 300, 12, cuda)
    g = fused.grid_table_constants(table, 1)
    got, = fused.occupation_launch(g.occupation_plan, fam,
                                   fused.family_columns(params, fam))
    want64 = fused.occupation_density(
        tab.table_data(device=cuda, dtype=torch.float64), model,
        {k: v.double() for k, v in params.items()})
    assert got.shape == (1104, 300)
    assert _density_errors(got.t(), want64) <= 1e-6


def test_occupation_kernel_on_the_ds_efficient_grid(cuda):
    """The stacked 'efficient' Delta Sigma grid (1104 bins, 280 units of 4
    outputs or fewer) for AssembiasLeauthaud11 at z = 0.5, 4,133 rows,
    through kernel_densities as the grid predictor calls it, against the
    float64 tensor path at 1e-6 and no further from it than the plain
    float32 version.  (The plain version itself is 5.8e-4 off float64
    here, beyond its own bar against an exact answer, so the comparison
    with it is the 13 cases' on wp.)"""
    interp = Interpolator.read(DATA / "ds_efficient.npz")
    stacked, n_nodes, _ = stacked_grid(interp, device=cuda)
    model = AssembiasLeauthaud11Model(threshold=10.5, redshift=0.5,
                                      prim_haloprop_key="halo_m258m")
    params = _occupation_params(model, 4096 + 37, 14, cuda)
    g = fused.grid_table_constants(stacked, n_nodes)
    assert g.occupation_plan.n_units == 280
    dens = fused.kernel_densities(g, stacked, model,
                                  fused.KernelModel.of(model), params)
    assert dens.shape == (1104, 4096 + 37)
    assert bool(torch.isfinite(dens).all())
    want64 = fused.occupation_density(
        interp.tabcorr_list[0].table_data(device=cuda, dtype=torch.float64),
        model, {k: v.double() for k, v in params.items()})
    plain = fused.occupation_density(stacked, model, params)
    assert _density_errors(dens.t(), want64) <= 1e-6
    assert _density_errors(dens.t(), want64) <= _density_errors(plain,
                                                                want64)


def test_occupation_kernel_on_a_table_whose_bins_share_no_node(cuda):
    """wp with its satellite bins' nodes moved by 0.01 dex: 60 units of one
    output each."""
    tab = TabCorr.read(DATA / "bolplanck_wp.npz")
    t64 = tab.table_data(device=cuda, dtype=torch.float64)
    logm = t64.log_prim_quad.clone()
    logm[t64.n_centrals:] += 0.01
    table64 = dataclasses.replace(t64, log_prim_quad=logm)
    # The float32 table at the same abscissae: node and residual.
    node = logm.float()
    table = dataclasses.replace(tab.table_data(device=cuda),
                                log_prim_quad=node,
                                log_prim_quad_lo=(logm - node.double()).float())
    model = _occupation_model("assembias_zu15")
    fam = fused.OccupationFamily.of(model)
    params = _occupation_params(model, 4096 + 37, 15, cuda)
    c = fused.slab_tc_table_constants(table, 1)
    assert c.occupation_plan.n_units == 60
    got, = fused.occupation_launch(c.occupation_plan, fam,
                                   fused.family_columns(params, fam),
                                   bin_major=False)
    _assert_occupation_close(got, table, table64, model, params)


def test_occupation_kernel_on_a_mass_bin_split_over_two_units(cuda):
    """xi_ell twice in one launch: each mass bin is read by 8 bins, more
    than a unit holds, so the plan splits it into two units of 4; both
    tables against plain and float64.  A plan whose units claim more
    outputs than the kernel takes is refused."""
    tab = TabCorr.read(DATA / "synthetic_xi_ell.npz")
    table = tab.table_data(device=cuda)
    c = fused.slab_tc_table_constants(table, 1)
    plan = fused.occupation_plan([c, c])
    assert (plan.n_units, plan.max_outs) == (60, 4)
    model = _occupation_model("assembias_zu15")
    fam = fused.OccupationFamily.of(model)
    params = _occupation_params(model, 4096 + 37, 17, cuda)
    cols = fused.family_columns(params, fam)
    got = fused.occupation_launch(plan, fam, cols, bin_major=False,
                                  consts=[c, c])
    table64 = tab.table_data(device=cuda, dtype=torch.float64)
    for rows in got:
        _assert_occupation_close(rows, table, table64, model, params)
    with pytest.raises(RuntimeError, match="occupation kernel launch"):
        fused.occupation_launch(dataclasses.replace(plan, max_outs=5), fam,
                                cols)


def test_occupation_kernel_feeds_the_contraction_row_major(cuda):
    """B3's layout: (B, n_bins), the bin-major densities transposed bit
    for bit; make_predictor(engine='fused') launches the occupation and
    the contraction kernel once each."""
    tab = TabCorr.read(DATA / "synthetic_xi_ell.npz")
    table = tab.table_data(device=cuda)
    model = _occupation_model("tinker13 quiescent")
    hod = fused.KernelModel.of(model)
    params = _occupation_params(model, 4096 + 37, 16, cuda)
    c = fused.slab_tc_table_constants(table, 1)
    rows = fused.kernel_densities(c, table, model, hod, params,
                                  bin_major=False)
    cols = fused.kernel_densities(c, table, model, hod, params)
    assert rows.shape == (4096 + 37, 120) and torch.equal(rows, cols.t())
    before = (fused.OCCUPATION_LAUNCHES, fused.CONTRACTION_LAUNCHES)
    ngal, xi = make_predictor(tab, model, engine="fused", device=cuda)(
        params)
    torch.cuda.synchronize()
    assert (fused.OCCUPATION_LAUNCHES, fused.CONTRACTION_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = fused.contraction_plain(fused.bundle_table_constants(table), rows)
    _assert_close_strict([(ngal, xi)], fused.shaped([table], [want]))


def test_occupation_wrapper_rejects_bad_inputs(cuda):
    objs, tables = _bench_tables(cuda)
    c, c_xi = (fused.slab_tc_table_constants(t, 1) for t in tables)
    fam = fused.OccupationFamily.of(Leauthaud11Model())
    plan = c.occupation_plan
    good = torch.ones((16, 8), device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        fused.occupation_launch(plan, fam, good.cpu())
    with pytest.raises(ValueError, match=r"\(16, B\)"):
        fused.occupation_launch(plan, fam, good[:15])
    with pytest.raises(ValueError, match=r"\(16, B\)"):
        fused.occupation_launch(plan, fam, good.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused.occupation_launch(plan, fam, good.t().contiguous().t())
    # A plan of other constants, or of other tables, or not a plan.
    with pytest.raises(ValueError, match="not built from"):
        fused.occupation_launch(plan, fam, good, consts=[c_xi])
    with pytest.raises(ValueError, match="not built from"):
        fused.occupation_launch(fused.occupation_plan([c, c_xi]), fam, good,
                                consts=[c_xi, c])
    with pytest.raises(ValueError, match="reads a node plan"):
        fused.occupation_launch(c, fam, good)
    # A plan on the CPU for parameters on the card.
    cpu_plan = fused.occupation_plan([fused.bundle_table_constants(
        objs[0].table_data(device="cpu"))])
    with pytest.raises(ValueError, match="node plan"):
        fused.occupation_launch(cpu_plan, fam, good)
    before = fused.OCCUPATION_LAUNCHES
    assert fused.occupation_launch(plan, fam, good[:, :0])[0].shape == (
        c.n_bins, 0)
    assert fused.OCCUPATION_LAUNCHES == before + 1


# ----------------------------------------------------------------------
# The SHMR walk at its edges (csrc/occupation.cu shmr_log_mstar): the
# float32 warm start carried from node to node and from unit to unit of a
# block, the bisection reseed, the Newton steps held to [5, 13] and the
# domain, for the SHMR families (Leauthaud11 decorates each population
# once a node, kSharedDecoration), on wp (30 units of 10 nodes).
# ----------------------------------------------------------------------
SHMR_KINDS = ("assembias_leauthaud11", "assembias_zu15")


def _shmr_model(kind, threshold=10.5):
    if kind == "assembias_leauthaud11":
        return AssembiasLeauthaud11Model(threshold=threshold)
    return AssembiasZuMandelbaum15Model(threshold=threshold,
                                        prim_haloprop_key="halo_mvir")


def _shmr_relation(kind, model):
    """The model's relation in float64: log10 Mh(log10 M*), its inverse
    (held to [5, 13]) and its slope d log10 Mh / d log10 M*."""
    if kind == "assembias_leauthaud11":
        a, h = model._a, model.littleh
        return (lambda ls, p: behroozi10_log_halo_mass(ls, p, a, h),
                lambda lm, p: fshmr_log_mstar(lm, p, a, h),
                lambda ls, p: _d_log_mh_d_log_mstar(ls, p, a, h))
    return (zu15_log_halo_mass, zu15_log_mstar,
            lambda ls, p: _d_log_mh_d_log_mstar(
                ls, _behroozi_coeff_dict(p), 1.0, 1.0))


def _shmr_keys(kind):
    """The keys of beta, delta, gamma and log10 M1 (Zu15: M1)."""
    if kind == "assembias_leauthaud11":
        return ("smhm_beta_0", "smhm_delta_0", "smhm_gamma_0", "smhm_m1_0")
    return ("smhm_beta", "smhm_delta", "smhm_gamma", "smhm_m1")


def _wp_occupation(cuda):
    tab = TabCorr.read(DATA / "bolplanck_wp.npz")
    table = tab.table_data(device=cuda)
    plan = fused.slab_tc_table_constants(table, 1).occupation_plan
    return table, tab.table_data(device=cuda, dtype=torch.float64), plan


def _plan_abscissae(plan):
    return plan.node.double() + plan.res.double()


def _launch_rows(plan, model, params):
    fam = fused.OccupationFamily.of(model)
    got, = fused.occupation_launch(plan, fam,
                                   fused.family_columns(params, fam),
                                   bin_major=False)
    torch.cuda.synchronize()
    return got


@pytest.mark.parametrize("kind", SHMR_KINDS)
def test_occupation_kernel_reseeds_the_walk_inside_a_unit(cuda, kind):
    """Nearly flat relations (beta 5e-4, 1e-3, 5e-3; delta or gamma 0.02):
    the slope at a node's root puts the next node's root more than 0.2 dex
    away inside a unit, so the walk reseeds there; against float64."""
    model = _shmr_model(kind)
    table, table64, plan = _wp_occupation(cuda)
    params = _occupation_params(model, 4096 + 37, 21, cuda)
    beta, delta, gamma, _ = _shmr_keys(kind)
    for i, (b, d, g) in enumerate([(5e-4, None, None), (1e-3, 0.02, None),
                                   (5e-3, None, 0.02)]):
        params[beta][i::3] = b
        if d is not None:
            params[delta][i::3] = d
        if g is not None:
            params[gamma][i::3] = g
    _, inverse, slope = _shmr_relation(kind, model)
    y = _plan_abscissae(plan)
    p64 = {k: v.double()[:, None, None] for k, v in params.items()}
    roots = inverse(y[None], p64)
    inside = (roots > 5.0) & (roots < 13.0)
    moves = (y[:, 1:] - y[:, :-1])[None] > 0.2 * slope(roots, p64)[..., :-1]
    assert int((moves & inside[..., :-1] & inside[..., 1:]).sum()) > 100
    _assert_occupation_exact(_launch_rows(plan, model, params), table,
                             table64, model, params)


@pytest.mark.parametrize("end", [5.0, 13.0])
@pytest.mark.parametrize("kind", SHMR_KINDS)
def test_occupation_kernel_holds_roots_at_an_end_inside_a_unit(cuda, kind,
                                                               end):
    """M1 moved row by row so that the relation reaches `end` between the
    5th and 6th node of a unit (each row another unit): half the unit's
    roots lie beyond [5, 13] and are held at the end, the next unit's walk
    starts from there; a threshold 0.2 dex inside the end; against
    float64."""
    model = _shmr_model(kind, threshold=end + (0.2 if end == 5.0 else -0.2))
    table, table64, plan = _wp_occupation(cuda)
    batch = 4096 + 37
    params = _occupation_params(model, batch, 22, cuda)
    forward, inverse, _ = _shmr_relation(kind, model)
    y = _plan_abscissae(plan)
    unit = torch.arange(batch, device=cuda) % plan.n_units
    p64 = {k: v.double() for k, v in params.items()}
    shift = 0.5 * (y[unit, 4] + y[unit, 5]) - forward(
        torch.tensor(end, dtype=torch.float64, device=cuda), p64)
    m1 = _shmr_keys(kind)[3]
    params[m1] = (p64[m1] + shift if kind == "assembias_leauthaud11" else
                  p64[m1] * 10.0 ** shift).float()
    roots = inverse(y[unit], {k: v.double()[:, None]
                              for k, v in params.items()})
    low, high = roots[:, :5], roots[:, 5:]
    if end == 13.0:
        assert bool(((low < end).all(1) & (high >= end).all(1)).all())
    else:
        assert bool(((low <= end).all(1) & (high > end).all(1)).all())
    _assert_occupation_exact(_launch_rows(plan, model, params), table,
                             table64, model, params)


@pytest.mark.parametrize("kind", SHMR_KINDS)
def test_occupation_kernel_keeps_nan_rows_beside_sound_rows(cuda, kind):
    """Every odd row outside the inverse's domain (beta, delta or gamma
    negative; Leauthaud11's scatter too): NaN where the float64 path is
    NaN, and the even rows of the same warps against float64."""
    model = _shmr_model(kind)
    table, table64, plan = _wp_occupation(cuda)
    batch = 4096 + 37
    params = _occupation_params(model, batch, 23, cuda)
    beta, delta, gamma, _ = _shmr_keys(kind)
    outside = [(beta, -0.1), (delta, -0.1), (gamma, -0.5)]
    if kind == "assembias_leauthaud11":
        outside.append(("scatter_model_param1", -0.05))
    for i, (key, value) in enumerate(outside):
        params[key][2 * i + 1::2 * len(outside)] = value
    got = _launch_rows(plan, model, params)
    want64 = fused.occupation_density(
        table64, model, {k: v.double() for k, v in params.items()})
    odd = torch.arange(batch, device=cuda) % 2 == 1
    assert torch.equal(torch.isnan(got), torch.isnan(want64))
    assert torch.equal(torch.isnan(got).any(1), odd)
    sound = {k: v[~odd] for k, v in params.items()}
    _assert_occupation_close(got[~odd], table, table64, model, sound)


@pytest.mark.parametrize("kind", SHMR_KINDS)
def test_occupation_kernel_carries_the_walk_across_a_blocks_units(
        cuda, monkeypatch, kind):
    """Four units a block (the last block two): the warm start carries from
    each unit's last node to the next unit's first inside a block, and the
    bisection reseeds at each block's first; against plain and float64."""
    model = _shmr_model(kind)
    table, table64, plan = _wp_occupation(cuda)
    batch = 4096 + 37
    monkeypatch.setattr(fused, "_OCC_TARGET_BLOCKS", 247)
    assert fused.occupation_units_per_block(plan.n_units, batch) == 4
    assert plan.n_units % 4 == 2
    params = _occupation_params(model, batch, 24, cuda)
    _assert_occupation_close(_launch_rows(plan, model, params), table,
                             table64, model, params)


def _cross_table(n_gauss, dtype, device):
    """A cross table of 20 mass bins 0.2 dex wide from 11 to 15, centrals
    and satellites, ``n_gauss`` nodes a bin; secondary percentiles
    alternate 0.25 / 0.75."""
    rng = np.random.default_rng(25)
    log_min = np.tile(np.linspace(11.0, 14.8, 20), 2)
    log_quad, weight = quadrature_grid(log_min, log_min + 0.2,
                                       np.full(40, -1.7), n_gauss)
    lo = None
    if dtype == torch.float32:
        lo = log_quad - log_quad.astype(np.float32).astype(np.float64)
    return TableData.from_numpy(
        dict(tpcf_dense=3.0 + rng.normal(size=(13, 40)),
             n_h=10.0 ** rng.uniform(-6, -2, 40), log_prim_quad=log_quad,
             quad_weight=weight,
             sec_perc=np.where(np.arange(40) % 2, 0.25, 0.75),
             log_prim_quad_lo=lo),
        mode="cross", tpcf_shape=(13,), n_centrals=20, device=device,
        dtype=dtype)


@pytest.mark.parametrize("n_gauss", [1, 21])
@pytest.mark.parametrize("kind", SHMR_KINDS)
def test_occupation_kernel_takes_one_node_a_unit_and_many(cuda, kind,
                                                          n_gauss):
    """Units of one node and of 21 (the wp tables' 10 elsewhere); against
    plain and float64."""
    model = _shmr_model(kind)
    table = _cross_table(n_gauss, torch.float32, cuda)
    plan = fused.grid_table_constants(table, 1).occupation_plan
    assert (plan.n_units, plan.n_gauss) == (20, n_gauss)
    params = _occupation_params(model, 4096 + 37, 26, cuda)
    _assert_occupation_close(_launch_rows(plan, model, params), table,
                             _cross_table(n_gauss, torch.float64, cuda),
                             model, params)


def test_slab_tc_is_wgmma_on_tma_in_every_instantiation(cuda):
    """cuobjdump -sass of the built slab library: every slab_tc_kernel
    instantiation issues HGMMA (wgmma) and takes its B tiles through
    mbarriers (SYNCS); no function of the library issues HMMA
    (mma.sync).  The two-consumer blocks move registers between their
    warpgroups (USETMAXREG), the one-consumer blocks do not."""
    fused._slab_lib()
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path("slab"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s+Function : ", sass)[1:]
    tc = [f for f in funcs if "slab_tc_kernel" in f.split("\n", 1)[0]]
    assert len(tc) == 12
    for f in tc:
        assert "HGMMA.64x128x8.F32.TF32" in f and "SYNCS" in f
        two = "slab_tc_kernelILi2E" in f.split("\n", 1)[0]
        assert ("USETMAXREG" in f) == two
    assert not any(re.search(r"\bHMMA\.", f) for f in funcs)
