"""The grid kernel's plain version and the Interpolator predictors against
tabcorr_tpu.

Small synthetic grids (5-6 nodes sharing one binning of 10-12 primary x
1-2 secondary bins per galaxy type, 5-7 statistic rows) go through the
port's plain version of the grid kernel and through tabcorr_tpu's packed
grid kernel in Pallas interpret mode, at B = 8 and a ragged B = 5, auto
and cross mode, with and without the spline fold (the slab layout's
kernel, B4, is in test_torch_slab.py).  Tolerances: ngal 1e-6
relative; per-node xi 2e-6 of each row's largest element; folded xi
``atol = 2e-6 max|xi|, rtol = 2e-5`` (as tests/test_grid_stream.py holds
the JAX kernels).  The Interpolator predictors are checked against
tabcorr_tpu's routes and against the float64 host path (scaled <= 1e-6).
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu.ops.fused as jax_fused
import tabcorr_tpu.predictor as jax_pred
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.io import ColumnTable as JaxColumnTable
from tabcorr_tpu_torch import predictor
from tabcorr_tpu_torch.io import ColumnTable
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.utils.synthetic import grid64_interpolator

from conftest import DATA_DIR
from test_bundle_shapes import synthetic_tabcorr
from test_grid_stream import _grid_tabs, _stack

ROOT = Path(__file__).absolute().parents[1]
FIXTURES = {
    "ds": DATA_DIR / "AbacusSummit" / "base_c000_ph000" / "0p50" /
    "ds_efficient.hdf5",
    "xi": DATA_DIR / "examples" / "synthetic_xi_ell_interp.hdf5",
}


def _port_tab(tab):
    """The port's TabCorr holding the same arrays as a tabcorr_tpu one."""
    out = ttt.TabCorr()
    out.attrs = dict(tab.attrs)
    out.gal_type = ColumnTable.from_structured_array(
        tab.gal_type.as_structured_array())
    out.tpcf_matrix = np.asarray(tab.tpcf_matrix, np.float64)
    out.tpcf_shape = tuple(int(s) for s in tab.tpcf_shape)
    return out


def _port_stack(tabs):
    tables = [_port_tab(t).table_data(device="cpu") for t in tabs]
    return dataclasses.replace(
        tables[0], tpcf_dense=torch.cat([t.tpcf_dense for t in tables]),
        tpcf_shape=(len(tables) * tables[0].tpcf_dense.shape[0],))


def _params(batch, seed):
    rng = np.random.default_rng(seed)
    return {"logMmin": (12.02 + 0.1 * rng.normal(size=batch)),
            "sigma_logM": 0.26 + 0.01 * rng.normal(size=batch),
            "logM0": 11.38 + 0.1 * rng.normal(size=batch),
            "logM1": 13.31 + 0.1 * rng.normal(size=batch),
            "alpha": 1.06 + 0.02 * rng.normal(size=batch)}


def _both(params):
    p32 = {k: np.asarray(v, np.float32) for k, v in params.items()}
    return ({k: jnp.asarray(v) for k, v in p32.items()},
            {k: torch.tensor(v) for k, v in p32.items()})


def _scaled(got, want):
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    return float(np.max(np.max(np.abs(got - want), axis=1) /
                        np.max(np.abs(want), axis=1)))


@pytest.mark.parametrize("mode", ["auto", "cross"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("batch", [8, 5])
def test_grid_plain_matches_jax_packed_kernel(mode, fold, batch):
    n_nodes, n_xi = (6, 7) if mode == "auto" else (5, 5)
    tabs = _grid_tabs(n_nodes, 12 if mode == "auto" else 10,
                      2 if mode == "auto" else 1, n_xi, mode, seed=13)
    jax_model = tt.Zheng07Model(threshold=-20, redshift=0.0)
    model = ttt.Zheng07Model(threshold=-20, redshift=0.0)
    jax_f = jax_fused.make_fused_grid_predictor(
        _stack(tabs), n_nodes, *jax_pred.occupation_functions(jax_model),
        tuple(jax_model.param_dict), batch_tile=8, interpret=True,
        layout="packed", fold_spline=fold)
    f = fused.make_fused_grid_predictor(_port_stack(tabs), n_nodes, model,
                                        layout="packed", fold_spline=fold)
    p_jax, p = _both(_params(batch, 7))
    before = fused.GRID_LAUNCHES
    if fold:
        nw = np.random.default_rng(21).normal(
            size=(batch, n_nodes)).astype(np.float32)
        nw[3] = np.nan
        (ng_j, xi_j), (ng, xi) = jax_f(p_jax, jnp.asarray(nw)), f(
            p, torch.tensor(nw))
    else:
        (ng_j, xi_j), (ng, xi) = jax_f(p_jax), f(p)
    assert fused.GRID_LAUNCHES == before    # CPU tensors: no launch
    ng_j, xi_j = np.asarray(ng_j, np.float64), np.asarray(xi_j, np.float64)
    ng, xi = ng.double().numpy(), xi.double().numpy()
    assert xi.shape == xi_j.shape == ((batch, n_xi) if fold else
                                      (batch, n_nodes, n_xi))
    np.testing.assert_allclose(ng, ng_j, rtol=1e-6)
    if not fold:
        assert _scaled(xi, xi_j) <= 2e-6
        return
    # NaN weights poison exactly their row.
    assert np.all(np.isnan(xi[3])) and np.all(np.isnan(xi_j[3]))
    ok = np.arange(batch) != 3
    assert np.all(np.isfinite(xi[ok]))
    np.testing.assert_allclose(xi[ok], xi_j[ok], rtol=2e-5,
                               atol=2e-6 * np.max(np.abs(xi_j[ok])))


def test_grid_plain_is_independent_of_the_chunk(monkeypatch):
    tabs = _grid_tabs(5, 10, 1, 5, "auto", seed=3)
    g = fused.grid_table_constants(_port_stack(tabs), 5)
    occ = ttt.occupation_functions(ttt.Zheng07Model(threshold=-20))
    p = _both(_params(11, 4))[1]
    nw = torch.tensor(np.random.default_rng(5).dirichlet(np.ones(5), 11),
                      dtype=torch.float32)
    whole = fused.grid_predict_plain(g, p, nw, *occ)
    monkeypatch.setattr(fused, "_PLAIN_CHUNK", 4)
    chunked = fused.grid_predict_plain(g, p, nw, *occ)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_grid_wrapper_never_falls_back_to_the_cpu():
    tabs = _grid_tabs(3, 8, 1, 3, "auto", seed=1)
    g = fused.grid_table_constants(_port_stack(tabs), 3)
    with pytest.raises(ValueError, match="CUDA"):
        fused.grid_launch(g, torch.ones((4, 5)))


@pytest.mark.parametrize("n_bins,n_xi,rows", [
    (60, 42, 64), (1104, 13, 32), (1400, 13, 16), (300, 42, 64),
    (3000, 1, None)])
def test_grid_block_rows(n_bins, n_xi, rows):
    """The grid kernel's rows per block: 64 at grid64's 60 bins and at a
    300-bin packed auto grid, 32 at the 1104-bin Delta Sigma table, 16 at
    1400 bins, and no block where 16 rows' densities overflow shared
    memory."""
    assert fused.grid_block_rows(n_bins, n_xi) == rows
    if rows is not None:
        nxp = -(-n_xi // 4) * 4
        assert fused._grid_smem_bytes(rows, n_bins, nxp) <= fused._SMEM_LIMIT
        if rows < 64:
            assert (fused._grid_smem_bytes(2 * rows, n_bins, nxp) >
                    fused._SMEM_LIMIT)


def test_slab_layout_is_not_ported(monkeypatch):
    """Layout routing: 'slab' runs the slab kernel's route (B4), 'auto'
    picks it where the packed pair row is too wide, and the grid kernel
    (B2) does not take such a grid."""
    tabs = _grid_tabs(2, 8, 1, 3, "auto", seed=1)
    model = ttt.Zheng07Model(threshold=-20)
    routes = []
    monkeypatch.setattr(fused, "slab_predict_plain",
                        lambda *a: routes.append("slab"))
    monkeypatch.setattr(fused, "grid_predict_plain",
                        lambda *a: routes.append("packed"))
    p = _both(_params(3, 1))[1]
    fused.make_fused_grid_predictor(_port_stack(tabs), 2, model,
                                    layout="slab")(p)
    fused.make_fused_grid_predictor(_port_stack(tabs), 2, model)(p)
    assert routes == ["slab", "packed"]
    with pytest.raises(ValueError, match="layout"):
        fused.make_fused_grid_predictor(_port_stack(tabs), 2, model,
                                        layout="rows")
    # 128 bins: the packed pair row (8256 pairs) exceeds 8192 lanes, so
    # 'auto' picks the slab layout in both packages.
    wide = [synthetic_tabcorr(np.random.default_rng(2), 64, 1, 2, "auto")
            for _ in range(2)]
    assert jax_fused.grid_layout_for(_stack(wide)) == "slab"
    stacked = _port_stack(wide)
    assert fused.grid_layout_for(stacked) == "slab"
    fused.make_fused_grid_predictor(stacked, 2, model)(p)
    assert routes == ["slab", "packed", "slab"]
    assert not fused.grid_fits(128, "auto", 2)
    assert fused.grid_kernel_takes(128, "auto", 2)
    assert fused.grid_fits(1104, "cross", 13)
    assert fused.grid_fits(2000, "cross", 13)     # 16-row blocks
    assert not fused.grid_fits(3000, "cross", 13)


def _jax_and_port_nodes(keys, xps, batch, seed, extrapolate):
    from tabcorr_tpu.interpolator import spline_interpolation_matrix
    rng = np.random.default_rng(seed)
    a = [spline_interpolation_matrix(xp) for xp in xps]
    x = {k: rng.uniform(xp[0] - 0.1, xp[-1] + 0.05, batch)
         for k, xp in zip(keys, xps)}
    jax_w = jax_pred._grid_node_weights(
        {k: jnp.asarray(v) for k, v in x.items()}, keys,
        [jnp.asarray(xp) for xp in xps], [jnp.asarray(m) for m in a],
        extrapolate)
    w = predictor._grid_node_weights(
        {k: torch.tensor(v) for k, v in x.items()}, keys,
        [torch.tensor(xp) for xp in xps], [torch.tensor(m) for m in a],
        extrapolate)
    return x, a, np.asarray(jax_w), w


@pytest.mark.parametrize("extrapolate", [False, True])
def test_grid_node_weights_and_spline_match_jax(extrapolate):
    keys = ["alpha_c", "alpha_s", "log_eta"]
    xps = [np.linspace(0.0, 0.4, 4), np.linspace(0.8, 1.2, 4),
           np.linspace(-0.4, 0.4, 5)]
    x, a, jax_w, w = _jax_and_port_nodes(keys, xps, 16, 3, extrapolate)
    w = w.numpy()
    assert w.shape == jax_w.shape == (16, 80)
    nan_rows = np.isnan(jax_w).any(axis=1)
    assert extrapolate or nan_rows.any()
    np.testing.assert_array_equal(np.isnan(w).all(axis=1), nan_rows)
    np.testing.assert_allclose(w[~nan_rows], jax_w[~nan_rows], rtol=1e-12,
                               atol=1e-12)
    # The sequential spline over the grid equals the folded weights.
    values = np.random.default_rng(4).normal(size=(16, 80, 3))
    got = predictor._spline_over_grid(
        {k: torch.tensor(v) for k, v in x.items()}, keys,
        [torch.tensor(xp) for xp in xps], [torch.tensor(m) for m in a],
        (4, 4, 5), torch.tensor(values), extrapolate).numpy()
    want = np.einsum("bn,bnk->bk", w, values)
    assert np.array_equal(np.isnan(got).all(axis=1), nan_rows)
    np.testing.assert_allclose(got[~nan_rows], want[~nan_rows], rtol=1e-10,
                               atol=1e-12)
    jax_one = jax_pred._spline_over_grid(
        {k: jnp.asarray(v[0]) for k, v in x.items()}, keys,
        [jnp.asarray(xp) for xp in xps], [jnp.asarray(m) for m in a],
        (4, 4, 5), jnp.asarray(values[0]), extrapolate)
    np.testing.assert_allclose(got[0], np.asarray(jax_one), rtol=1e-10,
                               atol=1e-12)


def test_pad_table_data_matches_jax():
    tab = synthetic_tabcorr(np.random.default_rng(6), 5, 1, 3, "auto")
    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        want = jax_pred._pad_table_data(
            tab.table_data(n_gauss=4, dtype=jdtype), 7, 6)
        got = predictor._pad_table_data(
            _port_tab(tab).table_data(n_gauss=4, dtype=dtype, device="cpu"),
            7, 6)
        assert got.n_centrals == want.n_centrals == 7
        for field in ("tpcf_dense", "n_h", "log_prim_quad", "quad_weight",
                      "sec_perc", "log_prim_quad_lo"):
            a, b = getattr(got, field), getattr(want, field)
            if b is None:
                assert a is None
                continue
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        predictor._pad_table_data(
            _port_tab(tab).table_data(device="cpu"), 4, 6)


def _models(kind, interp, **grid):
    if kind == "ds":
        kw = dict(threshold=-21, redshift=0.5, prim_haloprop_key="halo_m258m")
    else:
        kw = dict(threshold=-20,
                  redshift=float(interp.tabcorr_list[0].attrs["redshift"]))
    out = (tt.Zheng07Model(**kw), ttt.Zheng07Model(**kw))
    for m in out:
        m.param_dict.update(grid)
    return out


@pytest.mark.parametrize("kind", ["ds", "xi"])
def test_fused_interpolator_matches_jax_streamed_route(monkeypatch, kind):
    jax_interp = tt.Interpolator.read(FIXTURES[kind])
    interp = ttt.Interpolator.read(FIXTURES[kind])
    jax_model, model = _models(kind, interp, log_eta=0.0)
    # tabcorr_tpu's streamed route (the one this port's kernel replaces),
    # in interpret mode with a small batch tile.
    monkeypatch.setattr(jax_pred, "_fused_constants_fit_vmem",
                        lambda *a, **k: False)
    make_grid = jax_fused.make_fused_grid_predictor
    monkeypatch.setattr(jax_fused, "make_fused_grid_predictor",
                        lambda *a, **k: make_grid(*a, batch_tile=8, **k))
    jax_f = jax_pred.make_predictor(jax_interp, jax_model, engine="fused",
                                    accuracy="scaled")
    f = ttt.make_predictor(interp, model, engine="fused", accuracy="scaled",
                           device="cpu")
    params = _params(6, 9)
    params["log_eta"] = np.array([0.0, -0.3, 0.2, 0.1, -0.46, 0.9])
    p_jax, p = _both(params)
    for k, v in model.param_dict.items():
        p.setdefault(k, torch.full((6,), v))
        p_jax.setdefault(k, jnp.full((6,), v, jnp.float32))
    ng_j, xi_j = (np.asarray(a, np.float64) for a in jax_f(p_jax))
    ng, xi = (a.double().numpy() for a in f(p))
    assert xi.shape == xi_j.shape == (6,) + interp.tabcorr_list[0].tpcf_shape
    # Row 5 lies outside the grid: NaN in both packages.
    assert np.isnan(ng[5]) and np.isnan(ng_j[5])
    assert np.all(np.isnan(xi[5])) and np.all(np.isnan(xi_j[5]))
    np.testing.assert_allclose(ng[:5], ng_j[:5], rtol=1e-6)
    assert _scaled(xi[:5], xi_j[:5]) <= 2e-6
    for i in range(4):
        m = ttt.Zheng07Model(threshold=model.threshold,
                             redshift=model.redshift,
                             prim_haloprop_key=model.prim_haloprop_key)
        m.param_dict.update({k: float(v[i]) for k, v in p.items()})
        ng64, xi64 = interp.predict(m, check_consistency=False)
        assert _scaled(xi[i:i + 1], xi64[None]) <= 1e-6, i
        assert abs(ng[i] / ng64 - 1) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_engine_matches_jax_xla_on_mixed_binnings(dtype):
    # Two halo binnings among four nodes: the occupations are evaluated
    # once per binning, zero-padded to a common width, and gathered.
    jax_tabs = [synthetic_tabcorr(np.random.default_rng(s), n, 1, 4, "auto")
                for s, n in ((1, 6), (2, 5), (1, 6), (3, 5))]
    for j, t in enumerate(jax_tabs):
        t.tpcf_matrix = t.tpcf_matrix * (1.0 + 0.05 * j)
    eta = [-0.4, -0.1, 0.2, 0.4]
    jax_interp = tt.Interpolator(jax_tabs, JaxColumnTable({"log_eta": eta}))
    interp = ttt.Interpolator([_port_tab(t) for t in jax_tabs],
                              ColumnTable({"log_eta": eta}))
    assert len(interp.unique_gal_type_index) == 3
    jax_model, model = _models("xi", interp, log_eta=0.0)
    params = _params(5, 2)
    params["log_eta"] = np.array([-0.3, 0.0, 0.1, 0.39, 0.5])
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    p_jax = {k: jnp.asarray(v, jdtype) for k, v in params.items()}
    p = {k: torch.tensor(v, dtype=dtype) for k, v in params.items()}
    for separate in (False, True):
        jax_f = jax_pred.make_predictor(jax_interp, jax_model, engine="xla",
                                        dtype=jdtype,
                                        separate_gal_type=separate)
        f = ttt.make_predictor(interp, model, dtype=dtype, device="cpu",
                               separate_gal_type=separate)
        got, want = f(p), jax_f(p_jax)
        for g, w in zip(got, want):
            pairs = ([(g[k], w[k]) for k in w] if separate else [(g, w)])
            for a, b in pairs:
                a = a.double().numpy()
                b = np.asarray(b, np.float64)
                assert a.shape == b.shape
                assert np.all(np.isnan(a[4])) and np.all(np.isnan(b[4]))
                tol = 1e-12 if dtype == torch.float64 else 2e-6
                assert _scaled(a[:4].reshape(4, -1),
                               b[:4].reshape(4, -1)) <= tol
    with pytest.raises(ValueError, match="share one halo binning"):
        ttt.make_predictor(interp, model, engine="fused", device="cpu")


def test_make_predictor_engines_and_dtypes():
    interp = ttt.Interpolator.read(FIXTURES["xi"])
    _, model = _models("xi", interp, log_eta=0.0)
    assert ttt.make_predictor(interp, model, device="cpu").__qualname__ == \
        ttt.make_predictor(interp, model, engine="plain",
                           device="cpu").__qualname__
    # The bfloat16 fused route builds on the CPU (its kernel's plain
    # version): bfloat16 ngal (B,) and xi (B, *tpcf_shape).
    f = ttt.make_predictor(interp, model, engine="fused",
                           dtype=torch.bfloat16, device="cpu")
    ngal, xi = f({k: torch.full((3,), v, dtype=torch.float32)
                  for k, v in model.param_dict.items()})
    assert ngal.dtype == xi.dtype == torch.bfloat16
    assert ngal.shape == (3,)
    assert xi.shape == (3,) + tuple(interp.tabcorr_list[0].tpcf_shape)
    assert torch.isfinite(xi).all() and torch.isfinite(ngal).all()
    with pytest.raises(ValueError, match="float32"):
        ttt.make_predictor(interp, model, engine="fused",
                           dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="Unknown engine"):
        ttt.make_predictor(interp, model, engine="xla", device="cpu")
    with pytest.raises(TypeError):
        ttt.make_predictor(object(), model, device="cpu")


def test_grid64_builder_equals_the_jax_bench_builder():
    sys.path.insert(0, str(ROOT / "scripts"))
    from bench_grid import build_interpolator

    want = build_interpolator()
    got = grid64_interpolator()
    assert got.keys == want.keys == ["alpha_c", "alpha_s", "log_eta"]
    for k in want.param_dict_table.colnames:
        np.testing.assert_array_equal(got.param_dict_table[k],
                                      want.param_dict_table[k])
    assert len(got.tabcorr_list) == len(want.tabcorr_list) == 64
    for a, b in zip(got.tabcorr_list, want.tabcorr_list):
        np.testing.assert_array_equal(a.tpcf_matrix, b.tpcf_matrix)
        assert a.tpcf_shape == tuple(b.tpcf_shape) == (3, 14)
        assert a.attrs == b.attrs
        np.testing.assert_array_equal(a.gal_type.as_structured_array(),
                                      b.gal_type.as_structured_array())
