"""The slab kernel's plain version and the wide-grid Interpolator route
against tabcorr_tpu.

Small synthetic grids (3-4 nodes sharing one binning of 8-12 primary x
1-2 secondary bins per galaxy type, 3-5 statistic rows) go through the
port's plain version of the slab kernel (B4) and through tabcorr_tpu's
slab kernel in Pallas interpret mode, at B = 8 and a ragged B = 5, auto
and cross mode, zheng07 and the assembly-bias decorated model.
Tolerances are test_torch_grid.py's: ngal 1e-6 relative, per-node xi 2e-6
of each row's largest element.  A wide Interpolator (128 bins, too many
for the packed layout) goes through ``make_predictor(engine="fused")``
against tabcorr_tpu's streamed route and the float64 host path (scaled
<= 1e-6), with its out-of-grid rows NaN.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu.ops.fused as jax_fused
import tabcorr_tpu.predictor as jax_pred
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.io import ColumnTable as JaxColumnTable
from tabcorr_tpu_torch.io import ColumnTable
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.utils.synthetic import wide_grid_interpolator

from test_bundle_shapes import synthetic_tabcorr
from test_grid_stream import _grid_tabs, _stack
from test_torch_grid import _both, _params, _port_stack, _port_tab, _scaled

STRENGTHS = ("mean_occupation_centrals_assembias_param1",
             "mean_occupation_satellites_assembias_param1")


def _models(kind):
    if kind == "zheng07":
        return (tt.Zheng07Model(threshold=-20, redshift=0.0),
                ttt.Zheng07Model(threshold=-20, redshift=0.0))
    return (tt.AssembiasZheng07Model(threshold=-20, redshift=0.0),
            ttt.AssembiasZheng07Model(threshold=-20, redshift=0.0))


def _model_params(kind, batch, seed):
    params = _params(batch, seed)
    if kind != "zheng07":
        rng = np.random.default_rng(seed + 100)
        for name in STRENGTHS:
            params[name] = rng.uniform(-1.0, 1.0, batch)
    return params


@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
@pytest.mark.parametrize("mode", ["auto", "cross"])
@pytest.mark.parametrize("batch", [8, 5])
def test_slab_plain_matches_jax_slab_kernel(kind, mode, batch):
    n_nodes, n_xi = (4, 5) if mode == "auto" else (3, 4)
    tabs = _grid_tabs(n_nodes, 12 if mode == "auto" else 10, 2, n_xi, mode,
                      seed=13)
    jax_model, model = _models(kind)
    jax_f = jax_fused.make_fused_grid_predictor(
        _stack(tabs), n_nodes, *jax_pred.occupation_functions(jax_model),
        tuple(jax_model.param_dict), batch_tile=8, interpret=True,
        layout="slab")
    f = fused.make_fused_grid_predictor(_port_stack(tabs), n_nodes, model,
                                        layout="slab")
    p_jax, p = _both(_model_params(kind, batch, 7))
    before = fused.SLAB_LAUNCHES
    (ng_j, xi_j), (ng, xi) = jax_f(p_jax), f(p)
    assert fused.SLAB_LAUNCHES == before    # CPU tensors: no launch
    assert xi.dtype == ng.dtype == torch.float32
    ng_j, xi_j = np.asarray(ng_j, np.float64), np.asarray(xi_j, np.float64)
    ng, xi = ng.double().numpy(), xi.double().numpy()
    assert xi.shape == xi_j.shape == (batch, n_nodes, n_xi)
    np.testing.assert_allclose(ng, ng_j, rtol=1e-6)
    assert _scaled(xi.reshape(-1, n_xi), xi_j.reshape(-1, n_xi)) <= 2e-6


@pytest.mark.parametrize("mode", ["auto", "cross"])
def test_slab_plain_is_independent_of_the_chunk(monkeypatch, mode):
    tabs = _grid_tabs(3, 10, 1, 4, mode, seed=3)
    s = fused.slab_table_constants(_port_stack(tabs), 3)
    occ = ttt.occupation_functions(ttt.Zheng07Model(threshold=-20))
    p = _both(_params(11, 4))[1]
    whole = fused.slab_predict_plain(s, p, *occ)
    monkeypatch.setattr(fused, "_PLAIN_CHUNK", 4)
    chunked = fused.slab_predict_plain(s, p, *occ)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["auto", "cross"])
def test_slab_constants_hold_every_node_matrix(mode):
    n_nodes, n_xi = 3, 4
    stacked = _port_stack(_grid_tabs(n_nodes, 5, 1, n_xi, mode, seed=2))
    s = fused.slab_table_constants(stacked, n_nodes)
    nb = stacked.n_bins
    dense = stacked.tpcf_dense.numpy().reshape(
        (n_nodes, n_xi) + tuple(stacked.tpcf_dense.shape[1:]))
    f_t = s.f_t.numpy()
    assert s.k_pad % 32 == 0 and s.c_pad % 128 == 0 and s.nbp % 4 == 0
    for m in range(n_nodes):
        for k in range(n_xi):
            if mode == "auto":
                got = f_t[m, :nb, k * s.nbp:k * s.nbp + nb]   # [j, i]
                np.testing.assert_array_equal(got, dense[m, k].T)
            else:
                np.testing.assert_array_equal(f_t[m, :nb, k], dense[m, k])
    # Everything else is zero padding.
    assert np.count_nonzero(f_t) == np.count_nonzero(dense)


def test_slab_layout_refuses_the_fold_and_the_cpu_launch():
    tabs = _grid_tabs(2, 8, 1, 3, "auto", seed=1)
    stacked = _port_stack(tabs)
    model = ttt.Zheng07Model(threshold=-20)
    with pytest.raises(ValueError, match="packed"):
        fused.make_fused_grid_predictor(stacked, 2, model, layout="slab",
                                        fold_spline=True)
    with pytest.raises(ValueError, match="packed"):
        jax_fused.make_fused_grid_predictor(
            _stack(tabs), 2, *jax_pred.occupation_functions(
                tt.Zheng07Model(threshold=-20)),
            tuple(model.param_dict), interpret=True, layout="slab",
            fold_spline=True)
    # The kernel takes CUDA tensors only, whatever the layout.
    for constants in (fused.slab_tc_table_constants,
                      fused.slab_table_constants):
        with pytest.raises(ValueError, match="CUDA"):
            fused.slab_launch(constants(stacked, 2), torch.ones((4, 5)))
    assert fused.grid_kernel_takes(160, "auto", 42)
    assert not fused.grid_kernel_takes(1000, "auto", 42)
    assert not fused.grid_fits(160, "auto", 42)


def _wide_interpolators(n_xi=3):
    """4 log_eta nodes of one 128-bin binning (64 primary x 1 secondary
    bins per galaxy type), in both packages."""
    jax_tabs = []
    for j in range(4):
        t = synthetic_tabcorr(np.random.default_rng(5), 64, 1, n_xi, "auto")
        t.tpcf_matrix = t.tpcf_matrix * (1.0 + 0.1 * np.random.default_rng(
            50 + j).normal(size=t.tpcf_matrix.shape))
        jax_tabs.append(t)
    eta = [-0.4, -0.1, 0.2, 0.4]
    return (tt.Interpolator(jax_tabs, JaxColumnTable({"log_eta": eta})),
            ttt.Interpolator([_port_tab(t) for t in jax_tabs],
                             ColumnTable({"log_eta": eta})))


@pytest.mark.parametrize("kind", ["zheng07", "assembias"])
def test_wide_interpolator_takes_the_slab_route(monkeypatch, kind):
    jax_interp, interp = _wide_interpolators()
    stacked = ttt.predictor.stacked_grid(interp, device="cpu")[0]
    assert stacked.n_bins == 128
    assert fused.grid_layout_for(stacked) == "slab"
    jax_model, model = _models(kind)
    for m in (jax_model, model):
        m.param_dict["log_eta"] = 0.0
    # tabcorr_tpu's streamed route, in interpret mode with a small tile.
    monkeypatch.setattr(jax_pred, "_fused_constants_fit_vmem",
                        lambda *a, **k: False)
    make_grid = jax_fused.make_fused_grid_predictor
    monkeypatch.setattr(jax_fused, "make_fused_grid_predictor",
                        lambda *a, **k: make_grid(*a, batch_tile=8, **k))
    jax_f = jax_pred.make_predictor(jax_interp, jax_model, engine="fused",
                                    accuracy="scaled")
    f = ttt.make_predictor(interp, model, engine="fused", accuracy="scaled",
                           device="cpu")
    params = _model_params(kind, 5, 9)
    params["log_eta"] = np.array([0.0, -0.3, 0.55, 0.25, -0.45])
    p_jax, p = _both(params)
    for k, v in model.param_dict.items():
        p.setdefault(k, torch.full((5,), v))
        p_jax.setdefault(k, jnp.full((5,), v, jnp.float32))
    before = fused.SLAB_LAUNCHES
    ng_j, xi_j = (np.asarray(a, np.float64) for a in jax_f(p_jax))
    ng, xi = (a.double().numpy() for a in f(p))
    assert fused.SLAB_LAUNCHES == before
    assert xi.shape == xi_j.shape == (5, 3)
    # Rows 2 and 4 lie outside the grid: NaN in both packages, in ngal and
    # every xi; no other row holds a NaN.
    out = np.array([False, False, True, False, True])
    for a, b in ((ng, ng_j), (xi, xi_j)):
        assert np.all(np.isnan(a[out])) and np.all(np.isnan(b[out]))
        assert np.all(np.isfinite(a[~out])) and np.all(np.isfinite(b[~out]))
    np.testing.assert_allclose(ng[~out], ng_j[~out], rtol=1e-6)
    assert _scaled(xi[~out], xi_j[~out]) <= 2e-6
    for i in np.flatnonzero(~out):
        m = type(model)(threshold=-20, redshift=0.0)
        m.param_dict.update({k: float(v[i]) for k, v in p.items()})
        ng64, xi64 = interp.predict(m, check_consistency=False)
        assert _scaled(xi[i:i + 1], xi64[None]) <= 1e-6, i
        assert abs(ng[i] / ng64 - 1) <= 1e-6


def test_wide_grid_builder_equals_the_jax_draws():
    # The JAX package has no wide-grid builder; its arrays come from the
    # same draws as scripts/bench_grid.py's, with two secondary bins.
    defaults = inspect.signature(wide_grid_interpolator).parameters
    n_prim, n_sec = defaults["n_prim"].default, defaults["n_sec"].default
    assert 2 * n_prim * n_sec == 160
    assert defaults["n_nodes"].default == 64
    got = wide_grid_interpolator(n_xi=3)
    for j, a in enumerate(got.tabcorr_list):
        b = synthetic_tabcorr(np.random.default_rng(42), n_prim, n_sec, 3,
                              "auto")
        b.tpcf_matrix = b.tpcf_matrix * (1.0 + 0.1 * np.random.default_rng(
            1000 + j).normal(size=b.tpcf_matrix.shape))
        np.testing.assert_array_equal(a.tpcf_matrix, b.tpcf_matrix)
        np.testing.assert_array_equal(a.gal_type.as_structured_array(),
                                      b.gal_type.as_structured_array())
        assert a.tpcf_shape == (3, 1) and a.n_bins == 160
    assert sorted(np.unique(a.gal_type["sec_haloprop_percentile"])) == \
        [0.25, 0.75]
    side = np.linspace(0, .4, 4), np.linspace(.8, 1.2, 4), np.linspace(
        -.4, .4, 4)
    want = np.meshgrid(*side, indexing="ij")
    for key, w in zip(("alpha_c", "alpha_s", "log_eta"), want):
        np.testing.assert_array_equal(got.param_dict_table[key], w.ravel())
