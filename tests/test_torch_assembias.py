"""The port's decorated HOD (AssembiasZheng07Model) against tabcorr_tpu.

* the decoration ``heaviside_assembias`` and the decorated occupation over
  strengths -1.3...1.3 (the clip included) and percentiles including the
  knife edge at the split, in float32 and float64;
* the float64 host ``TabCorr.predict`` / ``Interpolator.predict`` on the
  xi_ell and 'efficient' Delta Sigma fixtures (rtol 1e-10);
* the plain versions of the kernels that take the decorated model: the
  bundle (B1, ``make_multi_predictor`` on wp + xi_ell) against tabcorr_tpu's
  bundle in interpret mode and the float64 host path (wp 1e-6 relative,
  xi_ell 1e-6 scaled); ``make_predictor(tab, engine="fused")`` (B3) and the
  fused Interpolator route on Delta Sigma (B2) against tabcorr_tpu with
  test_torch_grid.py's tolerances (ngal 1e-6 relative, xi 2e-6 scaled)
  and float64;
* the kernel dispatch: only the exact types the kernels evaluate reach
  them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu.ops.fused as jax_fused
import tabcorr_tpu.predictor as jax_pred
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.models.assembias import \
    heaviside_assembias as jax_heaviside_assembias
from tabcorr_tpu_torch import predictor
from tabcorr_tpu_torch.ops import fused

from conftest import DATA_DIR
from test_torch_grid import FIXTURES, _scaled
from test_torch_models import _tolerance

STRENGTHS = ("mean_occupation_centrals_assembias_param1",
             "mean_occupation_satellites_assembias_param1")
NAMES = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha") + STRENGTHS
TABLES = {"wp": "bolplanck_wp", "xi": "synthetic_xi_ell"}
EPS32 = 2.0 ** -24


@pytest.fixture(scope="module")
def tabs():
    return {k: (tt.TabCorr.read(DATA_DIR / "examples" / f"{f}.hdf5"),
                ttt.TabCorr.read(DATA_DIR / "examples" / f"{f}.hdf5"))
            for k, f in TABLES.items()}


def _params(batch, seed, threshold=-18, strength_box=(-1.0, 1.0)):
    """float32 parameters around the zheng07 threshold values (bench.py's
    spread) with strengths drawn uniformly from ``strength_box``."""
    rng = np.random.default_rng(seed)
    base = ttt.Zheng07Model(threshold=threshold).param_dict
    spread = {"logMmin": 0.1, "sigma_logM": 0.01, "logM0": 0.1,
              "logM1": 0.1, "alpha": 0.02}
    p = {k: base[k] + s * rng.normal(size=batch) for k, s in spread.items()}
    for name in STRENGTHS:
        p[name] = rng.uniform(*strength_box, batch)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.tensor(v) for k, v in params.items()})


def _host_model(model, params, i):
    m = ttt.AssembiasZheng07Model(threshold=model.threshold,
                                  redshift=model.redshift,
                                  prim_haloprop_key=model.prim_haloprop_key)
    m.param_dict.update({k: float(v[i]) for k, v in params.items()})
    return m


# ----------------------------------------------------------------------
# The decoration and the decorated occupation
# ----------------------------------------------------------------------
@pytest.mark.parametrize("split", [0.5, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_heaviside_assembias_matches_jax(dtype, split):
    rng = np.random.default_rng(1)
    # Axes: strength, percentile, base occupation.
    strength = np.concatenate([np.linspace(-1.3, 1.3, 27), [-1.0, 1.0, 0.0]])
    # Percentiles: bin midpoints, the split itself and the knife edge
    # around it (within and beyond the 1e-6 tolerance).
    sec = np.array([0.05, 0.2495, 0.7505, split, split - 6e-17,
                    split - 5e-7, split - 2e-6, split + 1e-7, 0.95])
    cen = np.concatenate([[0.0, 1.0, 1.0 - 1e-7], rng.uniform(0, 1, 13)])
    sat = 10.0 ** rng.uniform(-6, 2, 16)
    a = strength[:, None, None].astype(dtype)
    s = sec[None, :, None].astype(dtype)
    for base, upper in ((cen[None, None], 1.0), (sat[None, None], None)):
        b = base.astype(dtype)
        want = np.asarray(jax_heaviside_assembias(
            jnp.asarray(b), jnp.asarray(a), jnp.asarray(s), split=split,
            upper_bound=upper))
        got = ttt.heaviside_assembias(
            torch.tensor(b), torch.tensor(a), torch.tensor(s), split=split,
            upper_bound=upper).numpy()
        host = ttt.heaviside_assembias(base, strength[:, None, None],
                                       sec[None, :, None], split=split,
                                       upper_bound=upper)
        assert got.dtype == np.dtype(dtype)
        assert got.shape == (strength.size, sec.size, base.size)
        # Both packages evaluate the same expressions: a few ulp of the
        # undecorated occupation apart (the knife edge classified alike).
        eps = EPS32 if dtype == "float32" else 2.0 ** -53
        assert np.all(np.abs(got - want) <= 4 * eps * (1 + 2 * base))
        assert np.all(np.abs(got - host) <= 8 * eps * (1 + 2 * base))
        # The clip, and the bounds for |A| <= 1 (to rounding).
        assert np.all(got >= -4 * eps * base)
        assert upper is None or np.all(got <= 1 + 4 * eps)
        np.testing.assert_array_equal(got[strength > 1],
                                      np.broadcast_to(got[-2], got[
                                          strength > 1].shape))   # A = 1
        # The knife edge: up to 1e-6 below the split counts as above
        # (occupation raised for A > 0), 2e-6 below as below.
        live = (b[0, 0] > 1e-3) & (b[0, 0] < 1 - 1e-3 if upper else True)
        up = got[strength > 0.1][..., live]
        bb = b[0, 0, live]
        assert np.all(up[:, 3:6] > bb) and np.all(up[:, 6] < bb)


@pytest.mark.parametrize("gal_type", ["centrals", "satellites"])
@pytest.mark.parametrize("residual", [False, True])
def test_decorated_occupation_matches_jax_and_float64(tabs, gal_type,
                                                      residual):
    # The xi_ell table's nodes (percentile midpoints 0.2495 and 0.7505).
    jax_tab, tab = tabs["xi"]
    table = tab.table_data(device="cpu")
    jax_table = jax_tab.table_data(n_gauss=10, dtype=jnp.float32)
    nc = table.n_centrals
    rows = slice(0, nc) if gal_type == "centrals" else slice(nc, None)
    node = table.log_prim_quad[rows]
    res = table.log_prim_quad_lo[rows]
    sec = table.sec_perc[rows, None].expand_as(node)
    assert set(np.unique(sec.numpy())) == {np.float32(0.2495),
                                           np.float32(0.7505)}
    params = _params(16, 3, strength_box=(-1.3, 1.3))
    p_jax, p = _both(params)
    p = {k: v[:, None, None] for k, v in p.items()}
    p_jax = {k: v[:, None, None] for k, v in p_jax.items()}
    model = ttt.AssembiasZheng07Model(threshold=-18)
    jax_model = tt.AssembiasZheng07Model(threshold=-18)
    if residual:
        got = model.occupation_residual(p, gal_type, node, res, sec)
        want = jax_model.occupation_residual(
            p_jax, gal_type, jax_table.log_prim_quad[rows],
            jax_table.log_prim_quad_lo[rows], jnp.asarray(sec.numpy()))
        node64 = node.double().numpy() + res.double().numpy()
    else:
        got = model.occupation(p, gal_type, node, sec)
        want = jax_model.occupation(p_jax, gal_type,
                                    jax_table.log_prim_quad[rows],
                                    jnp.asarray(sec.numpy()))
        node64 = node.double().numpy()
    assert got.dtype == torch.float32 and got.shape == (16,) + node.shape
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    # float64 oracle at the float32 parameters and the exact nodes.
    p64 = {k: np.asarray(v, np.float64)[:, None, None]
           for k, v in params.items()}
    sec64 = np.asarray(sec.numpy(), np.float64)
    base64 = ttt.Zheng07Model(threshold=-18).occupation(
        p64, gal_type, node64, sec64)
    oracle = model.occupation(p64, gal_type, node64, sec64)
    # Errors are relative to the undecorated occupation: decorated values
    # near 0 (A -> -1) keep the absolute error of their base.
    scale = 3.0 * np.abs(base64) + 1e-30
    tol = _tolerance(gal_type, p64, node64)
    live = base64 > 1e-30
    for a in (got, want):
        assert np.all((np.abs(a - oracle) / scale)[live] <= tol[live])
    assert np.all((np.abs(got - want) / scale)[live] <= 2 * tol[live])


def test_assembias_model_parameters_and_exports():
    model = ttt.AssembiasZheng07Model(threshold=-21, split=0.3)
    assert model.split == 0.3 and model.sec_haloprop_key == "halo_nfw_conc"
    assert tuple(model.param_dict) == tuple(tt.AssembiasZheng07Model(
        threshold=-21).param_dict)
    assert model.kernel_param_names == NAMES
    assert ttt.Zheng07Model.kernel_param_names == NAMES[:5]
    assert issubclass(ttt.AssembiasZheng07Model, ttt.HeavisideAssembiasMixin)
    assert ttt.models.ASSEMBIAS_PARAMS == STRENGTHS


# ----------------------------------------------------------------------
# The float64 host path
# ----------------------------------------------------------------------
def _ds_models(strength):
    out = []
    for pkg in (tt, ttt):
        m = pkg.AssembiasZheng07Model(
            threshold=-21, redshift=0.5, prim_haloprop_key="halo_m258m")
        m.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
        for name in STRENGTHS:
            m.param_dict[name] = strength
        out.append(m)
    return out


@pytest.mark.parametrize("strength", [-0.9, 0.0, 0.8])
def test_host_predict_matches_jax(tabs, strength):
    jax_tab, tab = tabs["xi"]
    jax_model = tt.AssembiasZheng07Model(threshold=-18, redshift=0.0)
    model = ttt.AssembiasZheng07Model(threshold=-18, redshift=0.0)
    for m in (jax_model, model):
        m.param_dict[STRENGTHS[0]] = strength
        m.param_dict[STRENGTHS[1]] = -0.5 * strength
    ng_j, xi_j = jax_tab.predict(jax_model, check_consistency=False)
    ng, xi = tab.predict(model, check_consistency=False)
    np.testing.assert_allclose(xi, xi_j, rtol=1e-10)
    assert abs(ng / ng_j - 1) <= 1e-10
    # ds_efficient: one node and the whole Interpolator.
    jax_interp = tt.Interpolator.read(FIXTURES["ds"])
    interp = ttt.Interpolator.read(FIXTURES["ds"])
    jax_model, model = _ds_models(strength)
    for a, b in ((jax_interp.tabcorr_list[0], interp.tabcorr_list[0]),
                 (jax_interp, interp)):
        (ng_j, ds_j), (ng, ds) = (a.predict(jax_model,
                                            check_consistency=False),
                                  b.predict(model, check_consistency=False))
        np.testing.assert_allclose(ds, ds_j, rtol=1e-10)
        assert abs(ng / ng_j - 1) <= 1e-10


def test_decoration_moves_the_predictions(tabs):
    # As tabcorr_tpu's test_assembias_changes_predictions: the number
    # density is nearly conserved, the clustering shifts.
    interp = ttt.Interpolator.read(FIXTURES["ds"])
    (_, m0), (_, m8) = _ds_models(0.0), _ds_models(0.8)
    ng0, ds0 = interp.tabcorr_list[0].predict(m0, check_consistency=False)
    ng8, ds8 = interp.tabcorr_list[0].predict(m8, check_consistency=False)
    assert np.isclose(ng0, ng8, rtol=1e-3)
    assert _scaled(ds8[None], ds0[None]) > 1e-4
    # The same through the bundle's plain version on xi_ell.
    model = ttt.AssembiasZheng07Model(threshold=-18)
    predict = ttt.make_multi_predictor([tabs["xi"][1]], model, device="cpu")
    params = {k: torch.tensor(v) for k, v in _params(4, 2).items()}
    xi = predict(params)[0][1]
    for name in STRENGTHS:
        params[name] = torch.zeros(4)
    assert _scaled(xi.numpy(), predict(params)[0][1].numpy()) > 1e-4


# ----------------------------------------------------------------------
# The plain versions of the kernels, decorated
# ----------------------------------------------------------------------
def _error(stat, got, want):
    got, want = np.ravel(got), np.ravel(want)
    if stat == "wp":
        return float(np.max(np.abs(got - want) / np.abs(want)))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_decorated_bundle_plain_matches_jax_bundle_and_float64(tabs):
    stats = ("wp", "xi")
    accuracy = ("elementwise", "scaled")
    params = _params(13, 5)
    jax_model = tt.AssembiasZheng07Model(threshold=-18, redshift=0.0)
    jax_fn = jax_fused.make_fused_bundle_predictor(
        [tabs[s][0].table_data(n_gauss=10, dtype=jnp.float32) for s in stats],
        *jax_pred.occupation_functions(jax_model), NAMES, batch_tile=8,
        interpret=True, accuracy=accuracy)
    p_jax, p = _both(params)
    jax_out = jax_fn(p_jax)
    model = ttt.AssembiasZheng07Model(threshold=-18, redshift=0.0)
    predict = ttt.make_multi_predictor([tabs[s][1] for s in stats], model,
                                       device="cpu", accuracy=accuracy)
    before = fused.BUNDLE_LAUNCHES
    port_out = predict(p)
    assert fused.BUNDLE_LAUNCHES == before
    for s, (ng_j, xi_j), (ng_p, xi_p) in zip(stats, jax_out, port_out):
        assert xi_p.shape == (13,) + tabs[s][1].tpcf_shape
        for i in range(13):
            ng64, xi64 = tabs[s][1].predict(_host_model(model, params, i),
                                            check_consistency=False)
            got, jax_got = xi_p[i].double().numpy(), np.asarray(xi_j[i],
                                                               np.float64)
            assert _error(s, got, xi64) <= 1e-6, (s, i)
            assert _error(s, jax_got, xi64) <= 1e-6, (s, i)
            assert _error(s, got, jax_got) <= 1e-6, (s, i)
            assert abs(float(ng_p[i]) / ng64 - 1) <= 1e-6, (s, i)
            assert abs(float(ng_j[i]) / float(ng_p[i]) - 1) <= 1e-6, (s, i)


def test_decorated_fused_tabcorr_predictor_matches_jax(tabs):
    jax_tab, tab = tabs["xi"]
    params = _params(8, 6)
    jax_model = tt.AssembiasZheng07Model(threshold=-18, redshift=0.0)
    jax_f = jax_fused.make_fused_predictor(
        jax_tab.table_data(n_gauss=10, dtype=jnp.float32),
        *jax_pred.occupation_functions(jax_model), batch_tile=8,
        interpret=True)
    model = ttt.AssembiasZheng07Model(threshold=-18, redshift=0.0)
    f = ttt.make_predictor(tab, model, engine="fused", device="cpu")
    p_jax, p = _both(params)
    ng_j, xi_j = (np.asarray(a, np.float64) for a in jax_f(p_jax))
    ng, xi = (a.double().numpy() for a in f(p))
    assert xi.shape == (8, 3, 14)
    np.testing.assert_allclose(ng, ng_j, rtol=1e-6)
    assert _scaled(xi, xi_j) <= 2e-6
    for i in range(8):
        ng64, xi64 = tab.predict(_host_model(model, params, i),
                                 check_consistency=False)
        assert _scaled(xi[i:i + 1], xi64[None]) <= 1e-6, i
        assert abs(ng[i] / ng64 - 1) <= 1e-6


def test_decorated_fused_interpolator_matches_jax(monkeypatch):
    jax_interp = tt.Interpolator.read(FIXTURES["ds"])
    interp = ttt.Interpolator.read(FIXTURES["ds"])
    jax_model, model = _ds_models(0.0)
    # tabcorr_tpu's streamed route (the packed grid kernel this port's B2
    # replaces), in interpret mode with a small batch tile.
    monkeypatch.setattr(jax_pred, "_fused_constants_fit_vmem",
                        lambda *a, **k: False)
    make_grid = jax_fused.make_fused_grid_predictor
    monkeypatch.setattr(jax_fused, "make_fused_grid_predictor",
                        lambda *a, **k: make_grid(*a, batch_tile=8, **k))
    jax_f = jax_pred.make_predictor(jax_interp, jax_model, engine="fused",
                                    accuracy="scaled")
    f = ttt.make_predictor(interp, model, engine="fused", accuracy="scaled",
                           device="cpu")
    params = _params(6, 9, threshold=-21)
    params["log_eta"] = np.array([0.0, -0.3, 0.2, 0.1, -0.46, 0.9],
                                 np.float32)
    p_jax, p = _both(params)
    for k, v in model.param_dict.items():
        p.setdefault(k, torch.full((6,), v))
        p_jax.setdefault(k, jnp.full((6,), v, jnp.float32))
    before = fused.GRID_LAUNCHES
    ng_j, xi_j = (np.asarray(a, np.float64) for a in jax_f(p_jax))
    ng, xi = (a.double().numpy() for a in f(p))
    assert fused.GRID_LAUNCHES == before
    assert xi.shape == xi_j.shape == (6, 13)
    # Row 5 lies outside the grid: NaN in both packages.
    assert np.isnan(ng[5]) and np.isnan(ng_j[5])
    assert np.all(np.isnan(xi[5])) and np.all(np.isnan(xi_j[5]))
    np.testing.assert_allclose(ng[:5], ng_j[:5], rtol=1e-6)
    assert _scaled(xi[:5], xi_j[:5]) <= 2e-6
    for i in range(4):
        m = _host_model(model, {k: v.numpy() for k, v in p.items()}, i)
        ng64, xi64 = interp.predict(m, check_consistency=False)
        assert _scaled(xi[i:i + 1], xi64[None]) <= 1e-6, i
        assert abs(ng[i] / ng64 - 1) <= 1e-6


# ----------------------------------------------------------------------
# Dispatch: which models reach the kernels
# ----------------------------------------------------------------------
class _Subclassed(ttt.Zheng07Model):
    """A zheng07 subclass whose occupation the kernels do not know."""

    def occupation(self, params, gal_type, log_prim, sec):
        return 2.0 * super().occupation(params, gal_type, log_prim, sec)

    def occupation_residual(self, params, gal_type, log_prim, res, sec):
        return 2.0 * super().occupation_residual(params, gal_type, log_prim,
                                                 res, sec)


class _DecoratedSubclass(ttt.AssembiasZheng07Model):
    pass


def test_kernel_model_dispatches_on_the_exact_type(tabs):
    assert fused.kernel_model(ttt.Zheng07Model()) == 0
    assert fused.kernel_model(ttt.AssembiasZheng07Model()) == 1
    # Any other fused-engine model, subclasses of the two included, reaches
    # the kernels through its densities (code 2), never through code 0 or
    # 1, which would ignore what the subclass changed.
    for other in (_Subclassed(), _DecoratedSubclass(), ttt.HodModel(),
                  tt.Zheng07Model()):
        assert fused.kernel_model(other) == fused.DENSITY_IN
        assert fused.KernelModel.of(other) == fused.KernelModel(code=2)
        assert fused.KernelModel.of(other).param_names == ()
    decorated = ttt.AssembiasZheng07Model(split=0.4,
                                          modulate_with_cenocc=True)
    hod = fused.KernelModel.of(decorated)
    assert (hod.code, hod.modulate, hod.split) == (1, True, 0.4)
    assert hod.param_names == NAMES
    assert fused.KernelModel.of(ttt.Zheng07Model()).param_names == NAMES[:5]
    # 'auto' routes every fused-engine model to the grid or slab kernels.
    interp = ttt.Interpolator.read(FIXTURES["ds"])
    assert predictor._fused_kernel_takes(interp)
    # The plain version of a code-2 launch: the subclass's doubled
    # occupation shows in ngal.
    table = tabs["wp"][1].table_data(device="cpu")
    params = {k: torch.tensor(v[:3]) for k, v in _params(3, 1).items()
              if k in NAMES[:5]}
    ng_sub = fused.make_fused_bundle_predictor([table], _Subclassed())(
        params)[0][0]
    ng = fused.make_fused_bundle_predictor([table], ttt.Zheng07Model())(
        params)[0][0]
    torch.testing.assert_close(ng_sub, 2.0 * ng, rtol=1e-6, atol=0)
