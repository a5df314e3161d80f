"""The HOD families through the port's fused routes on the CPU, against
tabcorr_tpu's float32 kernels in Pallas interpret mode, and the routing
by ``supports_fused_engine``.

On the CPU every fused route of a family runs the kernels' plain versions
on the densities the card's kernels read (model code 2: the occupation in
tensor ops, then the contraction).  tabcorr_tpu's kernels evaluate the
same occupations in-kernel (its SHMR inversion seeded by bisection there).
Tolerances are tabcorr_tpu's own for its fused engines against its XLA
engine (tests/test_models.py, tests/test_tinker13.py): ngal 2e-5
relative, xi 1e-4 relative plus 2e-6 of the largest |xi|.  Against the
port's float64 host path at a few rows, each route's ngal and wp
relative (xi scaled) errors are at most max(1e-6, twice the same reading
of the port's plain float32 engine): the float32 SHMR inversion and the
CLF satellites do not reach 1e-6 by themselves.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu.ops.fused as jax_fused
import tabcorr_tpu.predictor as jax_pred
import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch import predictor
from tabcorr_tpu_torch.ops import fused

from conftest import DATA_DIR
from test_torch_families import ASSEMBIAS, draw, port_model_of
from test_torch_slab import _wide_interpolators

WP = DATA_DIR / "examples" / "bolplanck_wp.hdf5"
XI_INTERP = DATA_DIR / "examples" / "synthetic_xi_ell_interp.hdf5"


def _assert_family_close(got, want):
    """tabcorr_tpu's fused-vs-XLA bar: ngal 2e-5, xi 1e-4 + 2e-6 max|xi|,
    NaN rows alike."""
    (ng, xi), (ng_j, xi_j) = got, want
    ng, xi = ng.double().numpy(), xi.double().numpy()
    ng_j, xi_j = np.asarray(ng_j, np.float64), np.asarray(xi_j, np.float64)
    assert xi.shape == xi_j.shape
    np.testing.assert_array_equal(np.isnan(ng), np.isnan(ng_j))
    np.testing.assert_array_equal(np.isnan(xi), np.isnan(xi_j))
    ok = ~np.isnan(ng)
    np.testing.assert_allclose(ng[ok], ng_j[ok], rtol=2e-5)
    np.testing.assert_allclose(xi[ok], xi_j[ok], rtol=1e-4,
                               atol=2e-6 * np.max(np.abs(xi_j[ok])))


def _scaled(got, want):
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    return float(np.max(np.max(np.abs(got - want), axis=1) /
                        np.max(np.abs(want), axis=1)))


def _host_copy(model, params, i):
    """A copy of the port's ``model`` at row ``i`` of ``params``."""
    m = copy.copy(model)
    m.param_dict = dict(model.param_dict)
    m.param_dict.update({k: float(v[i]) for k, v in params.items()})
    return m


def _errors_vs_float64(outs, host, rows, per_element):
    """Max over ``rows`` of each output's (ngal relative, xi relative per
    element or scaled) error against ``host(i) -> (ngal, xi)``."""
    errs = [[0.0, 0.0] for _ in outs]
    for i in rows:
        ng64, xi64 = host(i)
        xi64 = np.ravel(xi64)
        for e, (ng, xi) in zip(errs, outs):
            x = xi[i].double().numpy().ravel()
            e[0] = max(e[0], abs(float(ng[i]) / ng64 - 1))
            e[1] = max(e[1], float(
                np.max(np.abs(x / xi64 - 1)) if per_element else
                np.max(np.abs(x - xi64)) / np.max(np.abs(xi64))))
    return errs


def _assert_as_close_as_plain(route, plain, host, rows, per_element=False):
    """The route's errors against float64 are at most max(1e-6, twice the
    plain float32 engine's)."""
    got, base = _errors_vs_float64([route, plain], host, rows, per_element)
    for e, b in zip(got, base):
        assert e <= max(1e-6, 2.0 * b), (got, base)


def _both_params(model, batch, seed):
    p = draw(model, batch, seed)
    return ({k: jnp.asarray(v, jnp.float32) for k, v in p.items()},
            {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()})


BUNDLE_FAMILIES = {
    "leauthaud11": lambda m, z: m.Leauthaud11Model(threshold=10.5,
                                                   redshift=z),
    "zu15": lambda m, z: m.ZuMandelbaum15Model(
        threshold=10.5, prim_haloprop_key="halo_mvir"),
    "tinker13": lambda m, z: m.Tinker13Model(threshold=10.5, redshift=z),
}


@pytest.mark.parametrize("family", list(BUNDLE_FAMILIES))
def test_bundle_route_matches_jax_bundle_kernel(wp_tabcorr, family):
    z = float(wp_tabcorr.attrs["redshift"])
    jax_model = BUNDLE_FAMILIES[family](tt, z)
    model = port_model_of(jax_model)
    tab = ttt.TabCorr.read(WP)
    jax_f = jax_pred.make_multi_predictor([wp_tabcorr], jax_model,
                                          engine="bundle", batch_tile=8)
    f = ttt.make_multi_predictor([tab], model, device="cpu")
    p_jax, p = _both_params(model, 8, 1)
    before = fused.BUNDLE_LAUNCHES
    [(ng, xi)] = f(p)
    assert fused.BUNDLE_LAUNCHES == before           # CPU: no launch
    assert ng.dtype == xi.dtype == torch.float32
    _assert_family_close((ng, xi), jax_f(p_jax)[0])
    # The port's plain engine (its own quadrature) and the float64 host
    # path at the float32 parameters.
    [(ng_p, xi_p)] = ttt.make_multi_predictor([tab], model, device="cpu",
                                              engine="plain")(p)
    torch.testing.assert_close(ng, ng_p, rtol=1e-6, atol=0)
    assert _scaled(xi, xi_p) <= 1e-6
    _assert_as_close_as_plain(
        (ng, xi), (ng_p, xi_p), lambda i: tab.predict(
            _host_copy(model, p, i), check_consistency=False), range(4),
        per_element=True)


@pytest.mark.parametrize("family", ["cacciato09", "tinker13 quiescent"])
def test_contraction_route_matches_jax_fused_engine(monkeypatch, wp_tabcorr,
                                                    family):
    # make_predictor(tab, engine="fused"): the occupation in tensor ops,
    # then the contraction kernel (B3).  tabcorr_tpu's fused engine runs
    # its occupation in XLA, then its contraction kernel in interpret mode;
    # for Tinker13 its bundle kernel instead (with float64 enabled, as in
    # these tests, its spline's float64 coefficients promote the XLA
    # occupation to float64, which its contraction kernel refuses).
    z = float(wp_tabcorr.attrs["redshift"])
    jax_model = {"cacciato09": tt.Cacciato09Model(
        threshold=10.0, prim_haloprop_key="halo_mvir"),
        "tinker13 quiescent": tt.Tinker13Model(
            threshold=10.5, redshift=z, sfr_designation="quiescent")}[family]
    model = port_model_of(jax_model)
    if family == "cacciato09":
        make = jax_fused.make_fused_contraction
        monkeypatch.setattr(jax_fused, "make_fused_contraction",
                            lambda table, **kw: make(table, **{
                                **kw, "interpret": True}))
        jax_f = wp_tabcorr.make_predictor(jax_model, vectorized=True,
                                          engine="fused", dtype=jnp.float32)
    else:
        bundle = jax_pred.make_multi_predictor(
            [wp_tabcorr], jax_model, engine="bundle", batch_tile=8)

        def jax_f(params):
            return bundle(params)[0]
    tab = ttt.TabCorr.read(WP)
    f = ttt.make_predictor(tab, model, engine="fused", device="cpu")
    p_jax, p = _both_params(model, 5, 2)
    before = fused.CONTRACTION_LAUNCHES
    got = f(p)
    assert fused.CONTRACTION_LAUNCHES == before
    _assert_family_close(got, jax_f(p_jax))
    plain = ttt.make_predictor(tab, model, engine="plain", device="cpu")(p)
    _assert_as_close_as_plain(got, plain, lambda i: tab.predict(
        _host_copy(model, p, i), check_consistency=False), range(4),
        per_element=True)


def test_interpolator_grid_route_matches_jax_packed_kernel(monkeypatch):
    jax_interp = tt.Interpolator.read(XI_INTERP)
    interp = ttt.Interpolator.read(XI_INTERP)
    z = float(interp.tabcorr_list[0].attrs["redshift"])
    jax_model = tt.Leauthaud11Model(threshold=10.5, redshift=z)
    jax_model.param_dict["log_eta"] = 0.0
    model = port_model_of(jax_model)
    stacked = predictor.stacked_grid(interp, device="cpu")[0]
    assert fused.grid_layout_for(stacked) == "packed"
    # tabcorr_tpu's packed grid kernel through its streamed route, in
    # interpret mode with a small batch tile.
    monkeypatch.setattr(jax_pred, "_fused_constants_fit_vmem",
                        lambda *a, **k: False)
    make_grid = jax_fused.make_fused_grid_predictor
    monkeypatch.setattr(jax_fused, "make_fused_grid_predictor",
                        lambda *a, **k: make_grid(*a, batch_tile=8, **k))
    jax_f = jax_pred.make_predictor(jax_interp, jax_model, engine="fused",
                                    accuracy="scaled")
    f = ttt.make_predictor(interp, model, engine="fused", accuracy="scaled",
                           device="cpu")
    p_jax, p = _both_params(model, 6, 4)
    eta = np.array([0.0, -0.3, 0.2, 0.1, -0.46, 0.9], np.float32)
    p_jax["log_eta"], p["log_eta"] = jnp.asarray(eta), torch.tensor(eta)
    got = f(p)
    assert np.isnan(float(got[0][5]))             # outside the grid
    _assert_family_close(got, jax_f(p_jax))
    plain = ttt.make_predictor(interp, model, engine="plain", device="cpu")(
        p)
    _assert_as_close_as_plain(got, plain, lambda i: interp.predict(
        _host_copy(model, p, i), check_consistency=False), range(4))


def test_wide_interpolator_slab_route_matches_jax_slab_route(monkeypatch):
    jax_interp, interp = _wide_interpolators()
    jax_model = tt.AssembiasZuMandelbaum15Model(threshold=10.5)
    jax_model.param_dict["log_eta"] = 0.0
    model = port_model_of(jax_model)
    stacked = predictor.stacked_grid(interp, device="cpu")[0]
    assert fused.grid_layout_for(stacked) == "slab"
    monkeypatch.setattr(jax_pred, "_fused_constants_fit_vmem",
                        lambda *a, **k: False)
    make_grid = jax_fused.make_fused_grid_predictor
    monkeypatch.setattr(jax_fused, "make_fused_grid_predictor",
                        lambda *a, **k: make_grid(*a, batch_tile=8, **k))
    jax_f = jax_pred.make_predictor(jax_interp, jax_model, engine="fused",
                                    accuracy="scaled")
    f = ttt.make_predictor(interp, model, engine="fused", accuracy="scaled",
                           device="cpu")
    p_jax, p = _both_params(model, 5, 6)
    eta = np.array([0.0, -0.3, 0.55, 0.25, -0.45], np.float32)
    p_jax["log_eta"], p["log_eta"] = jnp.asarray(eta), torch.tensor(eta)
    before = (fused.SLAB_LAUNCHES, fused.SLAB_TC_LAUNCHES)
    got = f(p)
    assert (fused.SLAB_LAUNCHES, fused.SLAB_TC_LAUNCHES) == before
    assert np.isnan(float(got[0][2])) and np.isnan(float(got[0][4]))
    _assert_family_close(got, jax_f(p_jax))
    # The decoration moves xi.
    p0 = {k: v.clone() for k, v in p.items()}
    for name in ASSEMBIAS:
        p0[name].zero_()
    assert _scaled(got[1][[0, 1, 3]], f(p0)[1][[0, 1, 3]]) > 1e-4


def _nonparametric(tab):
    n_cen = int(np.sum(np.asarray(tab.gal_type["gal_type"]).astype(str)
                       == "centrals"))
    rng = np.random.default_rng(4)
    return ttt.NonparametricHodModel.from_table(
        tab, values_cen=rng.uniform(0, 1, n_cen),
        values_sat=rng.uniform(0, 3, tab.n_bins - n_cen))


def test_nonparametric_model_runs_plain_and_raises_on_fused_engines():
    tab = ttt.TabCorr.read(WP)
    model = _nonparametric(tab)
    assert fused.kernel_model(model) is None
    with pytest.raises(ValueError, match="supports_fused_engine"):
        fused.KernelModel.of(model)
    cuda = torch.device("cuda")
    assert predictor._auto_engine(tab, model, torch.float32, False,
                                  cuda) == "plain"
    interp = ttt.Interpolator.read(XI_INTERP)
    assert predictor._auto_engine(interp, model, torch.float32, False,
                                  cuda) == "plain"
    with pytest.raises(ValueError, match="supports_fused_engine"):
        ttt.make_predictor(tab, model, engine="fused", device="cpu")
    with pytest.raises(ValueError, match="supports_fused_engine"):
        ttt.make_multi_predictor([tab], model, engine="bundle",
                                 device="cpu")
    with pytest.raises(ValueError, match="supports_fused_engine"):
        ttt.make_multi_predictor([tab], model, device="cpu")
    # The plain engines take it: the quadrature returns its values.
    names = list(model.param_dict)
    params = {k: torch.full((2,), v) for k, v in model.param_dict.items()}
    ngal, _ = ttt.make_predictor(tab, model, device="cpu")(params)
    [(ngal_m, _)] = ttt.make_multi_predictor([tab], model, device="cpu",
                                             engine="plain")(params)
    data = tab.table_data(device="cpu")
    want = float(torch.sum(torch.tensor(
        [model.param_dict[k] for k in names]) * data.n_h))
    torch.testing.assert_close(ngal, torch.full((2,), want), rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(ngal_m, ngal, rtol=1e-6, atol=0)


def test_auto_engine_routes_every_fused_engine_model():
    tab = ttt.TabCorr.read(WP)
    interp = ttt.Interpolator.read(XI_INTERP)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    class Subclass(ttt.Zheng07Model):
        pass

    for model in (ttt.Zheng07Model(), Subclass(), ttt.Leauthaud11Model(),
                  ttt.AssembiasCacciato09Model(),
                  ttt.Tinker13Model(sfr_designation="active")):
        for obj in (tab, interp):
            assert predictor._auto_engine(obj, model, torch.float32, False,
                                          cuda) == "fused"
            assert predictor._auto_engine(obj, model, torch.float32, False,
                                          cpu) == "plain"
            assert predictor._auto_engine(obj, model, torch.float64, False,
                                          cuda) == "plain"
    assert fused.KernelModel.of(Subclass()).code == fused.DENSITY_IN
    assert fused.KernelModel.of(ttt.Zheng07Model()).code == 0


def test_density_in_routes_read_the_tensor_op_densities(monkeypatch):
    # On the CPU a code-2 route runs the plain contraction of
    # occupation_density's output: the occupation kernel's plain version,
    # whose densities the card's kernels read.
    tab = ttt.TabCorr.read(WP)
    model = ttt.ZuMandelbaum15Model(prim_haloprop_key="halo_mvir")
    calls = []
    density = fused.occupation_density

    def spy(table, m, params):
        calls.append(m)
        return density(table, m, params)

    monkeypatch.setattr(fused, "occupation_density", spy)
    params = {k: torch.full((3,), v) for k, v in model.param_dict.items()}
    ttt.make_multi_predictor([tab, tab], model, device="cpu")(params)
    assert calls == [model, model]
    zheng = ttt.Zheng07Model(threshold=-18)
    ttt.make_multi_predictor([tab], zheng, device="cpu")(
        {k: torch.full((3,), v) for k, v in zheng.param_dict.items()})
    assert calls == [model, model]             # code 0 computes its own


@pytest.mark.parametrize("kind,n_cols", [
    ("Leauthaud11Model", 16), ("ZuMandelbaum15Model", 12),
    ("Cacciato09Model", 13), ("Tinker13Model", 32 + 3),
    ("AssembiasLeauthaud11Model", 18), ("AssembiasZuMandelbaum15Model", 14),
    ("AssembiasCacciato09Model", 15), ("AssembiasTinker13Model", 37)])
def test_occupation_family_follows_the_kernel_layout(kind, n_cols):
    """The occupation kernel's parameter columns and constants
    (csrc/occupation.cu OccArgs), on the exact type."""
    kw = dict(redshift=0.25)
    if "Tinker13" in kind:
        kw.update(sfr_designation="quiescent", littleh=0.7)
    model = getattr(ttt, kind)(threshold=10.25, **kw)
    fam = fused.OccupationFamily.of(model)
    assert fused.KernelModel.of(model) == fused.KernelModel(
        code=fused.DENSITY_IN, family=fam)
    assert len(fam.param_names) == n_cols
    assert set(fam.param_names) == set(model.param_dict)
    assert fam.decorated == kind.startswith("Assembias")
    assert fam.threshold == 10.25
    if fam.decorated:
        assert fam.param_names[-2:] == ASSEMBIAS
        assert fam.split == model.split
    first = {0: "smhm_m0_0", 1: "smhm_m0", 2: "smhm_m0_0_quiescent",
             3: "log_L_0"}[fam.family]
    assert fam.param_names[0] == first
    if fam.family in (0, 2):
        assert fam.a == pytest.approx(0.8)
        assert fam.log_h == pytest.approx(np.log10(model.littleh))
    if fam.family == 2:
        assert fam.param_names[16] == "smhm_m0_0_active"
        assert fam.param_names[32:35] == tuple(
            f"quiescent_fraction_ordinates_param{i}" for i in (1, 2, 3))
        assert fam.sfr == 1 and fam.abscissa == (12.0, 13.5, 15.0)
    assert fam.modulate == (fam.family in (0, 1))


def test_occupation_family_leaves_other_models_to_tensor_ops():
    class Sub(ttt.Leauthaud11Model):
        pass

    tab = ttt.TabCorr.read(WP)
    table = tab.table_data(device="cpu")
    wide = ttt.Tinker13Model(quiescent_fraction_abscissa=tuple(
        np.linspace(11.0, 15.5, 9)))
    for model in (Sub(), wide, ttt.Zheng07Model(threshold=-18),
                  ttt.FunctionalHodModel(
                      lambda p, m, s: 0.0 * m + p["c"],
                      lambda p, m, s: 0.5 * p["c"] * 10.0 ** (m - 13.0),
                      {"c": 0.5})):
        assert fused.OccupationFamily.of(model) is None
        hod = fused.KernelModel(code=fused.DENSITY_IN)
        params = {k: torch.full((3,), float(v))
                  for k, v in model.param_dict.items()}
        dens = fused.kernel_densities(None, table, model, hod, params)
        assert dens.shape == (table.n_bins, 3) and dens.is_contiguous()
        torch.testing.assert_close(
            dens, fused.occupation_density(table, model, params).t(),
            rtol=0, atol=0)
