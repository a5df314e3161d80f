"""The port's HOD families against tabcorr_tpu's: Leauthaud11, Zu &
Mandelbaum 15, Cacciato09 and Tinker13, each with its Heaviside
assembly-bias decoration, the functional and the non-parametric model.

Tolerances:
* float64 host path (``mean_occupation_*``) against tabcorr_tpu's host
  path: 1e-9 relative (its own host-vs-vectorized bar), and the port's
  float64 tensor path against the host path: 1e-9.
* float32 tensor path, ``occupation`` and ``occupation_residual`` at the
  wp table's float32 quadrature nodes (with their float64 residuals),
  against the float64 host value: 1e-6 plus 8 ulp times the float32
  condition number kappa of the element, kappa = sum_u |u d ln f / d u|
  over the node and every parameter (central differences of the float64
  host function).  Cacciato09's satellites add the cancellation of the
  Gamma recurrence for a < 0, |x^a e^-x / (a Gamma(a, x))|, and take 16
  ulp: their float32 chain rounds some ten quantities of size ~10 (the
  median luminosity, x) before the exponential tail, and tabcorr_tpu's
  float32 path needs the same.  tabcorr_tpu's float32 path meets each
  bar, and the port is within twice it of tabcorr_tpu.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.models.cacciato09 import (
    cacciato09_median_log_luminosity as jax_median_log_lum)
from tabcorr_tpu.utils.special import upper_incomplete_gamma as jax_gamma
from tabcorr_tpu_torch.models import tinker13 as port_tinker13

from conftest import DATA_DIR

ULP = 2.0 ** -24
ASSEMBIAS = ("mean_occupation_centrals_assembias_param1",
             "mean_occupation_satellites_assembias_param1")


def port_model_of(jax_model):
    """The port's model of ``jax_model``'s class, with its constructor
    attributes and ``param_dict`` (the non-parametric model: its cells and
    occupation values)."""
    name = type(jax_model).__name__
    cls = getattr(ttt.models, name)
    base = {k: getattr(jax_model, k) for k in
            ("prim_haloprop_key", "sec_haloprop_key", "redshift")}
    if name == "NonparametricHodModel":
        cells = [{k: np.array(v) for k, v in jax_model._cells[g].items()
                  if k != "top"} for g in ("centrals", "satellites")]
        model = cls(*cells, **base)
    elif name == "FunctionalHodModel":
        raise TypeError("a functional model's callables are the user's: "
                        "build it from torch callables.")
    else:
        names = set()
        for klass in cls.__mro__:
            if "__init__" in vars(klass):
                names |= {p.name for p in inspect.signature(
                    klass.__init__).parameters.values()
                    if p.kind is p.POSITIONAL_OR_KEYWORD}
        kwargs = {k: getattr(jax_model, k) for k in names - {"self"}
                  if hasattr(jax_model, k)}
        model = cls(**kwargs)
    # Every key goes across, an Interpolator's grid keys among them.
    assert set(model.param_dict) <= set(jax_model.param_dict)
    model.param_dict.update(jax_model.param_dict)
    return model


FAMILIES = {
    "leauthaud11": lambda m: m.Leauthaud11Model(threshold=10.5,
                                                redshift=0.3),
    "leauthaud11 unmodulated h=1": lambda m: m.Leauthaud11Model(
        threshold=10.2, modulate_with_cenocc=False, littleh=1.0),
    "zu15": lambda m: m.ZuMandelbaum15Model(threshold=10.3,
                                            prim_haloprop_key="halo_mvir"),
    "cacciato09": lambda m: m.Cacciato09Model(threshold=9.8),
    "tinker13 all": lambda m: m.Tinker13Model(threshold=10.5, redshift=0.2),
    "tinker13 quiescent": lambda m: m.Tinker13Model(
        threshold=10.5, sfr_designation="quiescent"),
    "tinker13 active, 5 control masses": lambda m: m.Tinker13Model(
        threshold=10.4, sfr_designation="active",
        quiescent_fraction_abscissa=(11.5, 12.5, 13.2, 14.0, 15.0)),
    "assembias leauthaud11": lambda m: m.AssembiasLeauthaud11Model(
        threshold=10.5, split=0.4),
    "assembias zu15": lambda m: m.AssembiasZuMandelbaum15Model(
        threshold=10.5),
    "assembias cacciato09": lambda m: m.AssembiasCacciato09Model(
        threshold=9.8),
    "assembias tinker13 quiescent": lambda m: m.AssembiasTinker13Model(
        sfr_designation="quiescent"),
    "assembias tinker13 all": lambda m: m.AssembiasTinker13Model(),
}


def both(family):
    """(tabcorr_tpu model, the port's model via port_model_of)."""
    jax_model = FAMILIES[family](tt)
    return jax_model, port_model_of(jax_model)


def draw(model, batch, seed):
    """float32-representable draws (float64 arrays): every parameter within
    ~1% of its value, assembly-bias strengths uniform in [-1, 1]."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.param_dict.items():
        x = (rng.uniform(-1.0, 1.0, batch) if k in ASSEMBIAS else
             v + 0.01 * abs(v) * rng.normal(size=batch))
        out[k] = x.astype(np.float32).astype(np.float64)
    return out


def _nodes():
    table = ttt.TabCorr.read(DATA_DIR / "examples" / "bolplanck_wp.hdf5")
    data = table.table_data(n_gauss=10, dtype=torch.float32, device="cpu")
    sec = data.sec_perc[:, None].expand_as(data.log_prim_quad)
    # Percentiles on both sides of every split the families use.
    sec = torch.where(torch.arange(sec.shape[0])[:, None] % 2 == 0,
                      0.25, 0.75).expand_as(sec).contiguous()
    return data.log_prim_quad, data.log_prim_quad_lo, sec


def _host(model, params, i, gal_type, node, sec):
    return model.occupation({k: float(v[i]) for k, v in params.items()},
                            gal_type, node, sec)


def _kappa(jax_model, params, gal_type, node, sec):
    """kappa = sum_u |u d ln f / d u| per element (module docstring)."""
    batch = len(next(iter(params.values())))
    f0 = np.stack([_host(jax_model, params, i, gal_type, node, sec)
                   for i in range(batch)])
    rel = 1e-6
    kappa = np.zeros_like(f0)
    for u in ["node"] + list(params):
        if u != "node" and not np.any(params[u]):
            continue
        f = []
        for sign in (1.0, -1.0):
            p, n = dict(params), node
            if u == "node":
                n = node * (1.0 + sign * rel)
            else:
                p[u] = params[u] * (1.0 + sign * rel)
            f.append(np.stack([_host(jax_model, p, i, gal_type, n, sec)
                               for i in range(batch)]))
        with np.errstate(divide="ignore", invalid="ignore"):
            kappa += np.nan_to_num(np.abs((f[0] - f[1]) / (2 * rel) / f0))
    if gal_type == "satellites" and isinstance(jax_model,
                                               tt.Cacciato09Model):
        kappa += _gamma_recurrence_kappa(jax_model, params, node)
    return f0, kappa


def _gamma_recurrence_kappa(jax_model, params, node):
    out = []
    for i in range(len(params["a_1"])):
        p = {k: float(v[i]) for k, v in params.items()}
        log_ls = jax_median_log_lum(p, node) + np.log10(0.562)
        alpha = -2.0 + p["a_1"] * (1.0 - 2.0 / np.pi * np.arctan(
            p["a_2"] * (node - p["log_M_2"])))
        a = 0.5 * (alpha + 1.0)
        x = 10.0 ** (p["delta_1"] + p["delta_2"] * (node - 12.0) +
                     2.0 * (jax_model.threshold - log_ls))
        with np.errstate(all="ignore"):
            out.append(np.nan_to_num(np.where(
                a < 0, x ** a * np.exp(-x) / np.abs(a * jax_gamma(a, x)),
                0.0)))
    return np.stack(out)


def test_port_model_of_carries_class_attributes_and_params():
    for family in FAMILIES:
        jax_model, model = both(family)
        direct = FAMILIES[family](ttt)
        assert type(model) is type(direct)
        assert model.param_dict == jax_model.param_dict == direct.param_dict
        for k, v in vars(direct).items():
            if k != "param_dict":
                assert getattr(model, k) == v, (family, k)


def test_package_exports_every_model_name():
    assert set(tt.models.__all__) <= set(ttt.models.__all__)
    assert set(tt.models.__all__) <= set(ttt.__all__)
    for name in tt.models.__all__:
        assert getattr(ttt, name) is getattr(ttt.models, name)
    for name in tt.__all__:
        if name in tt.models.__all__:
            assert name in ttt.__all__


@pytest.mark.parametrize("family", list(FAMILIES))
def test_float64_host_path_matches_jax(family):
    jax_model, model = both(family)
    rng = np.random.default_rng(11)
    mass = 10.0 ** np.linspace(10.0, 15.8, 301)
    sec = rng.uniform(0.0, 1.0, 301)
    for k in ASSEMBIAS:
        if k in model.param_dict:
            jax_model.param_dict[k] = model.param_dict[k] = 0.7
    for method in ("mean_occupation_centrals", "mean_occupation_satellites"):
        want = getattr(jax_model, method)(prim_haloprop=mass,
                                          sec_haloprop_percentile=sec)
        got = getattr(model, method)(prim_haloprop=mass,
                                     sec_haloprop_percentile=sec)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-300)
        assert np.any(want > 1e-3)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_float64_tensor_path_matches_the_host_path(family):
    jax_model, model = both(family)
    logm, res, sec = _nodes()
    node = logm.double() + res.double()
    params = draw(model, 4, 5)
    for gal_type in ("centrals", "satellites"):
        got = model.occupation_residual(
            {k: torch.tensor(v)[:, None, None] for k, v in params.items()},
            gal_type, node, torch.zeros_like(node), sec.double())
        assert got.dtype == torch.float64 and got.shape == (4,) + node.shape
        want = np.stack([_host(jax_model, params, i, gal_type,
                               node.numpy(), sec.double().numpy())
                         for i in range(4)])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-300)


@pytest.mark.parametrize("method", ["occupation", "occupation_residual"])
@pytest.mark.parametrize("gal_type", ["centrals", "satellites"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_float32_occupation_matches_jax(family, gal_type, method):
    jax_model, model = both(family)
    logm, res, sec = _nodes()
    params = draw(model, 6, 3)
    p32 = {k: torch.tensor(v, dtype=torch.float32)[:, None, None]
           for k, v in params.items()}
    jp32 = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    lj, rj, sj = (jnp.asarray(a.numpy()) for a in (logm, res, sec))
    if method == "occupation":
        got = model.occupation(p32, gal_type, logm, sec)
        ref = jax.vmap(lambda p: jax_model.occupation(p, gal_type, lj, sj))(
            jp32)
        node = logm.double().numpy()
    else:
        got = model.occupation_residual(p32, gal_type, logm, res, sec)
        ref = jax.vmap(lambda p: jax_model.occupation_residual(
            p, gal_type, lj, rj, sj))(jp32)
        node = logm.double().numpy() + res.double().numpy()
    assert got.dtype == torch.float32
    got = got.double().numpy()
    ref = np.asarray(ref, np.float64)
    want, kappa = _kappa(jax_model, params, gal_type, node,
                         sec.double().numpy())
    ulps = (16 if gal_type == "satellites" and
            isinstance(jax_model, tt.Cacciato09Model) else 8)
    mask = want > 1e-30
    assert mask.mean() > 0.4
    tol = (1e-6 + ulps * ULP * (1.0 + kappa))[mask]
    err = np.abs(got[mask] / want[mask] - 1)
    err_jax = np.abs(ref[mask] / want[mask] - 1)
    assert np.all(err_jax <= tol), np.max(err_jax / tol)
    assert np.all(err <= tol), np.max(err / tol)
    assert np.all(np.abs(got[mask] / ref[mask] - 1) <= 2 * tol)
    np.testing.assert_array_equal(got[~mask & (want == 0)], 0.0)


def test_cacciato09_residual_goes_through_the_gamma_derivative():
    # Cacciato09 absorbs the node residual with the protocol's forward-mode
    # derivative in log M, which reaches Gamma(a, x) through both
    # arguments (a = (alpha_sat + 1) / 2 depends on log M).  Its float32
    # tangent against the float64 central difference, and against
    # tabcorr_tpu's (jax.jvp, igamma_grad_a); the residual-absorbed
    # occupation itself is held in test_float32_occupation_matches_jax.
    jax_model, model = both("cacciato09")
    logm, _, sec = _nodes()
    params = draw(model, 4, 8)
    p32 = {k: torch.tensor(v, dtype=torch.float32)[:, None, None]
           for k, v in params.items()}
    occ, tangent = torch.func.jvp(
        lambda lm: model.occupation(p32, "satellites", lm, sec), (logm,),
        (torch.ones_like(logm),))
    assert tangent.dtype == torch.float32
    lj, sj = jnp.asarray(logm.numpy()), jnp.asarray(sec.numpy())
    jax_tangent = np.asarray(jax.vmap(lambda p: jax.jvp(
        lambda lm: jax_model.occupation(p, "satellites", lm, sj), (lj,),
        (jnp.ones_like(lj),))[1])(
            {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}),
        np.float64)
    node, sec64, h = logm.double().numpy(), sec.double().numpy(), 1e-6
    want = np.stack([
        (_host(jax_model, params, i, "satellites", node + h, sec64) -
         _host(jax_model, params, i, "satellites", node - h, sec64)) / (2 * h)
        for i in range(4)])
    occ = occ.double().numpy()
    err = np.abs(tangent.double().numpy() / want - 1)
    err_jax = np.abs(jax_tangent / want - 1)
    for floor, bar in ((1e-30, 1e-2), (1e-10, 1e-3), (1e-3, 1e-4)):
        mask = occ > floor
        assert mask.mean() > 0.5
        assert np.max(err[mask]) <= min(bar, 2 * np.max(err_jax[mask]))


def test_tinker13_spline_map_goes_to_each_device_and_dtype_once():
    jax_model, model = both("tinker13 active, 5 control masses")
    logm = np.linspace(11.0, 15.5, 41)
    params = {k: float(v) for k, v in model.param_dict.items()}
    for i in range(5):
        params[f"quiescent_fraction_ordinates_param{i + 1}"] = 0.2 * i + 0.05
    want = tt.models.tinker13_quiescent_fraction(
        params, logm, abscissa=model.quiescent_fraction_abscissa)
    port_tinker13._FQ_SPLINE_TENSORS.clear()
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        got = ttt.tinker13_quiescent_fraction(
            {k: torch.tensor(v, dtype=dtype) for k, v in params.items()},
            torch.tensor(logm, dtype=dtype),
            abscissa=model.quiescent_fraction_abscissa)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol,
                                   atol=rtol)
    # One device copy, in float64, for both dtypes: a float32 query is
    # evaluated in float64 (the spline's terms cancel) and rounded.
    assert set(port_tinker13._FQ_SPLINE_TENSORS) == {
        (model.quiescent_fraction_abscissa, torch.device("cpu"))}
    assert all(t.dtype == torch.float64 for pair in
               port_tinker13._FQ_SPLINE_TENSORS.values() for t in pair)
    # Seven control masses: a quintic spline of two segments, with the
    # residual.
    ab = (11.0, 11.7, 12.4, 13.1, 13.8, 14.5, 15.2)
    p4 = {f"quiescent_fraction_ordinates_param{i + 1}": o
          for i, o in enumerate((0.1, 0.3, 0.5, 0.65, 0.8, 0.9, 0.95))}
    assert len(ttt.models.tinker13.tinker13_fq_spline_map(ab)[0]) == 3
    for res in (None, 3e-7):
        want = tt.models.tinker13_quiescent_fraction(
            p4, logm, abscissa=ab, log_prim_res=res)
        got = ttt.tinker13_quiescent_fraction(
            {k: torch.tensor(v, dtype=torch.float32) for k, v in p4.items()},
            torch.tensor(logm, dtype=torch.float32), abscissa=ab,
            log_prim_res=None if res is None else torch.tensor(res))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-6,
                                   atol=1e-7)
    # The host map is the JAX package's.
    for a, b in zip(ttt.models.tinker13.tinker13_fq_spline_map(
            model.quiescent_fraction_abscissa),
            tt.models.tinker13.tinker13_fq_spline_map(
                model.quiescent_fraction_abscissa)):
        np.testing.assert_array_equal(a, b)
    # Piecewise-linear f_q, with and without the residual.
    for res in (None, 3e-7):
        got = ttt.tinker13_quiescent_fraction(
            params, logm, abscissa=model.quiescent_fraction_abscissa,
            log_prim_res=res, interpolation="linear")
        np.testing.assert_array_equal(
            got, tt.models.tinker13_quiescent_fraction(
                params, logm, abscissa=model.quiescent_fraction_abscissa,
                log_prim_res=res, interpolation="linear"))
    with pytest.raises(ValueError):
        ttt.tinker13_quiescent_fraction(params, logm, interpolation="cubic")


def test_tinker13_validates_and_rekeys_like_jax():
    model = ttt.Tinker13Model(quiescent_fraction_abscissa=(12.0, 14.0))
    jax_model = tt.Tinker13Model(quiescent_fraction_abscissa=(12.0, 14.0))
    assert model.param_names == jax_model.param_names
    assert model.param_dict == jax_model.param_dict
    with pytest.raises(ValueError):
        ttt.Tinker13Model(sfr_designation="green")
    with pytest.raises(ValueError):
        ttt.Tinker13Model(quiescent_fraction_abscissa=(13.0, 12.0))


def test_assembias_tinker13_single_population_ceiling():
    # Single-population centrals are bounded by their own ceiling, f_q or
    # 1 - f_q, at every strength, the decoration preserves the mean, and
    # strength 1 saturates the ceiling where base >= ceiling / 2.
    logm = np.linspace(12.0, 15.3, 61)
    for sfr in ("quiescent", "active"):
        model = ttt.AssembiasTinker13Model(threshold=10.5, redshift=0.5,
                                           sfr_designation=sfr)
        base_model = ttt.Tinker13Model(threshold=10.5, redshift=0.5,
                                       sfr_designation=sfr)
        fq = ttt.tinker13_quiescent_fraction(model.param_dict, logm)
        ceiling = fq if sfr == "quiescent" else 1.0 - fq
        base = base_model.occupation(base_model.param_dict, "centrals",
                                     logm, 0.5)
        for strength in (-1.0, -0.3, 0.5, 1.0):
            model.param_dict[ASSEMBIAS[0]] = strength
            params = dict(model.param_dict)
            hi = model.occupation(params, "centrals", logm, 0.75)
            lo = model.occupation(params, "centrals", logm, 0.25)
            assert np.all(hi <= ceiling + 1e-12), (sfr, strength)
            assert np.all(lo <= ceiling + 1e-12), (sfr, strength)
            assert np.all(hi >= -1e-14) and np.all(lo >= -1e-14)
            np.testing.assert_allclose(0.5 * (hi + lo), base, rtol=1e-10)
            # The float32 tensor path carries the same ceiling.
            hi32 = model.occupation(
                {k: torch.tensor(v, dtype=torch.float32)
                 for k, v in params.items()}, "centrals",
                torch.tensor(logm, dtype=torch.float32),
                torch.full((61,), 0.75))
            assert hi32.dtype == torch.float32
            np.testing.assert_allclose(hi32.double().numpy(), hi,
                                       rtol=2e-5, atol=1e-7)
        tight = base >= 0.5 * ceiling + 1e-9
        assert np.any(tight)
        np.testing.assert_allclose(hi[tight], ceiling[tight], rtol=1e-10)


def _jax_nonparametric():
    jax_tab = tt.TabCorr.read(DATA_DIR / "examples" / "bolplanck_wp.hdf5")
    n_cen = int(np.sum(np.asarray(jax_tab.gal_type["gal_type"]).astype(str)
                       == "centrals"))
    rng = np.random.default_rng(4)
    return jax_tab, tt.NonparametricHodModel.from_table(
        jax_tab, values_cen=rng.uniform(0, 1, n_cen),
        values_sat=rng.uniform(0, 3, len(jax_tab.gal_type) - n_cen))


def test_nonparametric_model_matches_jax():
    jax_tab, jax_model = _jax_nonparametric()
    tab = ttt.TabCorr.read(DATA_DIR / "examples" / "bolplanck_wp.hdf5")
    model = ttt.NonparametricHodModel.from_table(
        tab, values_cen=jax_model.occupation_vector("centrals"),
        values_sat=jax_model.occupation_vector("satellites"))
    assert model.supports_fused_engine is False
    assert model.param_dict == jax_model.param_dict
    assert model.prim_haloprop_key == jax_model.prim_haloprop_key
    assert port_model_of(jax_model).param_dict == jax_model.param_dict
    np.testing.assert_array_equal(model.occupation_vector(),
                                  jax_model.occupation_vector())
    # Quadrature returns the cell values exactly, on both packages.
    want = jax_tab.mean_occupation(jax_model, check_consistency=False)
    got = tab.mean_occupation(model, check_consistency=False)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, model.occupation_vector(), rtol=1e-12)
    # The batched tensor path, float64 and float32.
    data = tab.table_data(n_gauss=10, dtype=torch.float64, device="cpu")
    occ_cen, occ_sat = ttt.occupation_functions(model)
    values = np.stack([model.occupation_vector(),
                       2.0 * model.occupation_vector()])
    names = list(model.param_dict)
    params = {k: torch.tensor(values[:, i]) for i, k in enumerate(names)}
    mean = ttt.ops.predict.mean_occupation(data, occ_cen, occ_sat, params)
    np.testing.assert_allclose(mean.numpy(), values, rtol=1e-12)
    # Vectors back into param_dict.
    model.set_occupation_vector(values[1])
    np.testing.assert_array_equal(model.occupation_vector(), values[1])
    with pytest.raises(ValueError):
        model.set_occupation_vector(values[1][:5], "centrals")


@pytest.mark.parametrize("log", [True, False])
def test_smoothness_log_prior_matches_jax(log):
    rng = np.random.default_rng(9)
    values = rng.uniform(0.01, 2.0, (3, 17))
    want = np.asarray(tt.models.smoothness_log_prior(
        jnp.asarray(values), scale=0.3, log=log))
    got = ttt.smoothness_log_prior(torch.tensor(values), scale=0.3, log=log)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(
        ttt.smoothness_log_prior(values, scale=0.3, log=log), want,
        rtol=1e-12)
    linear = np.linspace(0.1, 1.0, 9) if not log else 10.0 ** np.linspace(
        -1, 1, 9)
    assert abs(float(ttt.smoothness_log_prior(linear, log=log))) < 1e-20


def test_functional_model_matches_jax():
    from tabcorr_tpu_torch.utils.backend import erfc, exp10

    def cen(params, log_m, sec):
        return 0.5 * erfc(-(log_m - params["logMmin"]) / params["sigma"])

    def sat(params, log_m, sec):
        return exp10(params["alpha"] * (log_m - params["logM1"]))

    def jax_cen(params, log_m, sec):
        from tabcorr_tpu.utils.backend import erfc as jerfc
        return 0.5 * jerfc(-(log_m - params["logMmin"]) / params["sigma"])

    def jax_sat(params, log_m, sec):
        return 10.0 ** (params["alpha"] * (log_m - params["logM1"]))

    defaults = {"logMmin": 12.0, "sigma": 0.3, "logM1": 13.3, "alpha": 1.1}
    model = ttt.FunctionalHodModel(cen, sat, defaults, redshift=0.1)
    jax_model = tt.models.FunctionalHodModel(jax_cen, jax_sat, defaults,
                                             redshift=0.1)
    with pytest.raises(TypeError):
        port_model_of(jax_model)
    mass = 10.0 ** np.linspace(11.0, 15.0, 50)
    for method in ("mean_occupation_centrals", "mean_occupation_satellites"):
        np.testing.assert_allclose(
            getattr(model, method)(prim_haloprop=mass),
            getattr(jax_model, method)(prim_haloprop=mass), rtol=1e-12)
    # The fused engines take it, through its densities; the residual is
    # the protocol's forward-mode derivative.
    assert ttt.ops.fused.kernel_model(model) == ttt.ops.fused.DENSITY_IN
    logm, res, sec = _nodes()
    p = {k: torch.full((2, 1, 1), v) for k, v in defaults.items()}
    got = model.occupation_residual(p, "satellites", logm, res, sec)
    assert got.dtype == torch.float32
    want = sat({k: float(v) for k, v in defaults.items()},
               logm.double().numpy() + res.double().numpy(), None)
    np.testing.assert_allclose(got[0].double().numpy(), want, rtol=2e-6)
