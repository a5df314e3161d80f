"""The port's make_multi_predictor(engine='auto'), its Interpolator and
float64 members, make_predictor(vectorized=False) under torch.vmap and
TabCorr.make_predictor, against tabcorr_tpu's XLA engine (float64,
1e-10 relative, or 1e-10 of the statistic's largest element)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.predictor import make_multi_predictor as jax_multi
from tabcorr_tpu.predictor import make_predictor as jax_make_predictor
from tabcorr_tpu_torch import predictor

from conftest import DATA_DIR

WP = DATA_DIR / "examples" / "bolplanck_wp.hdf5"
DS = DATA_DIR / "examples" / "bolplanck_ds.hdf5"
DS_GRID = (DATA_DIR / "AbacusSummit" / "base_c000_ph000" / "0p50" /
           "ds_efficient.hdf5")
CUDA = torch.device("cuda")


@pytest.fixture(scope="module")
def objs():
    """(tabcorr_tpu, port) pairs: wp (auto), ds (cross), the ds
    'efficient' Interpolator (cross, 1104 bins, 4 log_eta nodes)."""
    return {"wp": (tt.TabCorr.read(WP), ttt.TabCorr.read(WP)),
            "ds": (tt.TabCorr.read(DS), ttt.TabCorr.read(DS)),
            "grid": (tt.Interpolator.read(DS_GRID),
                     ttt.Interpolator.read(DS_GRID))}


def _models():
    """zheng07 in both packages at the grid's redshift and mass
    definition, its grid keys set (the Interpolator reads log_eta)."""
    kw = dict(threshold=-21, redshift=0.5, prim_haloprop_key="halo_m258m")
    out = (tt.Zheng07Model(**kw), ttt.Zheng07Model(**kw))
    for m in out:
        m.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
    return out


def _params(model, batch, seed, outside=()):
    """A float64 batch around the model's values, log_eta inside the
    grid except at rows ``outside``."""
    rng = np.random.default_rng(seed)
    p = {k: np.full(batch, v, np.float64) + (
        0.05 * rng.normal(size=batch) if k in ("logMmin", "logM1", "alpha")
        else 0.0) for k, v in model.param_dict.items()}
    p["log_eta"] = rng.uniform(-0.2, 0.2, batch)
    for i in outside:
        p["log_eta"][i] = 3.0
    return p


def _assert_close(got, want, rtol=1e-10):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol,
                               atol=rtol * np.max(np.abs(want[ok])))


# ---- the route ------------------------------------------------------
def test_auto_route_by_device_dtype_and_members(objs):
    wp, ds, grid = (objs[k][1] for k in ("wp", "ds", "grid"))
    zheng = ttt.Zheng07Model(threshold=-18)
    cells = {"log_prim_min": [11.0], "log_prim_max": [15.0]}
    nonparametric = ttt.NonparametricHodModel(cells, cells)
    assert not nonparametric.supports_fused_engine
    route = predictor.multi_engine_for
    f32, f64 = torch.float32, torch.float64
    assert route([wp, ds], zheng, f32, CUDA) == "bundle"
    assert route([wp, ds], zheng, f32, "cpu") == "members"
    assert route([wp, ds], zheng, f64, CUDA) == "members"
    assert route([wp, grid], zheng, f32, CUDA) == "members"
    assert route([wp, ds], nonparametric, f32, CUDA) == "members"
    assert route([wp] * 5, zheng, f32, CUDA) == "members"
    # A member the bundle's shared memory does not take.
    wide = ttt.TabCorr.read(WP)
    wide.tpcf_shape = (4096,)
    assert not predictor.fused.contraction_fits(wide.n_bins, 4096)
    assert route([wp, wide], zheng, f32, CUDA) == "members"
    # Each member's own route on the card: a float32 kernel where one
    # takes it, the plain engine in float64.
    auto = predictor._auto_engine
    assert auto(wp, zheng, f32, False, CUDA) == "fused"
    assert auto(grid, zheng, f32, False, CUDA) == "fused"
    assert auto(wp, zheng, f64, False, CUDA) == "plain"
    assert auto(grid, zheng, f64, False, CUDA) == "plain"
    assert auto(wp, zheng, f32, False, CUDA, vectorized=False) == "plain"
    assert auto(wp, zheng, f32, False, torch.device("cpu")) == "plain"


@pytest.mark.parametrize("engine", ["bundle", "plain"])
def test_bundle_engines_take_float32_tabcorrs_only(objs, engine):
    wp, grid = objs["wp"][1], objs["grid"][1]
    model = _models()[1]
    with pytest.raises(ValueError, match="float32 and TabCorr"):
        ttt.make_multi_predictor([wp, grid], model, device="cpu",
                                 engine=engine)
    with pytest.raises(ValueError, match="float32 and TabCorr"):
        ttt.make_multi_predictor([wp], model, dtype=torch.float64,
                                 device="cpu", engine=engine)


def test_auto_on_the_cpu_composes_the_members(objs):
    wp, ds, grid = (objs[k][1] for k in ("wp", "ds", "grid"))
    model = _models()[1]
    params = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in _params(model, 9, 0, outside=(4,)).items()}
    got = ttt.make_multi_predictor([wp, ds, grid], model, device="cpu",
                                   engine="auto")(params)
    # The same computation; a float32 reduction of torch's CPU kernels
    # may take another order with other buffer alignments (1 ulp seen).
    for obj, (ngal, xi) in zip((wp, ds, grid), got):
        want = ttt.make_predictor(obj, model, device="cpu")(params)
        assert xi.dtype == torch.float32
        torch.testing.assert_close(ngal, want[0], rtol=4e-7, atol=0,
                                   equal_nan=True)
        torch.testing.assert_close(xi, want[1], rtol=4e-7, atol=0,
                                   equal_nan=True)
    assert torch.isnan(got[2][1][4]).all() and torch.isnan(got[2][0][4])
    assert not torch.isnan(got[2][1][:4]).any()


def test_float64_members_match_jax(objs):
    jax_model, model = _models()
    members = ("wp", "ds", "grid")
    predict = ttt.make_multi_predictor(
        [objs[k][1] for k in members], model, dtype=torch.float64,
        device="cpu", engine="auto")
    jax_predict = jax_multi([objs[k][0] for k in members], jax_model,
                            dtype=jnp.float64, engine="xla")
    p = _params(model, 7, 1, outside=(2,))
    got = predict({k: torch.tensor(v) for k, v in p.items()})
    want = jax_predict({k: jnp.asarray(v) for k, v in p.items()})
    for (ng, xi), (ng_j, xi_j) in zip(got, want):
        assert xi.dtype == torch.float64
        _assert_close(ng, ng_j)
        _assert_close(xi, xi_j)


# ---- the unvectorized predictor -------------------------------------
@pytest.mark.parametrize("separate", [False, True])
@pytest.mark.parametrize("member", ["wp", "ds", "grid"])
def test_unvectorized_predictor_under_vmap_matches_jax(objs, member,
                                                       separate):
    jax_obj, obj = objs[member]
    jax_model, model = _models()
    kwargs = dict(dtype=jnp.float64, separate_gal_type=separate)
    jax_one = jax_make_predictor(jax_obj, jax_model, vectorized=False,
                                 jit=False, **kwargs)
    one = ttt.make_predictor(obj, model, dtype=torch.float64,
                             separate_gal_type=separate, vectorized=False,
                             device="cpu")
    p = _params(model, 5, 2, outside=(3,))
    got = torch.vmap(one)({k: torch.tensor(v) for k, v in p.items()})
    want = jax.vmap(jax_one)({k: jnp.asarray(v) for k, v in p.items()})
    if separate:
        for part in (0, 1):
            assert got[part].keys() == want[part].keys()
            for key in want[part]:
                _assert_close(got[part][key], want[part][key])
    else:
        _assert_close(got[0], want[0])
        _assert_close(got[1], want[1])
    if not separate:
        # One sample of floats: 0-d ngal, xi of one statistic's shape.
        ngal, xi = one({k: float(v[0]) for k, v in p.items()})
        assert ngal.shape == ()
        _assert_close(xi, want[1][0])


def test_unvectorized_rejects_the_fused_engine(objs):
    with pytest.raises(ValueError, match="vectorized=True"):
        ttt.make_predictor(objs["wp"][1], _models()[1], engine="fused",
                           vectorized=False, device="cpu")


@pytest.mark.parametrize("vectorized", [True, False])
def test_tabcorr_make_predictor_matches_jax(objs, vectorized):
    jax_tab, tab = objs["wp"]
    jax_model = tt.Zheng07Model(threshold=-18,
                                redshift=jax_tab.attrs["redshift"])
    model = ttt.Zheng07Model(threshold=-18, redshift=tab.attrs["redshift"])
    got_fn = tab.make_predictor(model, dtype=torch.float64,
                                vectorized=vectorized, device="cpu")
    want_fn = jax_tab.make_predictor(jax_model, dtype=jnp.float64,
                                     vectorized=vectorized, engine="xla")
    p = {k: np.asarray(v + 0.02 * np.arange(4)) for k, v in
         model.param_dict.items()}
    if vectorized:
        got = got_fn({k: torch.tensor(v) for k, v in p.items()})
        want = want_fn({k: jnp.asarray(v) for k, v in p.items()})
    else:
        got = torch.vmap(got_fn)({k: torch.tensor(v) for k, v in p.items()})
        want = jax.vmap(want_fn)({k: jnp.asarray(v) for k, v in p.items()})
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1])


@pytest.mark.parametrize("family", ["Leauthaud11Model", "ZuMandelbaum15Model",
                                    "Cacciato09Model", "Tinker13Model",
                                    "AssembiasLeauthaud11Model"])
def test_family_unvectorized_predictors_under_vmap(objs, family):
    """Every family's plain float64 path traces under torch.vmap (the
    gradient samplers map it over chains), values and gradients equal to
    the batched predictor's (1e-12)."""
    tab = objs["wp"][1]
    model = getattr(ttt, family)(threshold=10.5,
                                 redshift=tab.attrs["redshift"])
    one = ttt.make_predictor(tab, model, dtype=torch.float64,
                             vectorized=False, device="cpu")
    batched = ttt.make_predictor(tab, model, dtype=torch.float64,
                                 device="cpu")
    scale = torch.tensor([1.0, 1.01, 0.99])
    grads = []
    for fn in (torch.vmap(one), batched):
        p = {k: (v * scale).double().requires_grad_()
             for k, v in ((k, torch.tensor(float(v)))
                          for k, v in model.param_dict.items())}
        ngal, xi = fn(p)
        total = xi.sum() / xi.detach().abs().max() + ngal.sum() * 1e3
        grads.append((xi.detach(), torch.autograd.grad(total,
                                                       list(p.values()))))
    (xi_v, g_v), (xi_b, g_b) = grads
    torch.testing.assert_close(xi_v, xi_b, rtol=1e-12, atol=0)
    for a, b in zip(g_v, g_b):
        torch.testing.assert_close(a, b, rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))
