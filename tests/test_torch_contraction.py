"""The contraction kernel's plain version and the fused TabCorr predictor
against tabcorr_tpu's ``make_fused_contraction`` / ``make_fused_predictor``
(Pallas interpret mode), on the wp, xi_ell and Delta Sigma fixtures.

Tolerances are the bundle's (test_torch_bundle.py): ngal 1e-6 relative;
wp 1e-6 relative per element, xi_ell and Delta Sigma 1e-6 of the
statistic's largest element ('scaled') -- each package against the
float64 host path at the float32 parameter values, and the two packages
against each other.  Also here: the per-galaxy-type predictions, the
occupation predictor and the host ``predict`` with an occupation array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.ops.fused import make_fused_contraction, make_fused_predictor
from tabcorr_tpu.predictor import make_occupation_predictor
from tabcorr_tpu.predictor import make_predictor as jax_make_predictor
from tabcorr_tpu.predictor import occupation_functions
from tabcorr_tpu_torch.ops import fused

from conftest import DATA_DIR

FILES = {"wp": "bolplanck_wp", "xi": "synthetic_xi_ell", "ds": "bolplanck_ds"}
NAMES = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")


@pytest.fixture(scope="module")
def tabs():
    return {k: (tt.TabCorr.read(DATA_DIR / "examples" / f"{f}.hdf5"),
                ttt.TabCorr.read(DATA_DIR / "examples" / f"{f}.hdf5"))
            for k, f in FILES.items()}


def _params(batch, seed=0):
    rng = np.random.default_rng(seed)
    p = {"logMmin": 11.35 + 0.1 * rng.normal(size=batch),
         "sigma_logM": 0.25 + 0.01 * rng.normal(size=batch),
         "logM0": 11.2 + 0.1 * rng.normal(size=batch),
         "logM1": 12.4 + 0.1 * rng.normal(size=batch),
         "alpha": 0.83 + 0.02 * rng.normal(size=batch)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _error(stat, got, want):
    got, want = np.ravel(got), np.ravel(want)
    if stat == "wp":
        return float(np.max(np.abs(got - want) / np.abs(want)))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _host(tab, redshift, params, i):
    m = ttt.Zheng07Model(threshold=-18, redshift=redshift)
    for k in NAMES:
        m.param_dict[k] = float(params[k][i])
    return tab.predict(m, check_consistency=False)


@pytest.mark.parametrize("stat", ["wp", "xi", "ds"])
def test_contraction_plain_matches_jax_contraction(tabs, stat):
    jax_tab, tab = tabs[stat]
    rng = np.random.default_rng(3)
    ngal = (10.0 ** rng.uniform(-7, -3, (16, tab.n_bins))).astype(np.float32)
    jax_total, jax_xi = make_fused_contraction(
        jax_tab.table_data(n_gauss=10, dtype=jnp.float32), batch_tile=8,
        interpret=True)(jnp.asarray(ngal))
    contract = fused.make_fused_contraction(tab.table_data(device="cpu"))
    before = fused.CONTRACTION_LAUNCHES
    total, xi = contract(torch.tensor(ngal))
    assert fused.CONTRACTION_LAUNCHES == before   # CPU tensors: no launch
    assert xi.shape == (16, int(np.prod(tab.tpcf_shape)))
    dense = tab.dense_matrix()
    for i in range(16):
        n64 = ngal[i].astype(np.float64)
        want = (np.einsum("kij,i,j->k", dense, n64, n64) / n64.sum() ** 2
                if tab.mode == "auto" else dense @ n64 / n64.sum())
        assert _error(stat, xi[i].double().numpy(), want) <= 1e-6, i
        assert _error(stat, np.asarray(jax_xi[i], np.float64), want) <= 1e-6
        assert _error(stat, xi[i].double().numpy(),
                      np.asarray(jax_xi[i], np.float64)) <= 1e-6
        assert abs(float(total[i]) / n64.sum() - 1) <= 1e-6
        assert abs(float(jax_total[i]) / float(total[i]) - 1) <= 1e-6


@pytest.mark.parametrize("stat,batch", [("wp", 13), ("xi", 8), ("ds", 13)])
def test_fused_predictor_matches_jax_and_float64(tabs, stat, batch):
    jax_tab, tab = tabs[stat]
    redshift = float(tab.attrs["redshift"])
    params = _params(batch, seed=5)
    jax_model = tt.Zheng07Model(threshold=-18, redshift=redshift)
    jax_f = make_fused_predictor(
        jax_tab.table_data(n_gauss=10, dtype=jnp.float32),
        *occupation_functions(jax_model), batch_tile=8, interpret=True)
    ng_j, xi_j = jax_f({k: jnp.asarray(v) for k, v in params.items()})
    model = ttt.Zheng07Model(threshold=-18, redshift=redshift)
    f = ttt.make_predictor(tab, model, engine="fused", device="cpu")
    ng, xi = f({k: torch.tensor(v) for k, v in params.items()})
    assert xi.shape == (batch,) + tab.tpcf_shape and xi.dtype == torch.float32
    for i in range(batch):
        ng64, xi64 = _host(tab, redshift, params, i)
        got, jax_got = xi[i].double().numpy(), np.asarray(xi_j[i], np.float64)
        assert _error(stat, got, xi64) <= 1e-6, i
        assert _error(stat, jax_got, xi64) <= 1e-6, i
        assert _error(stat, got, jax_got) <= 1e-6, i
        assert abs(float(ng[i]) / ng64 - 1) <= 1e-6
        assert abs(float(ng_j[i]) / float(ng[i]) - 1) <= 1e-6


def test_contraction_plain_is_independent_of_the_chunk(tabs, monkeypatch):
    table = tabs["xi"][1].table_data(device="cpu")
    c = fused.bundle_table_constants(table)
    model = ttt.Zheng07Model(threshold=-18)
    params = {k: torch.tensor(v) for k, v in _params(11, 2).items()}
    ngal = fused.occupation_density(table, model, params)
    whole = fused.contraction_plain(c, ngal)
    monkeypatch.setattr(fused, "_PLAIN_CHUNK", 4)
    monkeypatch.setattr(fused, "_OCC_CHUNK", 3)
    torch.testing.assert_close(
        fused.occupation_density(table, model, params), ngal, rtol=0, atol=0)
    chunked = fused.contraction_plain(c, ngal)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))


def test_contraction_wrapper_never_falls_back_to_the_cpu(tabs):
    c = fused.bundle_table_constants(tabs["wp"][1].table_data(device="cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        fused.contraction_launch(c, torch.ones((4, 60)))
    assert fused.contraction_fits(120, 42)
    assert not fused.contraction_fits(1104, 13)


@pytest.mark.parametrize("stat", ["wp", "ds"])
def test_separate_gal_type_matches_jax(tabs, stat):
    jax_tab, tab = tabs[stat]
    redshift = float(tab.attrs["redshift"])
    params = _params(5, seed=6)
    jax_model = tt.Zheng07Model(threshold=-18, redshift=redshift)
    model = ttt.Zheng07Model(threshold=-18, redshift=redshift)
    jax_f = jax_make_predictor(jax_tab, jax_model, dtype=jnp.float64,
                               separate_gal_type=True, engine="xla")
    f = ttt.make_predictor(tab, model, dtype=torch.float64,
                           separate_gal_type=True, device="cpu")
    got = f({k: torch.tensor(v, dtype=torch.float64)
             for k, v in params.items()})
    want = jax_f({k: jnp.asarray(v, jnp.float64) for k, v in params.items()})
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=1e-12, atol=1e-300)
    # The host path: the parts add up to the whole, as tabcorr_tpu's do.
    m, jm = (ttt.Zheng07Model(threshold=-18, redshift=redshift),
             tt.Zheng07Model(threshold=-18, redshift=redshift))
    ng_d, xi_d = tab.predict(m, separate_gal_type=True,
                             check_consistency=False)
    jng_d, jxi_d = jax_tab.predict(jm, separate_gal_type=True,
                                   check_consistency=False)
    for k in jxi_d:
        np.testing.assert_allclose(xi_d[k], jxi_d[k], rtol=1e-12)
    ng, xi = tab.predict(m, check_consistency=False)
    np.testing.assert_allclose(sum(xi_d.values()), xi, rtol=1e-10)
    assert abs(sum(ng_d.values()) / ng - 1) < 1e-12


@pytest.mark.parametrize("separate", [False, True])
def test_occupation_predictor_matches_jax(tabs, separate):
    jax_tab, tab = tabs["xi"]
    occ = np.random.default_rng(9).uniform(0, 2, (3, tab.n_bins))
    want = make_occupation_predictor(jax_tab, dtype=jnp.float64,
                                     separate_gal_type=separate)(occ)
    got = ttt.make_occupation_predictor(tab, dtype=torch.float64,
                                        separate_gal_type=separate,
                                        device="cpu")(occ)
    host = [tab.predict(o, separate_gal_type=separate) for o in occ]
    for part, (g, w) in enumerate(zip(got, want)):
        pairs = [(g[k], w[k]) for k in w] if separate else [(g, w)]
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
        if not separate:
            np.testing.assert_allclose(
                g.numpy(), np.array([h[part] for h in host]), rtol=1e-12)
