"""The port's tabulation (``TabCorr.tabulate`` on the CPU, through the pair
counter's plain version) against tabcorr_tpu's, on the same column dict
and seed, and the host modules it runs on: the dense mock, the cosmology,
the configuration registry and the database reader.

tabcorr_tpu counts on its XLA sweep here (its C++ counter switched off), in
float32 geometry like the port: counts equal, so tables agree to rounding.
The one exception is the annulus-mean Delta Sigma, whose ln(rp) channel
tabcorr_tpu sums in float32 within each i-chunk (see
test_torch_paircount.py); it is held to a float64 oracle instead.
"""

import numpy as np
import pytest

import tabcorr_tpu as tt
import tabcorr_tpu.mock as jmock
import tabcorr_tpu.ops.paircount as jpc
import tabcorr_tpu_torch as tp
import tabcorr_tpu_torch.mock as tmock
from tabcorr_tpu.ops.multipole import \
    tabcorr_s_mu_to_multipole as j_multipole
from tabcorr_tpu_torch.ops.multipole import \
    tabcorr_s_mu_to_multipole as t_multipole

LBOX = 150.0


@pytest.fixture(autouse=True)
def xla_sweep(monkeypatch):
    monkeypatch.setattr(jpc, "_native_eligible", lambda *a: False)


def _columns(n_halos=800, seed=1):
    """tests/test_tabulate.py's synthetic catalog, as a column dict."""
    rng = np.random.default_rng(seed)
    mass = 10.0 ** rng.uniform(12.0, 13.5, n_halos)
    pos = np.stack([rng.uniform(0, LBOX, n_halos) for _ in range(3)],
                   axis=1)
    return {
        "halo_x": pos[:, 0], "halo_y": pos[:, 1], "halo_z": pos[:, 2],
        "halo_vx": 300 * rng.normal(size=n_halos),
        "halo_vy": 300 * rng.normal(size=n_halos),
        "halo_vz": 300 * rng.normal(size=n_halos),
        "halo_mvir": mass,
        "halo_rvir": 0.3 * (mass / 1e13) ** (1.0 / 3.0),
        "halo_nfw_conc": np.clip(8 * (mass / 1e13) ** -0.1 * np.exp(
            0.3 * rng.normal(size=n_halos)), 2.0, 25.0),
        "halo_upid": np.full(n_halos, -1, dtype=np.int64),
    }


def _catalogs(redshift=0.0):
    cols = _columns()
    out = []
    for pkg in (tt, tp):
        cosmo = pkg.cosmology.FlatFLRW(H0=70, Om0=0.3, Tcmb0=0, Neff=0)
        out.append(pkg.HaloCatalog({k: v.copy() for k, v in cols.items()},
                                   Lbox=LBOX, particle_mass=1e9,
                                   redshift=redshift, cosmology=cosmo,
                                   simname="synthetic"))
    return out


PTCL = np.random.default_rng(3).uniform(0, LBOX, (3000, 3))
BINS = np.logspace(-0.5, 1.2, 6)
MU = np.linspace(0, 1, 6)
BASE = dict(prim_haloprop_bins=4, Num_ptcl_requirement=300,
            sats_per_prim_haloprop=1e-12, seed=13)

CASES = {
    "wp": ("wp", (BINS, 20.0), dict(mode="auto")),
    "s_mu": ("s_mu_tpcf", (BINS, MU), dict(mode="auto")),
    "tpcf-split-project_xyz": ("tpcf", (BINS,), dict(
        mode="auto", sec_haloprop_percentile_bins=0.5, project_xyz=True)),
    "wp-ap-stretch": ("wp", (BINS, 20.0), dict(mode="auto",
                                               cosmology_obs="Planck15")),
    "ds-annulus-downsample": ("mean_delta_sigma", (PTCL, 1e9, BINS), dict(
        mode="cross", prim_haloprop_bins=6,
        downsample=lambda m: np.asarray(m) / 1e13)),
    "ds-midpoint": ("mean_delta_sigma", (PTCL, 1e9, BINS), dict(
        mode="cross", estimator="midpoint", downsample=0.5)),
}


def _tabulate_both(case):
    name, args, kwargs = CASES[case]
    kwargs = {**BASE, **kwargs}
    redshift = 0.0
    obs = kwargs.pop("cosmology_obs", None)
    if obs:
        redshift = 0.5
    cat_j, cat_t = _catalogs(redshift)
    tab_j = tt.TabCorr.tabulate(
        cat_j, getattr(tt.corrfunc, name), *args, **kwargs,
        **({"cosmology_obs": tt.cosmology.Planck15} if obs else {}))
    tab_t = tp.TabCorr.tabulate(
        cat_t, getattr(tp.corrfunc, name), *args, device="cpu", **kwargs,
        **({"cosmology_obs": tp.cosmology.Planck15} if obs else {}))
    return tab_j, tab_t


def _assert_same_gal_type(tab_j, tab_t):
    assert tab_j.gal_type.colnames == tab_t.gal_type.colnames
    for col in tab_j.gal_type.colnames:
        np.testing.assert_array_equal(tab_t.gal_type[col],
                                      tab_j.gal_type[col], err_msg=col)


def _predictions(tab_j, tab_t, redshift):
    kw = dict(threshold=-20, redshift=redshift, logMmin=12.3, logM1=13.2)
    return (tab_j.predict(tt.Zheng07Model(**kw), check_consistency=False),
            tab_t.predict(tp.Zheng07Model(**kw), check_consistency=False))


@pytest.mark.parametrize("case", list(CASES))
def test_tabulate_matches_tabcorr_tpu(case):
    tab_j, tab_t = _tabulate_both(case)
    _assert_same_gal_type(tab_j, tab_t)
    assert tab_t.attrs == tab_j.attrs
    assert tab_t.tpcf_shape == tab_j.tpcf_shape
    assert tab_t.tpcf_matrix.shape == tab_j.tpcf_matrix.shape
    for a, b in zip(tab_t.tpcf_args, tab_j.tpcf_args):
        np.testing.assert_array_equal(a, b)
    assert tab_t.tpcf_kwargs.keys() == tab_j.tpcf_kwargs.keys()
    (ng_j, xi_j), (ng_t, xi_t) = _predictions(tab_j, tab_t,
                                              tab_j.attrs["redshift"])
    np.testing.assert_allclose(ng_t, ng_j, rtol=1e-12)
    if case != "ds-annulus-downsample":
        np.testing.assert_allclose(tab_t.tpcf_matrix, tab_j.tpcf_matrix,
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(xi_t, xi_j, rtol=1e-9, atol=1e-12)
        return
    # The annulus mean: tabcorr_tpu's float32 sums of the ln(rp) channel
    # (~1e-6 of a cell) move its estimator by ~1e-5 of the table's largest
    # entry (8.0e-6 on this catalog; the bracket cancels ~10-100x in the
    # inner annuli); the port's float64 sums are held to the float64
    # oracle of test_torch_paircount.py::test_mean_delta_sigma.  Here:
    # 5e-5 of the largest entry.
    scale = np.abs(tab_j.tpcf_matrix).max()
    np.testing.assert_allclose(tab_t.tpcf_matrix, tab_j.tpcf_matrix,
                               rtol=0, atol=5e-5 * scale)
    np.testing.assert_allclose(xi_t, xi_j, rtol=0,
                               atol=5e-5 * np.abs(xi_j).max())


def test_s_mu_multipoles_match():
    tab_j, tab_t = _tabulate_both("s_mu")
    for order in (0, 2, 4):
        m_j = j_multipole(tab_j, MU, order)
        m_t = t_multipole(tab_t, MU, order)
        assert m_t.tpcf_shape == m_j.tpcf_shape == (5,)
        np.testing.assert_allclose(m_t.tpcf_matrix, m_j.tpcf_matrix,
                                   rtol=1e-9, atol=1e-12)
        (_, xi_j), (_, xi_t) = _predictions(m_j, m_t, 0.0)
        np.testing.assert_allclose(xi_t, xi_j, rtol=1e-9, atol=1e-12)
    xi = np.random.default_rng(0).normal(size=(3, 5, 5))
    from tabcorr_tpu.ops.multipole import tpcf_multipole as j_tm
    from tabcorr_tpu_torch.ops.multipole import tpcf_multipole as t_tm
    np.testing.assert_allclose(t_tm(xi, MU, 2), j_tm(xi, MU, 2), rtol=1e-12)


def test_generic_path_matches_tabcorr_tpu():
    # A user callable runs on the per-bin-pair farm (two threads here).
    def wp_j(*args, **kwargs):
        return tt.corrfunc.wp(*args, **kwargs)

    def wp_t(*args, **kwargs):
        return tp.corrfunc.wp(*args, device="cpu", **kwargs)

    cat_j, cat_t = _catalogs()
    kw = {**BASE, "mode": "auto", "prim_haloprop_bins": 3}
    tab_j = tt.TabCorr.tabulate(cat_j, wp_j, BINS, 20.0, num_threads=2,
                                **kw)
    tab_t = tp.TabCorr.tabulate(cat_t, wp_t, BINS, 20.0, num_threads=2,
                                device="cpu", **kw)
    fast = tp.TabCorr.tabulate(cat_t, tp.corrfunc.wp, BINS, 20.0,
                               device="cpu", **kw)
    _assert_same_gal_type(tab_j, tab_t)
    assert tab_t.attrs["tpcf"] == "wp_t"
    np.testing.assert_allclose(tab_t.tpcf_matrix, tab_j.tpcf_matrix,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tab_t.tpcf_matrix, fast.tpcf_matrix,
                               rtol=1e-9, atol=1e-12)


def test_dense_mock_and_populate_mock_tracers_equal():
    cat_j, cat_t = _catalogs(redshift=0.3)
    kw = dict(sats_per_prim_haloprop=3e-12, prim_haloprop_key="halo_mvir",
              num_ptcl_requirement=300)
    for models in ((None, None),
                   ("velocity_bias", (dict(alpha_c=0.2),
                                      dict(conc_gal_bias=2.0, alpha_s=0.9)))):
        mocks = []
        for mod, cat in ((jmock, cat_j), (tmock, cat_t)):
            extra = {}
            if models[0]:
                extra = dict(
                    cens_prof_model=mod.CentralVelocityBiasPhaseSpace(
                        redshift=0.3, **models[1][0]),
                    sats_prof_model=mod.NFWPhaseSpace(redshift=0.3,
                                                      **models[1][1]))
            mocks.append(mod.populate_dense_mock(
                cat, np.random.default_rng(7), **kw, **extra))
        for key in ("pos", "vel", "halo_index", "is_central"):
            np.testing.assert_array_equal(mocks[1][key], mocks[0][key])
    z = [mod.apply_redshift_space_distortions(
        mocks[0]["pos"][:, 2], mocks[0]["vel"][:, 2], 0.3, cat.cosmology,
        LBOX) for mod, cat in ((jmock, cat_j), (tmock, cat_t))]
    np.testing.assert_array_equal(z[1], z[0])
    # populate_mock with each package's zheng07.
    pops = [mod.populate_mock(cat, pkg.Zheng07Model(threshold=-20,
                                                    redshift=0.3),
                              np.random.default_rng(8))
            for mod, pkg, cat in ((jmock, tt, cat_j), (tmock, tp, cat_t))]
    for key in ("pos", "vel", "halo_index", "is_central"):
        np.testing.assert_array_equal(pops[1][key], pops[0][key])


def test_cosmology_matches():
    z = np.array([0.0, 0.25, 0.5, 1.0, 2.5])
    pairs = [(tt.cosmology.Planck15, tp.cosmology.Planck15)]
    for suite, i in (("AbacusSummit", 0), ("AbacusSummit", 4),
                     ("AemulusAlpha", 3), ("AemulusAlpha", 42)):
        pairs.append((tt.database.cosmology(suite, i),
                      tp.database.cosmology(suite, i)))
    pairs.append((tt.cosmology.Flatw0waCDM(70, 0.3, w0=-0.9, wa=0.2,
                                           Tcmb0=2.7255, m_nu=0.06),
                  tp.cosmology.Flatw0waCDM(70, 0.3, w0=-0.9, wa=0.2,
                                           Tcmb0=2.7255, m_nu=0.06)))
    pairs.append((tt.cosmology.FlatwCDM(68, 0.31, w0=-1.1),
                  tp.cosmology.FlatwCDM(68, 0.31, w0=-1.1)))
    for cj, ct in pairs:
        for fn in ("efunc", "comoving_distance", "critical_density", "Om",
                   "de_density_scale"):
            np.testing.assert_allclose(getattr(ct, fn)(z),
                                       getattr(cj, fn)(z), rtol=1e-12,
                                       err_msg=fn)
        for attr in ("H0", "Om0", "Ode0", "Onu0", "sigma8", "ns", "alphas",
                     "name"):
            assert getattr(ct, attr) == pytest.approx(getattr(cj, attr),
                                                      rel=1e-12) \
                if isinstance(getattr(cj, attr), float) else \
                getattr(ct, attr) == getattr(cj, attr)


@pytest.mark.parametrize("config", ["default", "efficient", "aemulus",
                                    "efficient_aemulus"])
def test_configuration_matches(config):
    cj, ct = tt.database.configuration(config), tp.database.configuration(
        config)
    assert ct.keys() == cj.keys()
    for key in cj:
        a, b = cj[key], ct[key]
        if callable(a):
            x = np.logspace(11, 15, 7)
            np.testing.assert_array_equal(b(x), a(x))
        elif key == "cosmo_obs":
            assert (a is None) == (b is None)
            if a is not None:
                assert b.name == a.name and b.H0 == a.H0
        else:
            np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError):
        tp.database.configuration("nope")


def test_database_read_and_helpers():
    # The checked-in 'efficient' Delta Sigma grid through the port's
    # reader (h5py imported at the read) against tabcorr_tpu's.
    ij = tt.database.read("AbacusSummit", 0.5, "ds", tab_config="efficient")
    it = tp.database.read("AbacusSummit", 0.5, "ds", tab_config="efficient")
    assert isinstance(it, tp.Interpolator)
    assert len(it.tabcorr_list) == len(ij.tabcorr_list)
    for a, b in zip(ij.tabcorr_list, it.tabcorr_list):
        np.testing.assert_array_equal(b.tpcf_matrix, a.tpcf_matrix)
    assert tp.database.simulation_name("AemulusAlpha", 41, 2) == \
        tt.database.simulation_name("AemulusAlpha", 41, 2)
    # Host helpers of the tabulation.
    rng = np.random.default_rng(2)
    log_m = rng.uniform(12, 14, 500)
    perc = rng.uniform(0, 1, 500)
    x = rng.normal(size=500)
    args = (log_m, np.linspace(12, 14, 5), perc, np.array([0, 0.5, 1.0]), x)
    for a, b in zip(tt.sort_into_bins(*args), tp.sort_into_bins(*args)):
        np.testing.assert_array_equal(b, a)
    assert tp.distribution_index(1e12, 2e12, 1.4e12) == \
        tt.distribution_index(1e12, 2e12, 1.4e12)
    conc = rng.uniform(2, 20, 300)
    np.testing.assert_array_equal(
        tp.tabulate.compute_conditional_percentiles(10 ** log_m[:300], conc),
        tt.tabulate.compute_conditional_percentiles(10 ** log_m[:300], conc))
    pos = [rng.uniform(0, 60, (n, 3)) for n in (150, 0, 90)]
    mj, sj = tt.compute_tpcf_matrix("auto", pos, "wp", 60.0,
                                    (BINS, 10.0), {})
    mt, st = tp.compute_tpcf_matrix("auto", pos, "wp", 60.0,
                                    (BINS, 10.0), {}, device="cpu")
    assert st == sj
    np.testing.assert_allclose(mt, mj, rtol=1e-12, atol=1e-12)
    sym = rng.normal(size=(6, 6))
    sym = sym + sym.T
    np.testing.assert_array_equal(tp.symmetric_matrix_to_array(sym),
                                  tt.symmetric_matrix_to_array(sym))


def test_unported_options_raise():
    _, cat_t = _catalogs()
    # mesh= shards the fast path's sweeps (test_torch_parallel_sweep.py);
    # the host counter and the generic path take none.
    with pytest.raises(ValueError, match="takes no mesh"):
        tp.TabCorr.tabulate(cat_t, "wp", BINS, 20.0, mesh=object(),
                            backend="native", device="cpu")
    with pytest.raises(ValueError, match="generic path"):
        tp.TabCorr.tabulate(cat_t, lambda *a, **k: None, BINS, 20.0,
                            mesh=object(), device="cpu")
