"""The port's Interpolator, splines and grid I/O against tabcorr_tpu.

The host path (numpy float64) must agree with tabcorr_tpu's exactly for
the spline matrices and to 1e-12 relative for predictions; the tensor
spline ``spline_eval`` to 1e-12 in float64 and 1e-6 in float32 (its sums
run in another order).  Both checked-in 4-node Interpolator fixtures are
read: the cross-mode 'efficient' Delta Sigma grid (1104 bins) and the
auto-mode xi_0/2/4 grid (120 bins).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu import interpolator as jax_interp
from tabcorr_tpu.io import ColumnTable as JaxColumnTable
from tabcorr_tpu_torch import interpolator
from tabcorr_tpu_torch.io import ColumnTable

from conftest import DATA_DIR

PACKAGE_DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / \
    "data"
FIXTURES = {
    "ds": DATA_DIR / "AbacusSummit" / "base_c000_ph000" / "0p50" /
    "ds_efficient.hdf5",
    "xi": DATA_DIR / "examples" / "synthetic_xi_ell_interp.hdf5",
}


@pytest.fixture(scope="module")
def interps():
    return {k: (tt.Interpolator.read(f), ttt.Interpolator.read(f))
            for k, f in FIXTURES.items()}


def _models(kind, interp, **grid):
    """The same zheng07 model in both packages, grid keys set."""
    if kind == "ds":
        kw = dict(threshold=-21, redshift=0.5, prim_haloprop_key="halo_m258m")
    else:
        kw = dict(threshold=-20,
                  redshift=float(interp.tabcorr_list[0].attrs["redshift"]))
    out = (tt.Zheng07Model(**kw), ttt.Zheng07Model(**kw))
    for m in out:
        m.param_dict.update(grid)
    return out


def test_column_table_matches_tabcorr_tpu():
    rng = np.random.default_rng(0)
    cols = {"b": rng.integers(0, 3, 12).astype(float),
            "a": rng.integers(0, 2, 12).astype(float),
            "c": rng.normal(size=12)}
    got, want = ColumnTable(cols), JaxColumnTable(cols)
    for t in (got, want):
        t["s"] = 1.5
        t.sort(["a", "b"])
    assert list(got) == list(want) == ["b", "a", "c", "s"]
    for k in want.colnames:
        np.testing.assert_array_equal(got[k], want[k])
    copy = got.copy()
    copy.remove_column("c")
    copy["a"][0] = 99.0
    assert "c" in got and "c" not in copy and got["a"][0] != 99.0
    with pytest.raises(ValueError):
        got["bad"] = np.zeros(3)


def test_spline_matrix_and_host_interpolation_equal_tabcorr_tpu():
    rng = np.random.default_rng(1)
    xps = [np.sort(rng.uniform(-1, 1, 5)), np.linspace(0.8, 1.2, 4)]
    a = [interpolator.spline_interpolation_matrix(xp) for xp in xps]
    for got, xp in zip(a, xps):
        np.testing.assert_array_equal(
            got, jax_interp.spline_interpolation_matrix(xp))
    yp = rng.normal(size=(5, 4, 3))
    for x, extrapolate in (([0.1, 1.0], False), ([xps[0][0], 1.2], False),
                           ([-2.0, 1.3], True)):
        np.testing.assert_array_equal(
            interpolator.spline_interpolate(x, xps, a, yp, extrapolate),
            jax_interp.spline_interpolate(x, xps, a, yp, extrapolate))
    for mod in (interpolator, jax_interp):
        with pytest.raises(ValueError, match="outside"):
            mod.spline_interpolate([-2.0, 1.0], xps, a, yp)
        with pytest.raises(ValueError, match="less than 4"):
            mod.spline_interpolation_matrix([0.0, 1.0, 2.0])


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_spline_eval_matches_jax(dtype, tol):
    rng = np.random.default_rng(2)
    xp = np.array([-0.4, -0.1, 0.15, 0.4, 0.7])
    a = interpolator.spline_interpolation_matrix(xp)
    yp = rng.normal(size=(5, 3, 2))
    xs = [-0.4, -0.25, 0.0, 0.15, 0.39, 0.7, -0.5, 0.9]
    for extrapolate in (True, False):
        for x in xs:
            got = interpolator.spline_eval(
                torch.tensor(x, dtype=torch.float64 if dtype == np.float64
                             else torch.float32),
                torch.tensor(xp.astype(dtype)), torch.tensor(a.astype(dtype)),
                torch.tensor(yp.astype(dtype)), extrapolate=extrapolate)
            want = np.asarray(jax_interp.spline_eval(
                jnp.asarray(x, dtype), jnp.asarray(xp.astype(dtype)),
                jnp.asarray(a.astype(dtype)), jnp.asarray(yp.astype(dtype)),
                extrapolate=extrapolate), np.float64)
            got = got.double().numpy()
            assert got.shape == want.shape == (3, 2)
            if not extrapolate and not xp[0] <= x <= xp[-1]:
                assert np.all(np.isnan(got)) and np.all(np.isnan(want))
                continue
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # A batch of x evaluates row by row.
    x = torch.tensor(xs)
    batched = interpolator.spline_eval(x, torch.tensor(xp, dtype=torch.float32),
                                       torch.tensor(a, dtype=torch.float32),
                                       torch.tensor(yp, dtype=torch.float32),
                                       extrapolate=False)
    assert batched.shape == (len(xs), 3, 2)
    assert torch.isnan(batched[-2:]).all() and \
        torch.isfinite(batched[:-2]).all()


@pytest.mark.parametrize("kind", ["ds", "xi"])
def test_read_matches_tabcorr_tpu(interps, kind):
    want, got = interps[kind]
    assert got.keys == want.keys
    assert repr(got) == repr(want)
    for a, b in zip(got.xp, want.xp):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.a, want.a):
        np.testing.assert_array_equal(a, b)
    assert got.param_dict_table.colnames == want.param_dict_table.colnames
    for k in want.param_dict_table.colnames:
        np.testing.assert_array_equal(got.param_dict_table[k],
                                      want.param_dict_table[k])
    assert got.unique_gal_type_index == want.unique_gal_type_index
    np.testing.assert_array_equal(got.unique_gal_type_inverse,
                                  want.unique_gal_type_inverse)
    for a, b in zip(got.tabcorr_list, want.tabcorr_list):
        np.testing.assert_array_equal(a.tpcf_matrix, b.tpcf_matrix)
        assert a.tpcf_shape == tuple(b.tpcf_shape)


@pytest.mark.parametrize("kind", ["ds", "xi"])
@pytest.mark.parametrize("separate", [False, True])
def test_host_predict_matches_tabcorr_tpu(interps, kind, separate):
    want_i, got_i = interps[kind]
    for log_eta in (-0.3, 0.0, 0.2):
        jax_model, model = _models(kind, got_i, log_eta=log_eta)
        want = want_i.predict(jax_model, separate_gal_type=separate,
                              check_consistency=False)
        got = got_i.predict(model, separate_gal_type=separate,
                            check_consistency=False)
        for g, w in zip(got, want):
            if separate:
                assert g.keys() == w.keys()
                pairs = [(g[k], w[k]) for k in w]
            else:
                pairs = [(g, w)]
            for a, b in pairs:
                np.testing.assert_allclose(a, b, rtol=1e-12,
                                           atol=1e-12 * np.max(np.abs(b)))


def test_host_predict_raises_outside_the_grid_and_clamps_on_request(
        interps):
    want_i, got_i = interps["xi"]
    jax_model, model = _models("xi", got_i, log_eta=0.9)
    for interp, m in ((want_i, jax_model), (got_i, model)):
        with pytest.raises(ValueError, match="outside"):
            interp.predict(m, check_consistency=False)
    got = got_i.predict(model, extrapolate=True, check_consistency=False)
    want = want_i.predict(jax_model, extrapolate=True,
                          check_consistency=False)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    del model.param_dict["log_eta"]
    with pytest.raises(ValueError, match="log_eta"):
        got_i.predict(model, check_consistency=False)


def test_grid_validation():
    tabs = ttt.Interpolator.read(PACKAGE_DATA / "ds_efficient.npz"
                                 ).tabcorr_list
    diagonal = {"p": [0.0, 1.0, 2.0, 3.0], "q": [0.0, 1.0, 2.0, 3.0]}
    with pytest.raises(ValueError, match="grid"):
        ttt.Interpolator(tabs, ColumnTable(diagonal))
    with pytest.raises(ValueError, match="grid"):
        tt.Interpolator(tabs, JaxColumnTable(diagonal))
    with pytest.raises(ValueError, match="less than 4"):
        ttt.Interpolator(tabs, ColumnTable({"p": [0.0, 1.0, 1.0, 2.0]}))
    with pytest.raises(ValueError, match="number of TabCorr"):
        ttt.Interpolator(tabs[:3], ColumnTable(
            {"log_eta": [0.0, 0.1, 0.2, 0.3]}))


def test_npz_equals_hdf5(tmp_path):
    from_hdf5 = ttt.Interpolator.read(FIXTURES["ds"])
    pairs = [(ttt.Interpolator.read(PACKAGE_DATA / "ds_efficient.npz"),
              from_hdf5)]
    xi = ttt.Interpolator.read(FIXTURES["xi"])
    xi.write_npz(tmp_path / "xi.npz")
    pairs.append((ttt.Interpolator.read(tmp_path / "xi.npz"), xi))
    for got, want in pairs:
        assert got.keys == want.keys
        for k in want.param_dict_table.colnames:
            np.testing.assert_array_equal(got.param_dict_table[k],
                                          want.param_dict_table[k])
        for a, b in zip(got.tabcorr_list, want.tabcorr_list):
            assert a.attrs == {k: (v.item() if isinstance(v, np.generic)
                                   else v) for k, v in b.attrs.items()}
            np.testing.assert_array_equal(a.tpcf_matrix, b.tpcf_matrix)
            assert a.tpcf_shape == b.tpcf_shape
            np.testing.assert_array_equal(a.gal_type.as_structured_array(),
                                          b.gal_type.as_structured_array())
