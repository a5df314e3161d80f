"""The port's tabulation layer against tabcorr_tpu's, array by array."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch.ops.predict import TableData

from conftest import DATA_DIR

FIXTURES = ["examples/bolplanck_wp.hdf5", "examples/bolplanck_ds.hdf5",
            "examples/synthetic_xi_ell.hdf5", "regression/synthetic_wp.hdf5"]
FIELDS = ("tpcf_dense", "n_h", "log_prim_quad", "quad_weight", "sec_perc",
          "log_prim_quad_lo")
PACKAGE_DATA = DATA_DIR.parent.parent / "tabcorr_tpu_torch" / "data"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_table_data_equals_jax_exactly(fixture, dtype):
    ref = tt.TabCorr.read(DATA_DIR / fixture).table_data(
        n_gauss=10, dtype=getattr(jnp, dtype))
    got = ttt.TabCorr.read(DATA_DIR / fixture).table_data(
        n_gauss=10, dtype=getattr(torch, dtype), device="cpu")
    for field in FIELDS:
        want = getattr(ref, field)
        have = getattr(got, field)
        if want is None:
            assert have is None, field
            continue
        assert have.dtype == getattr(torch, dtype), field
        np.testing.assert_array_equal(have.numpy(), np.asarray(want),
                                      err_msg=field)
    assert got.mode == ref.mode
    assert got.tpcf_shape == tuple(int(s) for s in ref.tpcf_shape)
    assert all(type(s) is int for s in got.tpcf_shape)
    assert got.n_centrals == ref.n_centrals


def test_from_numpy_round_trips_jax_arrays():
    ref = tt.TabCorr.read(DATA_DIR / FIXTURES[0]).table_data(
        n_gauss=10, dtype=jnp.float32)
    arrays = {f: np.array(getattr(ref, f)) for f in FIELDS}
    got = TableData.from_numpy(arrays, ref.mode, ref.tpcf_shape,
                               ref.n_centrals, device="cpu",
                               dtype=torch.float32)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      arrays[field], err_msg=field)
    # A copy, not a view of the caller's arrays.
    arrays["n_h"][0] += 1.0
    assert got.n_h[0].item() != arrays["n_h"][0]


def _assert_same_tabulation(a, b):
    assert a.attrs == b.attrs
    np.testing.assert_array_equal(a.tpcf_matrix, b.tpcf_matrix)
    assert a.tpcf_matrix.dtype == b.tpcf_matrix.dtype == np.float64
    assert a.tpcf_shape == b.tpcf_shape
    assert len(a.tpcf_args) == len(b.tpcf_args)
    for x, y in zip(a.tpcf_args, b.tpcf_args):
        np.testing.assert_array_equal(x, y)
    assert a.tpcf_kwargs.keys() == b.tpcf_kwargs.keys()
    for key in a.tpcf_kwargs:
        np.testing.assert_array_equal(a.tpcf_kwargs[key], b.tpcf_kwargs[key])
    assert a.gal_type.colnames == b.gal_type.colnames
    for name in a.gal_type.colnames:
        np.testing.assert_array_equal(a.gal_type[name], b.gal_type[name])
        assert a.gal_type[name].dtype == b.gal_type[name].dtype


@pytest.mark.parametrize("fixture", FIXTURES)
def test_npz_and_hdf5_reads_agree(fixture, tmp_path):
    from_hdf5 = ttt.TabCorr.read(DATA_DIR / fixture)
    from_hdf5.write_npz(tmp_path / "table.npz")
    _assert_same_tabulation(ttt.TabCorr.read(tmp_path / "table.npz"),
                            from_hdf5)


@pytest.mark.parametrize("name", ["bolplanck_wp", "synthetic_xi_ell"])
def test_packaged_npz_copies_match_hdf5(name):
    _assert_same_tabulation(
        ttt.TabCorr.read(PACKAGE_DATA / f"{name}.npz"),
        ttt.TabCorr.read(DATA_DIR / "examples" / f"{name}.hdf5"))


@pytest.mark.parametrize("fixture", FIXTURES)
def test_float64_host_predict_matches_jax(fixture):
    ref_tab = tt.TabCorr.read(DATA_DIR / fixture)
    got_tab = ttt.TabCorr.read(DATA_DIR / fixture)
    z = float(ref_tab.attrs["redshift"])
    ref_model = tt.Zheng07Model(threshold=-18, redshift=z, logM1=12.7)
    got_model = ttt.Zheng07Model(threshold=-18, redshift=z, logM1=12.7)
    ngal_ref, xi_ref = ref_tab.predict(ref_model)
    ngal, xi = got_tab.predict(got_model)
    assert xi.shape == xi_ref.shape
    np.testing.assert_allclose(ngal, ngal_ref, rtol=1e-13)
    np.testing.assert_allclose(xi, xi_ref, rtol=1e-12,
                               atol=1e-13 * np.max(np.abs(xi_ref)))


def test_consistency_check_rejects_mismatched_model():
    tab = ttt.TabCorr.read(DATA_DIR / FIXTURES[0])
    with pytest.raises(ValueError):
        tab.predict(ttt.Zheng07Model(threshold=-18, redshift=1.0))
    with pytest.raises(ValueError):
        tab.predict(ttt.Zheng07Model(
            threshold=-18, redshift=tab.attrs["redshift"],
            prim_haloprop_key="halo_m200m"))


def test_table_data_needs_an_explicit_device():
    tab = ttt.TabCorr.read(DATA_DIR / FIXTURES[0])
    with pytest.raises(ValueError):
        tab.table_data(device=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tab.table_data(device="cuda")
