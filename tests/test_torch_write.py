"""The port's HDF5 writers against tabcorr_tpu's readers, and the other way
round: ``TabCorr.write``, ``Interpolator.write`` and
``ColumnTable.write_hdf5`` in the reference schema; the ``.npz`` writer's
``max_args_size`` rule; ``"w-"`` / ``overwrite``; writing into an open
group; the ImportError without h5py.
"""

import builtins
from pathlib import Path

import h5py
import numpy as np
import pytest

import tabcorr_tpu as tt
import tabcorr_tpu_torch as tp
from tabcorr_tpu_torch.io import ColumnTable

DATA = Path(__file__).absolute().parent / "data"
WP = DATA / "examples" / "bolplanck_wp.hdf5"
DS_INTERP = (DATA / "AbacusSummit" / "base_c000_ph000" / "0p50" /
             "ds_efficient.hdf5")


def _ds_table(pkg, n_ptcl):
    """A cross-mode Delta Sigma table whose particle positions, (n_ptcl,
    3), are its first tpcf argument (the published 'efficient' file's
    binning and matrix, the delta-sigma estimator attribute set)."""
    src = tt.Interpolator.read(DS_INTERP).tabcorr_list[0]
    tab = pkg.TabCorr()
    tab.attrs = {**src.attrs, "delta_sigma_estimator": "annulus_mean",
                 "unset": None}
    tab.gal_type = pkg.io.ColumnTable(
        {k: src.gal_type[k] for k in src.gal_type.colnames})
    tab.tpcf_matrix = src.tpcf_matrix.copy()
    tab.tpcf_shape = tuple(src.tpcf_shape)
    positions = np.random.default_rng(0).uniform(0, 100, (n_ptcl, 3))
    tab.tpcf_args = (positions, 3.2e10, np.logspace(-1, 1.6, 14))
    tab.tpcf_kwargs = {"estimator_weights": np.ones(n_ptcl)}
    return tab


def _assert_same_table(a, b, dropped=()):
    """Attributes (those not None), args, kwargs, gal_type and the matrix
    (float32 both ways) of two tabulations, with the tpcf arguments of
    ``dropped`` indices absent from ``b``."""
    assert {k: v for k, v in a.attrs.items() if v is not None} == b.attrs
    kept = [x for i, x in enumerate(a.tpcf_args) if i not in dropped]
    assert len(b.tpcf_args) == len(kept)
    for x, y in zip(kept, b.tpcf_args):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    big = [k for k, v in a.tpcf_kwargs.items()
           if isinstance(v, np.ndarray) and v.size >= 1000000]
    assert sorted(b.tpcf_kwargs) == sorted(set(a.tpcf_kwargs) - set(big))
    for key in b.tpcf_kwargs:
        np.testing.assert_array_equal(b.tpcf_kwargs[key], a.tpcf_kwargs[key])
    assert tuple(b.tpcf_shape) == tuple(a.tpcf_shape)
    assert b.gal_type.colnames == a.gal_type.colnames
    for col in a.gal_type.colnames:
        np.testing.assert_array_equal(b.gal_type[col], a.gal_type[col])
    assert b.tpcf_matrix.dtype == np.float64
    np.testing.assert_array_equal(
        b.tpcf_matrix, a.tpcf_matrix.astype(np.float32).astype(np.float64))


def test_wp_table_round_trips_both_ways(tmp_path):
    src = tp.TabCorr.read(WP)
    src.tpcf_matrix = src.tpcf_matrix * (1 + 1e-9)   # not float32-exact
    src.write(tmp_path / "port.hdf5")
    got = tt.TabCorr.read(tmp_path / "port.hdf5")
    _assert_same_table(src, got)
    ref = tt.TabCorr.read(WP)
    ref.write(tmp_path / "ref.hdf5")
    _assert_same_table(ref, tp.TabCorr.read(tmp_path / "ref.hdf5"))
    # Both packages write the same datasets and attributes.
    with h5py.File(tmp_path / "port.hdf5") as a, \
            h5py.File(tmp_path / "ref.hdf5") as b:
        names = []
        a.visit(names.append)
        other = []
        b.visit(other.append)
        assert names == other
        assert sorted(a.attrs) == sorted(b.attrs)


@pytest.mark.parametrize("n_ptcl", [400000, 2000])
def test_delta_sigma_table_drops_large_args(tmp_path, n_ptcl):
    # 400,000 x 3 positions pass the default max_args_size of 10^6
    # elements and are dropped, with the weights kwarg of 400,000 kept;
    # 2,000 x 3 stay.
    port = _ds_table(tp, n_ptcl)
    port.write(tmp_path / "port.hdf5")
    dropped = (0,) if n_ptcl * 3 >= 1000000 else ()
    _assert_same_table(port, tt.TabCorr.read(tmp_path / "port.hdf5"),
                       dropped)
    ref = _ds_table(tt, n_ptcl)
    ref.write(tmp_path / "ref.hdf5")
    _assert_same_table(ref, tp.TabCorr.read(tmp_path / "ref.hdf5"), dropped)
    # max_args_size moves the cut: the 2,000-row kwarg and positions go.
    port.write(tmp_path / "small.hdf5", max_args_size=1000)
    with h5py.File(tmp_path / "small.hdf5") as fstream:
        assert sorted(fstream["tpcf_args"]) == ["arg_1", "arg_2"]
        assert "tpcf_kwargs" not in fstream
        assert fstream.attrs["delta_sigma_estimator"] == "annulus_mean"
        assert "unset" not in fstream.attrs


def test_write_npz_drops_large_args(tmp_path):
    # Before max_args_size reached write_npz, a Delta Sigma table carried
    # its particle positions: 400,000 x 3 float64, 9.6 MB.
    tab = _ds_table(tp, 400000)
    del tab.attrs["unset"]     # JSON keeps a None; HDF5 cannot
    tab.write_npz(tmp_path / "ds.npz")
    with np.load(tmp_path / "ds.npz") as data:
        assert "tpcf_args.arg_0" not in data.files
        assert "tpcf_kwargs.estimator_weights" in data.files
    assert (tmp_path / "ds.npz").stat().st_size < tab.tpcf_args[0].nbytes
    back = tp.TabCorr.read(tmp_path / "ds.npz")
    _assert_same_table(tab, back, dropped=(0,))
    tab.write(tmp_path / "ds.hdf5")
    hdf5 = tp.TabCorr.read(tmp_path / "ds.hdf5")
    for x, y in zip(hdf5.tpcf_args, back.tpcf_args):
        np.testing.assert_array_equal(x, y)
    tab.write_npz(tmp_path / "all.npz", max_args_size=10 ** 7)
    with np.load(tmp_path / "all.npz") as data:
        assert data["tpcf_args.arg_0"].shape == (400000, 3)


def test_interpolator_round_trips_both_ways(tmp_path):
    ref = tt.Interpolator.read(DS_INTERP)
    ref.write(tmp_path / "ref.hdf5")
    port = tp.Interpolator.read(tmp_path / "ref.hdf5")
    port.write(tmp_path / "port.hdf5")
    back = tt.Interpolator.read(tmp_path / "port.hdf5")
    assert port.keys == ref.keys == back.keys
    for key in ref.param_dict_table.colnames:
        np.testing.assert_array_equal(port.param_dict_table[key],
                                      ref.param_dict_table[key])
        np.testing.assert_array_equal(back.param_dict_table[key],
                                      ref.param_dict_table[key])
    for a, b, c in zip(ref.tabcorr_list, port.tabcorr_list,
                       back.tabcorr_list):
        _assert_same_table(a, b)
        _assert_same_table(b, c)
    # The port's npz copy reads back the same, and both predict alike.
    port.write_npz(tmp_path / "port.npz")
    npz = tp.Interpolator.read(tmp_path / "port.npz")
    kw = dict(threshold=-21, redshift=0.5, prim_haloprop_key="halo_m258m")
    m_t, m_j = tp.Zheng07Model(**kw), tt.Zheng07Model(**kw)
    for m in (m_t, m_j):
        m.param_dict["log_eta"] = 0.1
    ng_j, ds_j = back.predict(m_j, check_consistency=False)
    for interp in (port, npz):
        ng_t, ds_t = interp.predict(m_t, check_consistency=False)
        np.testing.assert_allclose(ng_t, ng_j, rtol=1e-12)
        np.testing.assert_allclose(ds_t, ds_j, rtol=1e-12)


def test_unordered_grid_keeps_node_order(tmp_path):
    # A grid table given out of sorted order: tabcorr_index ties each row
    # to its node through both writers.
    tabs = [tp.TabCorr.read(WP) for _ in range(4)]
    for i, t in enumerate(tabs):
        t.tpcf_matrix = t.tpcf_matrix * (1 + i)
    interp = tp.Interpolator(tabs, ColumnTable(
        {"log_eta": np.array([0.3, -0.1, 0.1, -0.3])}))
    interp.write(tmp_path / "grid.hdf5")
    ref = tt.Interpolator.read(tmp_path / "grid.hdf5")
    port = tp.Interpolator.read(tmp_path / "grid.hdf5")
    for got in (ref, port):
        for i, t in enumerate(got.tabcorr_list):
            np.testing.assert_array_equal(
                t.tpcf_matrix, tabs[i].tpcf_matrix.astype(np.float32))
        np.testing.assert_array_equal(got.param_dict_table["log_eta"],
                                      interp.param_dict_table["log_eta"])


def test_overwrite_and_open_groups(tmp_path):
    tab = tp.TabCorr.read(WP)
    path = tmp_path / "wp.hdf5"
    tab.write(path)
    with pytest.raises((FileExistsError, OSError)):
        tab.write(path)
    tab.tpcf_matrix = tab.tpcf_matrix * 2
    tab.write(path, overwrite=True)
    np.testing.assert_array_equal(tt.TabCorr.read(path).tpcf_matrix,
                                  tab.tpcf_matrix.astype(np.float32))
    interp = tp.Interpolator([tab] * 4, ColumnTable(
        {"alpha_s": np.linspace(0.8, 1.2, 4)}))
    interp.write(tmp_path / "grid.hdf5")
    with pytest.raises((FileExistsError, OSError)):
        interp.write(tmp_path / "grid.hdf5")
    interp.write(tmp_path / "grid.hdf5", overwrite=True)
    # An open file and a group inside it, as the reference writes nodes.
    with h5py.File(tmp_path / "groups.hdf5", "w") as fstream:
        tab.write(fstream.create_group("node"))
        ColumnTable({"a": np.arange(3.0)}).write_hdf5(fstream, "cols")
        tab.write(fstream)
    _assert_same_table(tab, tt.TabCorr.read(tmp_path / "groups.hdf5"))
    with h5py.File(tmp_path / "groups.hdf5") as fstream:
        _assert_same_table(tab, tt.TabCorr.read(fstream["node"]))
        np.testing.assert_array_equal(fstream["cols"]["a"], np.arange(3.0))
    with h5py.File(tmp_path / "half.hdf5", "w") as fstream:
        tab.write(fstream, matrix_dtype=np.float64)
        assert fstream["tpcf_matrix"].dtype == np.float64


def test_write_without_h5py_raises(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py" or name.startswith("h5py."):
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    tab = tp.TabCorr.read(WP)
    interp = tp.Interpolator([tab] * 4, ColumnTable(
        {"alpha_s": np.linspace(0.8, 1.2, 4)}))
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py.*write_npz"):
        tab.write(tmp_path / "wp.hdf5")
    with pytest.raises(ImportError, match="h5py.*write_npz"):
        interp.write(tmp_path / "grid.hdf5")
    assert not (tmp_path / "wp.hdf5").exists()
    # The npz writers need numpy alone.
    tab.write_npz(tmp_path / "wp.npz")
    interp.write_npz(tmp_path / "grid.npz")
    assert tp.Interpolator.read(tmp_path / "grid.npz").keys == ["alpha_s"]
