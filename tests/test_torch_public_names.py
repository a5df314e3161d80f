"""Public names of tabcorr_tpu that the port had lacked, and the host
path's occupation keywords, against tabcorr_tpu.

* ``ops.predict.predict`` (the occupation -> contraction pipeline in
  tensor ops) in float64 against tabcorr_tpu's in float64: 1e-12 relative
  (the same float64 quadrature and einsums, summed in another order).
* ``table.pack_symmetric`` / ``packed_index_arrays`` and the module's
  ``__all__``, ``utils.packing.packed_prefactor`` and ``utils.__all__``,
  ``io.ColumnTable.as_array``, ``HodModel.param_array``: equal.
* ``parallel.__all__``: tabcorr_tpu.parallel's names.
* ``TabCorr.mean_occupation``, ``TabCorr.predict`` and
  ``Interpolator.predict`` pass ``**occ_kwargs`` to the model's
  ``mean_occupation_centrals`` / ``_satellites``, as tabcorr_tpu's do: a
  model that reads a keyword gives the same float64 results in both
  packages (1e-12 relative), and results that the keyword changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu.io as jax_io
import tabcorr_tpu.ops.predict as jax_predict
import tabcorr_tpu.parallel as jax_parallel
import tabcorr_tpu.table as jax_table
import tabcorr_tpu.utils as jax_utils
import tabcorr_tpu_torch as ttt
import tabcorr_tpu_torch.io as port_io
import tabcorr_tpu_torch.ops.predict as port_predict
import tabcorr_tpu_torch.parallel as port_parallel
import tabcorr_tpu_torch.table as port_table
import tabcorr_tpu_torch.utils as port_utils
from tabcorr_tpu.predictor import occupation_functions as jax_occupations
from tabcorr_tpu_torch.models.protocol import occupation_functions

from conftest import DATA_DIR

TABLES = {"wp": DATA_DIR / "examples" / "bolplanck_wp.hdf5",
          "ds": DATA_DIR / "examples" / "bolplanck_ds.hdf5"}
DS_GRID = (DATA_DIR / "AbacusSummit" / "base_c000_ph000" / "0p50" /
           "ds_efficient.hdf5")


def _params(batch=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"logMmin": 11.35 + 0.1 * rng.normal(size=batch),
            "sigma_logM": 0.25 + 0.01 * rng.normal(size=batch),
            "logM0": 11.2 + 0.1 * rng.normal(size=batch),
            "logM1": 12.4 + 0.1 * rng.normal(size=batch),
            "alpha": 0.83 + 0.02 * rng.normal(size=batch)}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("separate", [False, True])
@pytest.mark.parametrize("name", list(TABLES))
def test_ops_predict_matches_tabcorr_tpu(name, separate):
    jax_tab, port_tab = (pkg.TabCorr.read(TABLES[name]) for pkg in (tt, ttt))
    params = _params()
    table = jax_tab.table_data(dtype=jnp.float64)
    occ = jax_occupations(tt.Zheng07Model(threshold=-18, redshift=0.0))
    # tabcorr_tpu's predict takes one parameter vector; the port's a batch.
    want = jax.vmap(lambda p: jax_predict.predict(
        table, *occ, p, separate_gal_type=separate))(
            {k: jnp.asarray(v) for k, v in params.items()})
    got = port_predict.predict(
        port_tab.table_data(dtype=torch.float64, device="cpu"),
        *occupation_functions(ttt.Zheng07Model(threshold=-18,
                                               redshift=0.0)),
        {k: torch.tensor(v) for k, v in params.items()},
        separate_gal_type=separate)
    for g, w in zip(got, want):
        if separate:
            assert set(g) == set(w)
            for key in w:
                _close(g[key].numpy(), w[key])
        else:
            _close(g.numpy(), w)


@pytest.mark.parametrize("n", [1, 5, 60])
def test_packing_names_match_tabcorr_tpu(n):
    rng = np.random.default_rng(n)
    sym = rng.normal(size=(n, n))
    sym = sym + sym.T
    np.testing.assert_array_equal(port_table.pack_symmetric(sym),
                                  jax_table.pack_symmetric(sym))
    for got, want in zip(port_table.packed_index_arrays(n),
                         jax_table.packed_index_arrays(n)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_utils.packed_prefactor(n),
                                  jax_utils.packed_prefactor(n))


def test_module_exports_match_tabcorr_tpu():
    assert port_table.__all__ == jax_table.__all__
    assert port_utils.__all__ == jax_utils.__all__
    assert port_parallel.__all__ == jax_parallel.__all__
    for module in (port_table, port_utils, port_parallel):
        for name in module.__all__:
            assert hasattr(module, name), (module.__name__, name)
    assert (port_parallel.BATCH_AXIS, port_parallel.TABLE_AXIS) == (
        jax_parallel.BATCH_AXIS, jax_parallel.TABLE_AXIS)


def test_column_table_as_array_and_param_array():
    cols = {"a": np.arange(4.0), "b": np.array([b"x", b"yy", b"z", b"w"]),
            "c": np.arange(8).reshape(4, 2)}
    got = port_io.ColumnTable(dict(cols)).as_array()
    want = jax_io.ColumnTable(dict(cols)).as_array()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    names = ("logM1", "alpha", "logMmin")
    np.testing.assert_array_equal(
        ttt.Zheng07Model(threshold=-19).param_array(names),
        tt.Zheng07Model(threshold=-19).param_array(names))
    assert ttt.Zheng07Model().param_array(names).dtype == np.float64


def _scaled_model(pkg, **kw):
    """zheng07 whose occupation methods read the keywords cen_scale and
    sat_scale (each method receives both, as TabCorr passes them)."""
    class ScaledZheng07(pkg.Zheng07Model):
        def mean_occupation_centrals(self, cen_scale=1.0, sat_scale=1.0,
                                     **kwargs):
            return cen_scale * super().mean_occupation_centrals(**kwargs)

        def mean_occupation_satellites(self, cen_scale=1.0, sat_scale=1.0,
                                       **kwargs):
            return sat_scale * super().mean_occupation_satellites(**kwargs)

    return ScaledZheng07(**kw)


OCC_KWARGS = {"cen_scale": 0.8, "sat_scale": 1.3}


@pytest.mark.parametrize("name", list(TABLES))
def test_tabcorr_forwards_occupation_keywords(name):
    jax_tab, port_tab = (pkg.TabCorr.read(TABLES[name]) for pkg in (tt, ttt))
    kw = dict(threshold=-18, redshift=jax_tab.attrs["redshift"])
    jax_model, port_model = (_scaled_model(pkg, **kw) for pkg in (tt, ttt))
    got = port_tab.mean_occupation(port_model, **OCC_KWARGS)
    _close(got, jax_tab.mean_occupation(jax_model, **OCC_KWARGS))
    assert not np.allclose(got, port_tab.mean_occupation(port_model))
    for separate in (False, True):
        got = port_tab.predict(port_model, separate_gal_type=separate,
                               **OCC_KWARGS)
        want = jax_tab.predict(jax_model, separate_gal_type=separate,
                               **OCC_KWARGS)
        for g, w in zip(got, want):
            for key in (w if separate else [None]):
                _close(g if key is None else g[key],
                       w if key is None else w[key])


def test_interpolator_forwards_occupation_keywords():
    jax_interp, port_interp = (pkg.Interpolator.read(DS_GRID)
                               for pkg in (tt, ttt))
    kw = dict(threshold=-21, redshift=0.5, prim_haloprop_key="halo_m258m")
    jax_model, port_model = (_scaled_model(pkg, **kw) for pkg in (tt, ttt))
    for m in (jax_model, port_model):
        m.param_dict["log_eta"] = 0.07
    got = port_interp.predict(port_model, **OCC_KWARGS)
    want = jax_interp.predict(jax_model, **OCC_KWARGS)
    for g, w in zip(got, want):
        _close(g, w)
    assert not np.allclose(got[1], port_interp.predict(port_model)[1])
