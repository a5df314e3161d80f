"""The bfloat16 routes beyond a TabCorr's plain engine, against
tabcorr_tpu's XLA engine in bfloat16, under test_torch_bf16_models.py's
bar (max(2 x tabcorr_tpu's error, 2^-8) against float64 at the
parameters as received):

* the plain engine on the synthetic xi_ell and the ds 'efficient'
  Interpolators, rows in and out of the grid (NaN in exactly
  tabcorr_tpu's rows), separate_gal_type, vectorized=False,
  make_occupation_predictor and params_batch;
* the fused engine on the CPU (the bfloat16 contraction's plain version)
  for a TabCorr and an Interpolator, fed bfloat16 parameters, against the
  XLA engine fed the same ones (tabcorr_tpu's own fused bfloat16 route
  fails, test_torch_bf16_tables.py).  Its ngal and xi are bfloat16, and a
  rounding to bfloat16 costs up to 2^-8 of the element, an error the XLA
  engine's float32 results do not carry: the bar adds 2^-8 for each
  rounding of the route's results (the contraction's, and for an
  Interpolator the spline's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.predictor import make_occupation_predictor as \
    jax_make_occupation_predictor
from tabcorr_tpu.predictor import make_predictor as jax_make_predictor
from tabcorr_tpu.predictor import params_batch as jax_params_batch

from conftest import DATA_DIR
from test_torch_bf16_models import (FLOOR, TABLES, as_received,  # noqa: F401
                                    check_against_jax, errors, f64, objects)
from test_torch_interpolator import FIXTURES, _models

BATCH = 24


@pytest.fixture(scope="module")
def interps():
    return {k: (tt.Interpolator.read(f), ttt.Interpolator.read(f))
            for k, f in FIXTURES.items()}


def _grid_draw(kind, jax_interp, seed):
    """zheng07 parameters within 1% of the model's; the grid keys uniform
    over the grid and 10% beyond it on either side, the first two rows on
    its ends."""
    rng = np.random.default_rng(seed)
    mid = {k: float(np.mean(x)) for k, x in zip(jax_interp.keys,
                                                  jax_interp.xp)}
    jax_model, model = _models(kind, jax_interp, **mid)
    p = {k: v + 0.01 * abs(v) * rng.normal(size=BATCH)
         for k, v in jax_model.param_dict.items()}
    for k, x in zip(jax_interp.keys, jax_interp.xp):
        span = x[-1] - x[0]
        p[k] = rng.uniform(x[0] - 0.1 * span, x[-1] + 0.1 * span, BATCH)
        p[k][:2] = x[0], x[-1]
    return jax_model, model, p


def _nan_rows(x):
    x = f64(x)
    return np.isnan(x.reshape(len(x), -1)).any(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(FIXTURES))
def test_plain_engine_on_interpolators(interps, kind, dtype):
    jax_interp, interp = interps[kind]
    jax_model, model, p = _grid_draw(kind, jax_interp, seed=3)
    port_p, p64, jax_p = as_received(p, dtype)
    got = ttt.make_predictor(interp, model, dtype=torch.bfloat16,
                             engine="plain", device="cpu")(port_p)
    want = jax_make_predictor(jax_interp, jax_model, dtype=jnp.bfloat16,
                              engine="xla")(jax_p)
    ref = ttt.make_predictor(interp, model, dtype=torch.float64,
                             engine="plain", device="cpu")(p64)
    assert got[0].dtype == got[1].dtype == torch.float32
    for g, w in zip(got, want):
        # NaN outside the bfloat16 grid, in exactly tabcorr_tpu's rows.
        np.testing.assert_array_equal(_nan_rows(g), _nan_rows(w))
    assert 0 < _nan_rows(got[1]).sum() < BATCH
    check_against_jax(got, want, ref, (kind, dtype))


def test_separate_gal_type(objects, interps):  # noqa: F811
    jax_tab, tab = objects["wp"]
    jax_interp, interp = interps["xi"]
    jax_model, model, p = _grid_draw("xi", jax_interp, seed=4)
    port_p, p64, jax_p = as_received(p, torch.float32)
    for jax_obj, obj in ((jax_tab, tab), (jax_interp, interp)):
        got = ttt.make_predictor(obj, model, dtype=torch.bfloat16,
                                 separate_gal_type=True,
                                 device="cpu")(port_p)
        want = jax_make_predictor(jax_obj, jax_model, dtype=jnp.bfloat16,
                                  separate_gal_type=True)(jax_p)
        ref = ttt.make_predictor(obj, model, dtype=torch.float64,
                                 separate_gal_type=True,
                                 device="cpu")(p64)
        for gd, wd, rd in zip(got, want, ref):
            assert set(gd) == set(wd)
            for key in wd:
                if key == "centrals-centrals" and obj is tab:
                    continue     # cancels to ~0 at small scales: no scale
                np.testing.assert_array_equal(_nan_rows(gd[key]),
                                              _nan_rows(wd[key]))
                check_against_jax((gd[key], gd[key]), (wd[key], wd[key]),
                                  (rd[key], rd[key]), key)


def test_unbatched_parameters(objects):  # noqa: F811
    """vectorized=False: 0-d float32 tensors promote the bfloat16 table to
    float32 as tabcorr_tpu's 0-d float32 arrays do; Python floats stay
    weakly typed there and become bfloat16 parameters here."""
    jax_tab, tab = objects["wp"]
    jax_model = tt.Zheng07Model(threshold=-19)
    model = ttt.Zheng07Model(threshold=-19)
    f = ttt.make_predictor(tab, model, dtype=torch.bfloat16,
                           vectorized=False, device="cpu")
    jax_f = jax_make_predictor(jax_tab, jax_model, dtype=jnp.bfloat16,
                               vectorized=False)
    ref = ttt.make_predictor(tab, model, dtype=torch.float64, device="cpu")
    for dtype in (torch.float32, torch.bfloat16):
        port_p, p64, jax_p = as_received(
            {k: np.float64(v) for k, v in model.param_dict.items()}, dtype)
        got, want = f(port_p), jax_f(jax_p)
        assert got[0].shape == () and got[1].shape == tuple(tab.tpcf_shape)
        assert got[1].dtype == torch.float32
        want_ref = ref({k: v.reshape(1) for k, v in p64.items()})
        check_against_jax((got[0][None], got[1][None]),
                          (np.asarray(want[0])[None],
                           np.asarray(want[1])[None]),
                          want_ref, dtype)
    floats = f(dict(model.param_dict))
    assert floats[1].dtype == torch.float32
    batched = torch.vmap(f)({k: torch.full((3,), v)
                             for k, v in model.param_dict.items()})
    assert batched[1].shape == (3,) + tuple(tab.tpcf_shape)


def test_occupation_predictor_and_params_batch(objects):  # noqa: F811
    jax_tab, tab = objects["wp"]
    rng = np.random.default_rng(5)
    occ = rng.uniform(0.0, 2.0, (BATCH, tab.n_bins))
    occ_bf16 = torch.tensor(occ).to(torch.bfloat16)
    got = ttt.make_occupation_predictor(tab, dtype=torch.bfloat16,
                                        device="cpu")(occ)
    want = jax_make_occupation_predictor(jax_tab, dtype=jnp.bfloat16)(occ)
    ref = ttt.make_occupation_predictor(tab, dtype=torch.float64,
                                        device="cpu")(occ_bf16.double())
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert want[1].dtype == jnp.bfloat16
    check_against_jax(got, want, ref, "occupation")

    model, jax_model = ttt.Zheng07Model(), tt.Zheng07Model()
    over = {"logMmin": rng.normal(12.0, 0.1, 5)}
    have = ttt.params_batch(model, over, (5,), torch.bfloat16, device="cpu")
    want = jax_params_batch(jax_model, over, (5,), jnp.bfloat16)
    for k in want:
        assert have[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(have[k].view(torch.int16).numpy(),
                                      np.asarray(want[k]).view(np.int16))


def _fused_case(jax_obj, obj, jax_model, model, p, roundings):
    port_p, p64, jax_p = as_received(p, torch.bfloat16)
    got = ttt.make_predictor(obj, model, dtype=torch.bfloat16,
                             engine="fused", device="cpu")(port_p)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert got[1].shape == (BATCH,) + tuple(
        (obj if isinstance(obj, ttt.TabCorr) else
         obj.tabcorr_list[0]).tpcf_shape)
    want = jax_make_predictor(jax_obj, jax_model, dtype=jnp.bfloat16,
                              engine="xla")(jax_p)
    ref = ttt.make_predictor(obj, model, dtype=torch.float64,
                             engine="plain", device="cpu")(p64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_nan_rows(g), _nan_rows(w))
    # ngal: one rounding (the contraction's total); xi: ``roundings``.
    for have, bar, k in zip(errors(got, ref), errors(want, ref),
                            (1, roundings)):
        assert have <= max(2.0 * bar, FLOOR) + k * FLOOR, (have, bar)


@pytest.mark.parametrize("table", list(TABLES))
def test_fused_route_on_a_tabcorr(objects, table):  # noqa: F811
    jax_tab, tab = objects[table]
    jax_model = tt.Zheng07Model(threshold=-18)
    rng = np.random.default_rng(6)
    p = {k: v + 0.01 * abs(v) * rng.normal(size=BATCH)
         for k, v in jax_model.param_dict.items()}
    _fused_case(jax_tab, tab, jax_model, ttt.Zheng07Model(threshold=-18), p,
                roundings=1)


@pytest.mark.parametrize("kind", list(FIXTURES))
def test_fused_route_on_an_interpolator(interps, kind):
    jax_interp, interp = interps[kind]
    jax_model, model, p = _grid_draw(kind, jax_interp, seed=7)
    _fused_case(jax_interp, interp, jax_model, model, p, roundings=2)


def test_fused_route_refuses_a_gradient(objects):  # noqa: F811
    _, tab = objects["wp"]
    model = ttt.Zheng07Model()
    p = {k: torch.full((2,), v, requires_grad=True)
         for k, v in model.param_dict.items()}
    ngal, xi = ttt.make_predictor(tab, model, dtype=torch.bfloat16,
                                  engine="fused", device="cpu")(p)
    with pytest.raises(RuntimeError, match="compute no gradient"):
        xi.float().sum().backward()
    assert jax.default_backend() == "cpu"
