"""The port's zheng07 occupation against tabcorr_tpu's and numpy float64.

Nodes are the float32 quadrature nodes (with their float64 residuals) of
the wp and xi_ell tables; parameters fill a wide box: logMmin 10.5-13.5,
sigma_logM 0.1-1.0, logM0 and logM1 within +-1 dex of their threshold -18
values, alpha 0.5-1.5.

Tolerance: 1e-6 relative plus the float32 conditioning of the expression
at that element.  Rounding the inputs of erfc(y) to float32 moves the
result by kappa(y) = |y erfc'(y) / erfc(y)| times a few ulp, which reaches
~1e-5 in the deep tail (y ~ 8); the satellite law exp(E) carries the
rounding of its exponent E, and 10^(logM0 - logM) rounded near the M0
kink is amplified by ratio / (1 - ratio).  Both packages show the same
per-node errors there (they evaluate the same float32 expressions); what
the statistics need is checked in test_torch_bundle.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erfc

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.models.zheng07 import (zheng07_centrals as jax_centrals,
                                        zheng07_satellites as jax_satellites)

from conftest import DATA_DIR

ULP = 2.0 ** -24
LN10 = np.log(10.0)


def _wide_box(batch, seed):
    rng = np.random.default_rng(seed)
    box = {"logMmin": rng.uniform(10.5, 13.5, batch),
           "sigma_logM": rng.uniform(0.1, 1.0, batch),
           "logM0": 11.2 + rng.uniform(-1.0, 1.0, batch),
           "logM1": 12.4 + rng.uniform(-1.0, 1.0, batch),
           "alpha": rng.uniform(0.5, 1.5, batch)}
    return {k: v.astype(np.float32) for k, v in box.items()}


def _tolerance(gal_type, p, node):
    """1e-6 plus 8 ulp times the float32 condition number (see module
    docstring), elementwise; ``p`` holds float64 (B, 1, 1) parameters."""
    if gal_type == "centrals":
        y = -(node - p["logMmin"]) / p["sigma_logM"]
        kappa = np.abs(y) * 2.0 / np.sqrt(np.pi) * np.exp(-y * y) / erfc(y)
        return 1e-6 + 8 * ULP * (1.0 + kappa)
    ratio = np.minimum(10.0 ** (p["logM0"] - node), 1.0 - 1e-6)
    exponent = p["alpha"] * LN10 * (node - p["logM1"])
    return 1e-6 + 8 * ULP * (1.0 + np.abs(exponent) + p["alpha"] * LN10 *
                             (np.abs(node - p["logM1"]) +
                              ratio / (1.0 - ratio)))


@pytest.mark.parametrize("gal_type", ["centrals", "satellites"])
@pytest.mark.parametrize("fixture", ["bolplanck_wp", "synthetic_xi_ell"])
def test_float32_occupation_matches_jax_and_float64(fixture, gal_type):
    table = ttt.TabCorr.read(DATA_DIR / "examples" / f"{fixture}.hdf5")
    data = table.table_data(n_gauss=10, dtype=torch.float32, device="cpu")
    logm, res = data.log_prim_quad, data.log_prim_quad_lo
    node = logm.double().numpy() + res.double().numpy()
    box = _wide_box(256, seed=3)
    model = ttt.Zheng07Model(threshold=-18)

    got = model.occupation_residual(
        {k: torch.tensor(v)[:, None, None] for k, v in box.items()},
        gal_type, logm, res, None).double().numpy()
    jax_fn = jax_centrals if gal_type == "centrals" else jax_satellites
    ref = np.asarray(jax_fn(
        {k: jnp.asarray(v)[:, None, None] for k, v in box.items()},
        jnp.asarray(logm.numpy()), log_prim_res=jnp.asarray(res.numpy())),
        dtype=np.float64)
    p64 = {k: v.astype(np.float64)[:, None, None] for k, v in box.items()}
    want = jax_fn(p64, node)

    mask = want > 1e-30
    assert mask.sum() > 0.4 * mask.size
    tol = np.broadcast_to(_tolerance(gal_type, p64, node), want.shape)[mask]
    err_port = np.abs(got[mask] / want[mask] - 1)
    err_jax = np.abs(ref[mask] / want[mask] - 1)
    assert np.all(err_port <= tol), np.max(err_port / tol)
    assert np.all(err_jax <= tol), np.max(err_jax / tol)
    assert np.all(np.abs(got[mask] / ref[mask] - 1) <= 2 * tol)
    # The plain 1e-6 holds wherever the conditioning term is small.
    benign = tol <= 2e-6
    assert benign.mean() > 0.05
    assert np.max(err_port[benign]) <= 1e-6
    np.testing.assert_array_equal(got[~mask & (want == 0)], 0.0)


@pytest.mark.parametrize("modulate", [False, True])
def test_numpy_host_occupation_equals_jax_package(modulate):
    kwargs = dict(threshold=-20, modulate_with_cenocc=modulate,
                  logM0=12.1)
    port = ttt.Zheng07Model(**kwargs)
    ref = tt.Zheng07Model(**kwargs)
    prim = 10.0 ** np.linspace(10.0, 15.5, 301)
    for method in ("mean_occupation_centrals", "mean_occupation_satellites"):
        np.testing.assert_array_equal(
            getattr(port, method)(prim_haloprop=prim),
            getattr(ref, method)(prim_haloprop=prim))


def test_generic_residual_uses_forward_mode_derivative():
    # The protocol's default absorbs the node residual to first order;
    # for zheng07 it agrees with the exact override in float64 up to the
    # second-order term, ~(3e-7 / sigma)^2 relative.
    model = ttt.Zheng07Model(threshold=-18)
    params = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in model.param_dict.items()}
    logm = torch.linspace(11.0, 14.5, 40, dtype=torch.float64)
    res = torch.full_like(logm, 3e-7)
    for gal_type in ("centrals", "satellites"):
        exact = model.occupation_residual(params, gal_type, logm, res, None)
        generic = ttt.HodModel.occupation_residual(model, params, gal_type,
                                                   logm, res, None)
        torch.testing.assert_close(generic, exact, rtol=1e-10, atol=1e-300)


def test_model_rejects_unknown_threshold_and_parameters():
    with pytest.raises(ValueError):
        ttt.Zheng07Model(threshold=-17)
    with pytest.raises(ValueError):
        ttt.Zheng07Model(threshold=-18, log_eta=0.1)
