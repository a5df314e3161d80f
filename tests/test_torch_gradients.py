"""Autograd through the port's plain float64 engine against jax.grad
through tabcorr_tpu's XLA engine (1e-8 relative), and the kernel-backed
predictors' refusal to give a gradient.

The function differentiated is a fixed random linear functional of every
output, ngal and each statistic, summed over a batch; its gradient with
respect to each parameter of each row is compared.  Members: a TabCorr
in auto mode (bolplanck wp) and in cross mode (bolplanck Delta Sigma),
the ds 'efficient' Interpolator (through its log_eta spline) and the
Leauthaud11 SHMR family (its inverted stellar-to-halo-mass relation,
``utils.inversion.monotone_inverse``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.predictor import make_predictor as jax_make_predictor
from tabcorr_tpu_torch import mcmc
from tabcorr_tpu_torch.ops import fused

from conftest import DATA_DIR
from test_torch_families import port_model_of

WP = DATA_DIR / "examples" / "bolplanck_wp.hdf5"
DS = DATA_DIR / "examples" / "bolplanck_ds.hdf5"
DS_GRID = (DATA_DIR / "AbacusSummit" / "base_c000_ph000" / "0p50" /
           "ds_efficient.hdf5")
BATCH = 4


def _case(name):
    """(tabcorr_tpu object, port object, tabcorr_tpu model, port model,
    the sampled parameters)."""
    if name == "grid":
        objs = (tt.Interpolator.read(DS_GRID), ttt.Interpolator.read(DS_GRID))
        jax_model = tt.Zheng07Model(threshold=-21, redshift=0.5,
                                    prim_haloprop_key="halo_m258m")
        jax_model.param_dict.update(log_eta=0.05, alpha_s=1.0, alpha_c=0.0)
        names = ("logMmin", "sigma_logM", "logM1", "alpha", "log_eta")
    else:
        path = DS if name == "ds" else WP
        objs = (tt.TabCorr.read(path), ttt.TabCorr.read(path))
        z = float(objs[0].attrs["redshift"])
        if name == "leauthaud11":
            jax_model = tt.Leauthaud11Model(threshold=10.5, redshift=z)
            names = ("smhm_m1_0", "smhm_beta_0", "scatter_model_param1",
                     "alphasat", "bsat", "bcut")
        else:
            jax_model = tt.Zheng07Model(threshold=-18, redshift=z)
            names = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")
    return (*objs, jax_model, port_model_of(jax_model), names)


def _params(model, names, seed):
    rng = np.random.default_rng(seed)
    p = {k: np.full(BATCH, float(v)) for k, v in model.param_dict.items()}
    for k in names:
        p[k] = p[k] * (1.0 + 0.02 * rng.normal(size=BATCH))
    return p


@pytest.mark.parametrize("name", ["wp", "ds", "grid", "leauthaud11"])
def test_float64_gradients_match_jax_grad(name):
    jax_obj, obj, jax_model, model, names = _case(name)
    p = _params(model, names, 0)
    jax_fn = jax_make_predictor(jax_obj, jax_model, dtype=jnp.float64,
                                engine="xla", jit=False)
    fn = ttt.make_predictor(obj, model, dtype=torch.float64, device="cpu")
    xi0 = np.asarray(jax_fn({k: jnp.asarray(v) for k, v in p.items()})[1])
    n_xi, scale = xi0[0].size, np.max(np.abs(xi0))
    w = np.random.default_rng(1).normal(size=n_xi + 1)

    def jax_functional(sampled):
        params = {k: jnp.asarray(v) for k, v in p.items()}
        params.update(sampled)
        ngal, xi = jax_fn(params)
        # ngal ~ 1e-3 and xi ~ 1-1e3: weigh them to one scale.
        return jnp.sum(xi.reshape(BATCH, -1) @ w[1:] / scale +
                       1e3 * w[0] * ngal)

    want = jax.grad(jax_functional)({k: jnp.asarray(p[k]) for k in names})
    sampled = {k: torch.tensor(p[k], requires_grad=True) for k in names}
    params = {k: torch.tensor(v) for k, v in p.items()}
    params.update(sampled)
    ngal, xi = fn(params)
    value = torch.sum(xi.reshape(BATCH, -1) @ torch.tensor(w[1:]) / scale +
                      1e3 * w[0] * ngal)
    got = torch.autograd.grad(value, [sampled[k] for k in names])
    for k, g in zip(names, got):
        want_k = np.asarray(want[k])
        assert np.all(np.isfinite(want_k)) and np.any(want_k != 0), k
        np.testing.assert_allclose(g.numpy(), want_k, rtol=1e-8,
                                   atol=1e-8 * np.max(np.abs(want_k)),
                                   err_msg=k)


def _kernel_predictors():
    """Every kernel-backed predictor on the CPU (its plain version runs,
    and refuses a gradient as the kernel does)."""
    wp = ttt.TabCorr.read(WP)
    grid = ttt.Interpolator.read(DS_GRID)
    zheng = ttt.Zheng07Model(threshold=-18, redshift=wp.attrs["redshift"])
    grid_model = ttt.Zheng07Model(threshold=-21, redshift=0.5,
                                  prim_haloprop_key="halo_m258m")
    grid_model.param_dict.update(log_eta=0.05, alpha_s=1.0, alpha_c=0.0)
    shmr = ttt.Leauthaud11Model(threshold=10.5,
                                redshift=wp.attrs["redshift"])
    return {
        "contraction": (ttt.make_predictor(wp, zheng, engine="fused",
                                           device="cpu"), zheng),
        "bundle": (ttt.make_multi_predictor([wp, wp], zheng, device="cpu"),
                   zheng),
        "bundle densities": (ttt.make_multi_predictor([wp], shmr,
                                                      device="cpu"), shmr),
        "grid": (ttt.make_predictor(grid, grid_model, engine="fused",
                                    device="cpu"), grid_model),
    }


@pytest.mark.parametrize("route", ["contraction", "bundle",
                                   "bundle densities", "grid"])
def test_kernel_backed_predictors_refuse_a_gradient(route):
    predict, model = _kernel_predictors()[route]
    params = ttt.params_batch(model, batch_shape=(3,), device="cpu")
    key = next(iter(params))
    params[key].requires_grad_()
    out = predict(params)
    total = sum(x.sum() for x in jax.tree_util.tree_leaves(out))
    with pytest.raises(RuntimeError, match="plain float64 engine"):
        torch.autograd.grad(total, params[key])
    # Without a gradient asked for, the outputs are the plain ones.
    with torch.no_grad():
        again = predict(params)
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(again)):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0,
                                   equal_nan=True)


def test_a_sampler_over_a_kernel_raises_the_named_error():
    predict, model = _kernel_predictors()["bundle"]
    names = ("logMmin", "logM1")
    data = [np.ones(19), np.ones(19)]
    log_prob = mcmc.make_gaussian_logpost_batched(
        predict, names, model.param_dict, data, [np.eye(19)] * 2,
        device="cpu")
    start = torch.tensor([[model.param_dict[k] for k in names]] * 2,
                         dtype=torch.float32)
    with pytest.raises(RuntimeError, match=re.escape(fused.NO_GRADIENT)):
        mcmc.run_nuts(torch.Generator().manual_seed(0), log_prob, start,
                      n_warmup=1, n_steps=1)
