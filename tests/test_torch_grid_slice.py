"""The grid slice on the CPU, against tabcorr_tpu.

Read the 4-node xi_0/2/4 Interpolator fixture, build the fused grid
predictor, wrap it in the batched Gaussian log posterior over the five
zheng07 parameters and log_eta, then take two stretch-move steps with 32
walkers -- in both packages, with the same walkers, data and random
numbers (tabcorr_tpu's streamed grid kernel in interpret mode).

The log-probabilities are held to the bound the predictions' agreement
implies: with xi differing by at most e_i = 2e-6 max|xi| between the
packages (the fused Interpolator routes' agreement in test_torch_grid.py),
a diagonal chi^2 moves by at most sum_i |resid_i| C_ii e_i to first
order; the bound doubles that and adds 1e-5 |logp| for float32 rounding
of the chi^2 itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tabcorr_tpu as tt
import tabcorr_tpu.ops.fused as jax_fused
import tabcorr_tpu.predictor as jax_pred
import tabcorr_tpu_torch as ttt
from tabcorr_tpu import mcmc as jax_mcmc
from tabcorr_tpu_torch import mcmc

from conftest import DATA_DIR

N_WALKERS = 32
N_STEPS = 2
FIXTURE = DATA_DIR / "examples" / "synthetic_xi_ell_interp.hdf5"


def _logp_bound(xi, data, inv_cov, logp):
    xi = xi.double().numpy().reshape(len(logp), -1)
    scale = np.abs(xi).max(1, keepdims=True)
    bound = np.sum(np.abs(xi - data) * np.diag(inv_cov) * 2e-6 * scale,
                   axis=1)
    return 2 * bound + 1e-5 * np.abs(logp)


def _predictors(monkeypatch):
    jax_interp = tt.Interpolator.read(FIXTURE)
    interp = ttt.Interpolator.read(FIXTURE)
    redshift = float(interp.tabcorr_list[0].attrs["redshift"])
    jax_model = tt.Zheng07Model(threshold=-20, redshift=redshift)
    model = ttt.Zheng07Model(threshold=-20, redshift=redshift)
    for m in (jax_model, model):
        m.param_dict["log_eta"] = 0.0
    monkeypatch.setattr(jax_pred, "_fused_constants_fit_vmem",
                        lambda *a, **k: False)
    make_grid = jax_fused.make_fused_grid_predictor
    monkeypatch.setattr(jax_fused, "make_fused_grid_predictor",
                        lambda *a, **k: make_grid(*a, batch_tile=8, **k))
    jax_f = jax_pred.make_predictor(jax_interp, jax_model, engine="fused",
                                    accuracy="scaled")
    f = ttt.make_predictor(interp, model, engine="fused", accuracy="scaled",
                           device="cpu")
    return jax_model, model, jax_f, f


def test_grid_log_probabilities_and_steps_match_jax(monkeypatch):
    jax_model, model, jax_f, f = _predictors(monkeypatch)
    names = tuple(model.param_dict)
    assert names[-1] == "log_eta" and len(names) == 6

    fiducial = ttt.params_batch(model, {}, (1,), device="cpu")
    data = [f(fiducial)[1][0].double().numpy().ravel() * 1.02]
    inv_cov = [np.diag(1.0 / (0.05 * np.abs(data[0]) + 1e-3) ** 2)]
    log_prob = mcmc.make_gaussian_logpost_batched(
        lambda p: [f(p)], names, model.param_dict, data, inv_cov,
        device="cpu")
    jax_log_prob = jax_mcmc.make_gaussian_logpost_batched(
        lambda p: [jax_f(p)], names, jax_model.param_dict, data, inv_cov)

    rng = np.random.default_rng(8)
    walkers0 = (np.array([model.param_dict[k] for k in names])[None, :] +
                0.02 * rng.normal(size=(N_WALKERS, len(names)))
                ).astype(np.float32)
    half = N_WALKERS // 2
    draws = [(rng.uniform(size=half).astype(np.float32),
              rng.integers(0, half, size=half),
              rng.uniform(size=half).astype(np.float32))
             for _ in range(2 * N_STEPS)]
    uniforms = iter([a for u, _, ua in draws for a in (u, ua)])
    picks = iter([p for _, p, _ in draws])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(next(uniforms)))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(next(picks)))
    port_draws = iter(draws)
    monkeypatch.setattr(mcmc, "_stretch_draws", lambda *a: tuple(
        torch.tensor(x) for x in next(port_draws)))

    walkers = torch.tensor(walkers0)
    lp = log_prob(walkers)
    jax_walkers = jnp.asarray(walkers0)
    jax_lp = jax_log_prob(jax_walkers)
    generator = torch.Generator().manual_seed(0)
    for step in range(N_STEPS + 1):
        got, want = lp.double().numpy(), np.asarray(jax_lp, np.float64)
        assert np.all(np.isfinite(got))
        xi = f(dict(zip(names, walkers.T)))[1]
        bound = _logp_bound(xi, data[0], inv_cov[0], got)
        assert np.all(np.abs(got - want) <= bound), (step, np.max(
            np.abs(got - want) / bound))
        np.testing.assert_allclose(walkers.numpy(), np.asarray(jax_walkers),
                                   rtol=1e-6, atol=1e-6)
        if step == N_STEPS:
            break
        walkers, lp, accept = mcmc.ensemble_step(
            generator, walkers, lp, log_prob, vectorized=True)
        jax_walkers, jax_lp, jax_accept = jax_mcmc.ensemble_step(
            jax.random.key(step), jax_walkers, jax_lp, jax_log_prob,
            vectorized=True)
        assert float(accept) == float(jax_accept)
        assert 0.0 < float(accept) < 1.0


def test_walker_outside_the_grid_gets_minus_infinity(monkeypatch):
    jax_model, model, jax_f, f = _predictors(monkeypatch)
    names = tuple(model.param_dict)
    data = [f(ttt.params_batch(model, {}, (1,), device="cpu"))[1][0]
            .double().numpy().ravel()]
    inv_cov = [np.eye(len(data[0]))]
    theta = np.array([[model.param_dict[k] for k in names]] * 8, np.float32)
    theta[[2, 5], -1] = [0.5, -0.6]      # log_eta beyond both grid ends
    for lp in (mcmc.make_gaussian_logpost_batched(
                   lambda p: [f(p)], names, model.param_dict, data, inv_cov,
                   device="cpu")(torch.tensor(theta)).numpy(),
               np.asarray(jax_mcmc.make_gaussian_logpost_batched(
                   lambda p: [jax_f(p)], names, jax_model.param_dict, data,
                   inv_cov)(jnp.asarray(theta)))):
        out = np.isin(np.arange(8), [2, 5])
        assert np.all(lp[out] == -np.inf)
        assert np.all(np.isfinite(lp[~out]))
