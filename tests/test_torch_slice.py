"""The whole slice on the CPU, against tabcorr_tpu.

Read both bench tables, build the multi-statistic predictor, wrap it in
the batched Gaussian log posterior, then take three stretch-move steps
with 64 walkers -- in both packages, with the same walkers, data and
random numbers (tabcorr_tpu's bundle in interpret mode).

The log-probabilities are held to the bound the predictions' contracts
imply: with xi differing by at most e_i between the packages (1e-6 of
|xi_i| for wp, 1e-6 of max|xi| for xi_ell), a diagonal chi^2 moves by at
most sum_i |resid_i| C_ii e_i to first order; the bound doubles that and
adds 1e-5 |logp| for float32 rounding of the chi^2 itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu import mcmc as jax_mcmc
from tabcorr_tpu.predictor import make_multi_predictor as jax_multi_predictor
from tabcorr_tpu_torch import mcmc

from conftest import DATA_DIR

N_WALKERS = 64
N_STEPS = 3
ACCURACY = ("elementwise", "scaled")


def _logp_bound(predictions, data, inv_cov, logp):
    bound = np.zeros(len(logp))
    for k, ((_, xi), d, c) in enumerate(zip(predictions, data, inv_cov)):
        xi = xi.double().numpy().reshape(len(logp), -1)
        scale = np.abs(xi) if k == 0 else np.abs(xi).max(1, keepdims=True)
        bound += np.sum(np.abs(xi - d) * np.diag(c) * 1e-6 * scale, axis=1)
    return 2 * bound + 1e-5 * np.abs(logp)


def test_slice_log_probabilities_and_steps_match_jax(monkeypatch):
    files = [DATA_DIR / "examples" / f for f in
             ("bolplanck_wp.hdf5", "synthetic_xi_ell.hdf5")]
    jax_tabs = [tt.TabCorr.read(f) for f in files]
    tabs = [ttt.TabCorr.read(f) for f in files]
    redshift = float(tabs[0].attrs["redshift"])
    jax_model = tt.Zheng07Model(threshold=-18, redshift=redshift)
    model = ttt.Zheng07Model(threshold=-18, redshift=redshift)
    names = tuple(model.param_dict)

    predict = ttt.make_multi_predictor(tabs, model, device="cpu",
                                       accuracy=ACCURACY)
    jax_predict = jax_multi_predictor(
        jax_tabs, jax_model, engine="bundle", accuracy=ACCURACY,
        batch_tile=N_WALKERS // 2, interpret=True)

    fiducial = ttt.params_batch(model, {}, (1,), device="cpu")
    data = [xi[0].double().numpy().ravel() * 1.02
            for _, xi in predict(fiducial)]
    inv_cov = [np.diag(1.0 / (0.05 * np.abs(d) + 1e-3) ** 2) for d in data]
    log_prob = mcmc.make_gaussian_logpost_batched(
        predict, names, model.param_dict, data, inv_cov, device="cpu")
    jax_log_prob = jax_mcmc.make_gaussian_logpost_batched(
        jax_predict, names, jax_model.param_dict, data, inv_cov)

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
        params = dict(zip(names, walkers.T))
        bound = _logp_bound(predict(params), data, inv_cov, got)
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
