"""The port's NUTS on harder targets, driven by torch generators: the
mass-matrix warmup (tabcorr_tpu's tests/test_mcmc.py, its tolerances),
the zheng07 posterior over the plain float64 predictor recovering its
truth, and chains that leave an Interpolator's grid."""

import numpy as np
import pytest
import torch

import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch import mcmc

from conftest import DATA_DIR
from test_torch_mcmc_statistics import _gen, _randn


def test_nuts_mass_matrix_adaptation():
    # Anisotropic Gaussian (std 1 vs 30): the adapted diagonal metric
    # recovers both scales with at least one doubling less per step.
    scales = torch.tensor([1.0, 30.0], dtype=torch.float64)

    def log_prob(x):
        return -0.5 * torch.sum((x / scales) ** 2, dim=-1)

    positions0 = _randn(21, (8, 2))
    chain_a, _, depth_a, _ = mcmc.run_nuts(
        _gen(22), log_prob, positions0, n_warmup=300, n_steps=400,
        max_depth=9, adapt_mass_matrix=True)
    samples = chain_a[100:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(samples.std(axis=0), scales.numpy(),
                               rtol=0.25)
    _, _, depth_i, _ = mcmc.run_nuts(
        _gen(22), log_prob, positions0, n_warmup=300, n_steps=400,
        max_depth=9, adapt_mass_matrix=False)
    assert float(depth_a) <= float(depth_i) - 1.0


@pytest.mark.parametrize("sampler", ["ensemble", "nuts"])
def test_hod_posterior_recovers_truth(sampler):
    # The zheng07 posterior against data made at the true parameters,
    # over the plain float64 predictor: the truth lies inside the sampled
    # distribution.
    tab = ttt.TabCorr.read(DATA_DIR / "examples" / "bolplanck_wp.hdf5")
    model = ttt.Zheng07Model(threshold=-18, redshift=tab.attrs["redshift"])
    predict_one = ttt.make_predictor(tab, model, dtype=torch.float64,
                                     vectorized=False, device="cpu")
    _, xi_true = tab.predict(model)
    data = np.asarray(xi_true).ravel()
    inv_cov = np.diag(1.0 / (0.05 * np.abs(data)) ** 2)
    names = ("logMmin", "logM1")
    log_prob = mcmc.make_gaussian_logpost(
        predict_one, names, model.param_dict, data, inv_cov,
        bounds={"logMmin": (10.5, 12.5), "logM1": (11.5, 13.5)},
        device="cpu")
    truth = np.array([model.param_dict[k] for k in names])
    walkers0 = torch.tensor(
        truth[None] + 0.05 * np.random.default_rng(0).normal(size=(32, 2)))
    if sampler == "ensemble":
        chain, lp, accept = mcmc.run_ensemble(_gen(6), log_prob, walkers0,
                                              n_steps=150)
        samples = chain[50:].reshape(-1, 2).numpy()
        assert float(accept) > 0.1
    else:
        chain, lp, mean_depth, _ = mcmc.run_nuts(
            _gen(6), torch.vmap(log_prob), walkers0[:8], n_warmup=40,
            n_steps=60,
            max_depth=5, initial_step_size=0.01)
        samples = chain[10:].reshape(-1, 2).numpy()
        assert float(mean_depth) >= 1.0
    assert torch.isfinite(lp).all()
    mean, std = samples.mean(axis=0), samples.std(axis=0)
    assert np.all(np.abs(mean - truth) < 4 * std + 1e-3)
    assert np.all(std < 0.5)


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_chains_that_leave_the_grid_are_rejected(sampler):
    # An Interpolator's prediction is NaN outside its grid, the log
    # posterior -inf there and its gradient NaN: such leapfrog states
    # are rejected (HMC) or divergent (NUTS), never kept.
    interp = ttt.Interpolator.read(
        DATA_DIR / "AbacusSummit" / "base_c000_ph000" / "0p50" /
        "ds_efficient.hdf5")
    model = ttt.Zheng07Model(threshold=-21, redshift=0.5,
                             prim_haloprop_key="halo_m258m")
    model.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
    lo, hi = float(interp.xp[0][0]), float(interp.xp[0][-1])
    one = ttt.make_predictor(interp, model, dtype=torch.float64,
                             vectorized=False, device="cpu")
    _, xi = interp.predict(model)
    data = np.ravel(xi)
    log_prob = mcmc.make_gaussian_logpost(
        one, ("logM1", "log_eta"), model.param_dict, data,
        np.diag(1.0 / (0.3 * np.abs(data)) ** 2), device="cpu")
    reached = []

    def log_prob_batched(theta):
        reached.append(float(theta[:, 1].detach().max()))
        return torch.vmap(log_prob)(theta)

    start = torch.tensor([[model.param_dict["logM1"], hi - 0.02]] * 6,
                         dtype=torch.float64)
    if sampler == "hmc":
        chain, lp, accept = mcmc.run_hmc(_gen(1), log_prob_batched, start,
                                         n_steps=8, step_size=0.05,
                                         n_leapfrog=6)
        assert float(accept) < 1.0
    else:
        chain, lp, _, _ = mcmc.run_nuts(_gen(1), log_prob_batched, start,
                                        n_warmup=4, n_steps=8, max_depth=4,
                                        initial_step_size=0.2)
    assert max(reached) > hi            # leapfrogs left the grid
    assert not torch.isnan(chain).any()
    assert torch.isfinite(lp).all()
    assert float(chain[..., 1].min()) >= lo and float(
        chain[..., 1].max()) <= hi
