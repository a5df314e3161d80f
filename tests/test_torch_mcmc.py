"""The port's stretch-move sampler and batched log posterior against
tabcorr_tpu.mcmc, fed the same inputs and the same random numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tabcorr_tpu import mcmc as jax_mcmc
from tabcorr_tpu_torch import mcmc

NAMES = ("logMmin", "logM1", "alpha")
BASE = {"logMmin": 11.35, "sigma_logM": 0.25, "logM0": 11.2, "logM1": 12.4,
        "alpha": 0.83}


def _linear_predictor(xp):
    """A two-statistic stand-in for the bundle predictor, identical in
    both frameworks: xi = theta @ A + c with theta the five parameters."""
    rng = np.random.default_rng(0)
    mats = [rng.normal(size=(5, 6)), rng.normal(size=(5, 4))]
    keys = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")

    def predict_all(params):
        theta = xp.stack([params[k] for k in keys], axis=-1)
        out = []
        for m in mats:
            m = xp.asarray(m, dtype=theta.dtype)
            out.append((theta.sum(-1), theta @ m + 1.0))
        return out

    return predict_all


def _posterior_inputs():
    rng = np.random.default_rng(1)
    data = [rng.normal(size=6) + 2.0, rng.normal(size=4) + 2.0]
    inv_cov = []
    for d in data:
        a = rng.normal(size=(d.size, d.size))
        inv_cov.append(a @ a.T / d.size + np.eye(d.size))
    theta = (np.array([BASE[k] for k in NAMES])[None, :] +
             0.05 * rng.normal(size=(32, len(NAMES)))).astype(np.float32)
    theta[3, 1] = 20.0                        # outside the logM1 bound
    return data, inv_cov, theta


def test_gaussian_logpost_batched_matches_jax():
    data, inv_cov, theta = _posterior_inputs()
    kwargs = dict(bounds={"logM1": (11.0, 14.0)}, ngal_data=30.0,
                  ngal_sigma=0.5)
    ref = jax_mcmc.make_gaussian_logpost_batched(
        _linear_predictor(jnp), NAMES, BASE, data, inv_cov, **kwargs)(
        jnp.asarray(theta))
    got = mcmc.make_gaussian_logpost_batched(
        _linear_predictor(torch), NAMES, BASE, data, inv_cov,
        device="cpu", **kwargs)(torch.tensor(theta))
    assert got.dtype == torch.float32 and got.shape == (32,)
    ref = np.asarray(ref, np.float64)
    got = got.double().numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    assert np.isinf(got[3])
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-6)


def _gauss_torch(theta):
    mean = torch.tensor([1.0, -2.0], dtype=theta.dtype)
    sigma = torch.tensor([0.5, 2.0], dtype=theta.dtype)
    return -0.5 * torch.sum(((theta - mean) / sigma) ** 2, dim=-1)


def _gauss_jax(theta):
    mean = jnp.array([1.0, -2.0], dtype=theta.dtype)
    sigma = jnp.array([0.5, 2.0], dtype=theta.dtype)
    return -0.5 * jnp.sum(((theta - mean) / sigma) ** 2, axis=-1)


@pytest.mark.parametrize("vectorized", [True, False])
def test_stretch_half_matches_jax_with_shared_draws(monkeypatch, vectorized):
    rng = np.random.default_rng(2)
    active = rng.normal(size=(24, 2)).astype(np.float32)
    passive = rng.normal(size=(24, 2)).astype(np.float32)
    u = rng.uniform(size=24).astype(np.float32)
    picks = rng.integers(0, 24, size=24)
    u_accept = rng.uniform(size=24).astype(np.float32)
    uniforms = iter([u, u_accept])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(next(uniforms)))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(picks))

    lp_active = np.asarray(_gauss_jax(jnp.asarray(active)))
    ref = jax_mcmc._stretch_half(
        jax.random.key(0), jnp.asarray(active), jnp.asarray(passive),
        jnp.asarray(lp_active), _gauss_jax, 2.0, vectorized=vectorized)
    got = mcmc._stretch_half(
        (torch.tensor(u), torch.tensor(picks), torch.tensor(u_accept)),
        torch.tensor(active), torch.tensor(passive), torch.tensor(lp_active),
        _gauss_torch, 2.0, vectorized=vectorized)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert 0 < int(got[2].sum()) < 24
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-5, atol=1e-6)


def test_ensemble_samples_gaussian():
    generator = torch.Generator().manual_seed(0)
    walkers0 = torch.randn((64, 2), generator=generator)
    chain, lp, accept = mcmc.run_ensemble(generator, _gauss_torch, walkers0,
                                          n_steps=600, vectorized=True)
    assert chain.shape == (600, 64, 2) and lp.shape == (600, 64)
    assert 0.2 < float(accept) < 0.9
    samples = chain[200:].reshape(-1, 2).double().numpy()
    np.testing.assert_allclose(samples.mean(axis=0), [1.0, -2.0], atol=0.15)
    np.testing.assert_allclose(samples.std(axis=0), [0.5, 2.0], rtol=0.15)


def test_ensemble_step_keeps_log_prob_consistent():
    generator = torch.Generator().manual_seed(4)
    walkers = torch.randn((32, 2), generator=generator)
    lp = torch.vmap(_gauss_torch)(walkers)
    new, new_lp, accept = mcmc.ensemble_step(generator, walkers, lp,
                                             _gauss_torch)
    assert new.shape == walkers.shape
    assert 0.0 <= float(accept) <= 1.0
    torch.testing.assert_close(_gauss_torch(new), new_lp)


def test_run_ensemble_thins_and_is_reproducible():
    def run():
        generator = torch.Generator().manual_seed(5)
        walkers0 = torch.randn((16, 2), generator=generator)
        return mcmc.run_ensemble(generator, _gauss_torch, walkers0,
                                 n_steps=12, thin=3, vectorized=True)

    chain, lp, _ = run()
    again, _, _ = run()
    assert chain.shape == (4, 16, 2) and lp.shape == (4, 16)
    torch.testing.assert_close(chain, again, rtol=0, atol=0)
