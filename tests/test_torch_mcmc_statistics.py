"""The port's HMC and NUTS sample their targets: tabcorr_tpu's statistical
tests (tests/test_mcmc.py) with their tolerances, driven by torch
generators, and the chain diagnostics against tabcorr_tpu's on the same
numpy chains (1e-12) and on their own statistical cases.  The mass-matrix
warmup and the HOD posteriors are in test_torch_mcmc_posteriors.py."""

import numpy as np
import pytest
import torch

from tabcorr_tpu import mcmc as jax_mcmc
from tabcorr_tpu_torch import mcmc


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(seed, shape, scale=1.0):
    return scale * torch.randn(shape, generator=_gen(seed),
                               dtype=torch.float64)


def _gaussian(theta):
    mean = torch.tensor([1.0, -2.0], dtype=theta.dtype)
    sigma = torch.tensor([0.5, 2.0], dtype=theta.dtype)
    return -0.5 * torch.sum(((theta - mean) / sigma) ** 2, dim=-1)


def test_hmc_samples_gaussian():
    chain, lp, accept = mcmc.run_hmc(
        _gen(2), _gaussian, _randn(3, (8, 2)), n_steps=400, step_size=0.25,
        n_leapfrog=8)
    assert chain.shape == (400, 8, 2) and lp.shape == (400, 8)
    assert float(accept) > 0.6
    samples = chain[100:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(samples.mean(axis=0), [1.0, -2.0], atol=0.25)
    np.testing.assert_allclose(samples.std(axis=0), [0.5, 2.0], rtol=0.25)


def test_hmc_adaptive_tunes_step_size():
    chain, lp, accept, step_size = mcmc.run_hmc_adaptive(
        _gen(7), _gaussian, _randn(8, (8, 2)), n_warmup=150, n_steps=300,
        n_leapfrog=8, initial_step_size=1.5)
    # Dual averaging pulls the acceptance rate to the target zone.
    assert 0.6 < float(accept) < 0.95
    assert 0.01 < step_size < 1.5
    samples = chain[100:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(samples.mean(axis=0), [1.0, -2.0], atol=0.3)


def test_nuts_samples_gaussian():
    chain, lp, mean_depth, step_size = mcmc.run_nuts(
        _gen(11), _gaussian, _randn(12, (8, 2)), n_warmup=100, n_steps=800,
        max_depth=6, initial_step_size=0.5)
    samples = chain[100:].reshape(-1, 2).numpy()
    assert float(mean_depth) >= 1.0
    np.testing.assert_allclose(samples.mean(axis=0), [1.0, -2.0], atol=0.25)
    np.testing.assert_allclose(samples.std(axis=0), [0.5, 2.0], rtol=0.2)


def test_nuts_correlated_gaussian():
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    prec = torch.tensor(np.linalg.inv(cov))

    def log_prob(theta):
        return -0.5 * torch.sum((theta @ prec) * theta, dim=-1)

    chain, lp, mean_depth, step_size = mcmc.run_nuts(
        _gen(13), log_prob, _randn(14, (8, 2), 0.1), n_warmup=100,
        n_steps=600, max_depth=7, initial_step_size=0.3)
    samples = chain[150:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.15)
    # NUTS exploits the correlated geometry with multi-step trees.
    assert float(mean_depth) > 1.5


def test_nuts_accept_stat_in_range():
    # The warmup adapts on the accumulated Metropolis alpha: a statistic
    # in [0, 1] that decreases with the step size.
    accepts = []
    for eps in (0.05, 5.0):
        _, _, _, accept, _ = mcmc.nuts_step(
            _gen(0), torch.zeros((1, 2), dtype=torch.float64), _gaussian,
            eps, max_depth=5)
        a = float(accept[0])
        assert 0.0 <= a <= 1.0
        accepts.append(a)
    assert accepts[0] > 0.9
    assert accepts[1] < accepts[0]


def test_nuts_stable_on_heavy_tailed_target():
    # Student-t (df=3): the warmup still delivers a usable step size and
    # calibrated samples.
    df = 3.0

    def log_prob(x):
        return torch.sum(-0.5 * (df + 1) * torch.log1p(x ** 2 / df), dim=-1)

    chain, lp, mean_depth, step_size = mcmc.run_nuts(
        _gen(2), log_prob, _randn(1, (8, 1), 0.5), n_warmup=100,
        n_steps=300, max_depth=5)
    samples = chain[80:].reshape(-1).numpy()
    assert np.isfinite(step_size) and step_size > 1e-3
    assert np.all(np.isfinite(samples))
    # The median |x| of Student-t(3) is ~0.765.
    med = np.median(np.abs(samples))
    assert 0.5 < med < 1.1, med


def test_nuts_early_exit_saves_gradients():
    # Trajectories stop paying gradients when they turn: ~2^3 leapfrogs on
    # a well-conditioned Gaussian, far below 2^max_depth = 256.
    generator = _gen(5)
    grads = []
    for _ in range(16):
        *_, n_grad = mcmc.nuts_step(
            generator, torch.zeros((1, 2), dtype=torch.float64), _gaussian,
            0.3, max_depth=8)
        grads.append(int(n_grad[0]))
    assert max(grads) < 100
    assert np.mean(grads) < 40


def test_nuts_batch_freezes_finished_chains():
    # In one batched step every chain's gradient count is its own
    # trajectory's: 16 chains together spend what 16 single-chain steps
    # fed the same draws spend.
    q0 = _randn(6, (16, 2))
    batched = mcmc.nuts_step(_gen(9), q0, _gaussian, 0.3, max_depth=8)
    assert len(set(batched[4].tolist())) > 1

    class Row:
        """The batch's draws, one chain's column at a time."""

        def __init__(self, draws, row):
            self.draws, self.row = draws, row

        def __getattr__(self, name):
            fn = getattr(self.draws, name)
            return lambda *a: fn(*a)[self.row:self.row + 1]

    class Recorded(mcmc.GeneratorDraws):
        """A generator's draws, keyed by what they stand for."""

        def __init__(self, generator):
            super().__init__(generator)
            self.memo = {}

        def _memo(self, key, fn):
            if key not in self.memo:
                self.memo[key] = fn()
            return self.memo[key]

        def momentum(self, n, d, dtype, device):
            return self._memo("p", lambda: super(Recorded, self).momentum(
                16, d, dtype, device))

        def forward(self, k, n, device):
            return self._memo(("f", k), lambda: super(
                Recorded, self).forward(k, 16, device))

        def leaf_uniform(self, k, i, n, dtype, device):
            return self._memo(("l", k, i), lambda: super(
                Recorded, self).leaf_uniform(k, i, 16, dtype, device))

        def pick_uniform(self, k, n, dtype, device):
            return self._memo(("u", k), lambda: super(
                Recorded, self).pick_uniform(k, 16, dtype, device))

    draws = Recorded(_gen(10))
    together = mcmc.nuts_step(draws, q0, _gaussian, 0.3, max_depth=8)
    for row in range(16):
        alone = mcmc.nuts_step(Row(draws, row), q0[row:row + 1], _gaussian,
                               0.3, max_depth=8)
        for a, b in zip(alone, together):
            torch.testing.assert_close(a[0], b[row], rtol=1e-12, atol=0)


# ---- diagnostics ----------------------------------------------------
def _chains():
    rng = np.random.default_rng(4)
    ar = np.empty((3000, 6, 2))
    ar[0] = rng.normal(size=(6, 2))
    for t in range(1, 3000):
        ar[t] = 0.8 * ar[t - 1] + 0.6 * rng.normal(size=(6, 2))
    drift = rng.normal(size=(400, 4, 3))
    drift[200:] += 1.5
    return {"ar1": ar, "iid": rng.normal(size=(500, 8, 3)),
            "drift": drift, "single": rng.normal(size=(700, 2)),
            "short": rng.normal(size=(5, 3, 1))}


@pytest.mark.parametrize("name", ["ar1", "iid", "drift", "single",
                                  "short"])
def test_diagnostics_match_jax(name):
    chain = _chains()[name]
    for fn in ("integrated_autocorr_time", "effective_sample_size",
               "gelman_rubin"):
        want = getattr(jax_mcmc, fn)(chain)
        got = getattr(mcmc, fn)(chain)
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=fn)
        # A tensor chain reads the same.
        np.testing.assert_allclose(getattr(mcmc, fn)(torch.tensor(chain)),
                                   want, rtol=1e-12, err_msg=fn)
    with pytest.raises(ValueError):
        mcmc.gelman_rubin(chain[:3])
    with pytest.raises(ValueError):
        mcmc.integrated_autocorr_time(chain.reshape(-1))


def test_autocorr_time_ar1():
    # AR(1) with coefficient rho: tau = (1 + rho) / (1 - rho) within ~15%.
    rho = 0.9
    rng = np.random.default_rng(0)
    n, w = 40000, 8
    eps = rng.normal(size=(n, w, 2))
    x = np.empty((n, w, 2))
    x[0] = eps[0]
    for t in range(1, n):
        x[t] = rho * x[t - 1] + np.sqrt(1 - rho ** 2) * eps[t]
    tau = mcmc.integrated_autocorr_time(x)
    assert tau.shape == (2,)
    np.testing.assert_allclose(tau, (1 + rho) / (1 - rho), rtol=0.15)
    tau_iid = mcmc.integrated_autocorr_time(rng.normal(size=(4000, 8, 3)))
    np.testing.assert_allclose(tau_iid, 1.0, atol=0.25)


def test_effective_sample_size_and_split_rhat():
    rng = np.random.default_rng(1)
    ess = mcmc.effective_sample_size(rng.normal(size=(2000, 16, 2)))
    assert np.all(ess > 0.7 * 2000 * 16) and np.all(ess < 1.4 * 2000 * 16)
    rhat = mcmc.gelman_rubin(rng.normal(size=(4000, 8, 3)))
    assert rhat.shape == (3,) and np.all(rhat < 1.01)
    stuck = rng.normal(size=(4000, 8, 1)) + np.arange(8)[None, :, None]
    assert mcmc.gelman_rubin(stuck)[0] > 1.5
    drift = rng.normal(size=(4000, 8, 1))
    drift[2000:] += 3.0
    assert mcmc.gelman_rubin(drift)[0] > 1.5


def test_diagnostics_on_nuts_chain():
    # The diagnostics read run_nuts' output directly and report
    # convergence on a well-mixed Gaussian.
    chain, _, _, _ = mcmc.run_nuts(_gen(3), _gaussian, _randn(4, (16, 2)),
                                   n_warmup=100, n_steps=600)
    assert np.all(mcmc.integrated_autocorr_time(chain) < 10)
    assert np.all(mcmc.effective_sample_size(chain) > 1000)
    assert np.all(mcmc.gelman_rubin(chain[100:]) < 1.05)
