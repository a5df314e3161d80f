"""The port's HMC and NUTS against tabcorr_tpu.mcmc, step for step.

tabcorr_tpu draws its random numbers from a JAX key tree; the port's
samplers draw through the methods of ``mcmc.GeneratorDraws``.
``JaxDraws`` computes each of those numbers with the same ``jax.random``
calls on the same keys as tabcorr_tpu, so both packages run the same
trajectories: positions and log probabilities are held at 1e-10
relative, the accept flags, depths and gradient counts exactly, the
accept statistics at 1e-10.  Targets: a 2-D Gaussian, a correlated one
and the zheng07 posterior over the plain float64 bolplanck wp predictor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu import mcmc as jax_mcmc
from tabcorr_tpu.predictor import make_predictor as jax_make_predictor
from tabcorr_tpu_torch import mcmc

from conftest import DATA_DIR

RTOL = 1e-10


def _split2(keys):
    return jax.vmap(jax.random.split)(keys)


_normal = jax.jit(jax.vmap(
    lambda k, n: jax.random.normal(k, (n,), dtype=jnp.float64),
    in_axes=(0, None)), static_argnums=1)
_uniform = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, ())))
_doubling_keys = jax.jit(jax.vmap(
    lambda k, d: jax.random.split(jax.random.fold_in(k, d), 3),
    in_axes=(0, None)))
_bernoulli = jax.jit(jax.vmap(jax.random.bernoulli))
_leaf = jax.jit(jax.vmap(
    lambda k, i: jax.random.uniform(jax.random.fold_in(k, i), ()),
    in_axes=(0, None)))


class JaxDraws:
    """tabcorr_tpu's random numbers through the port's draws interface.

    ``chain_keys`` yields one (n_chains,) key array per sampler step, in
    the order tabcorr_tpu consumes them; each chain key splits into the
    momentum key and the accept key (HMC) or the tree key (NUTS)."""

    def __init__(self, chain_keys):
        self.chain_keys = iter(chain_keys)

    @staticmethod
    def _tensor(x, dtype=torch.float64):
        return torch.tensor(np.asarray(x), dtype=dtype)

    def momentum(self, n_chains, n_dim, dtype, device):
        keys = _split2(next(self.chain_keys))
        assert keys.shape[0] == n_chains
        self.second = keys[:, 1]
        return self._tensor(_normal(keys[:, 0], n_dim), dtype)

    def accept_uniform(self, n_chains, dtype, device):
        return self._tensor(_uniform(self.second), dtype)

    def _sub(self, doubling):
        return _doubling_keys(self.second, doubling)

    def forward(self, doubling, n_chains, device):
        return self._tensor(_bernoulli(self._sub(doubling)[:, 0]),
                            torch.bool)

    def leaf_uniform(self, doubling, leaf, n_chains, dtype, device):
        return self._tensor(_leaf(self._sub(doubling)[:, 1], leaf), dtype)

    def pick_uniform(self, doubling, n_chains, dtype, device):
        return self._tensor(_uniform(self._sub(doubling)[:, 2]), dtype)


def _run_keys(key, n_chains, counts):
    """Per step, the chain keys of a reference run whose phases draw
    ``split(phase_key, n)`` step keys, each split over the chains."""
    return [jax.random.split(k, n_chains)
            for phase_key, n in counts
            for k in jax.random.split(phase_key, n)]


# ---- targets, one function per package -----------------------------
def _gauss(xp):
    def log_prob(theta):
        mean = xp.asarray([1.0, -2.0], dtype=theta.dtype)
        sigma = xp.asarray([0.5, 2.0], dtype=theta.dtype)
        return -0.5 * xp.sum(((theta - mean) / sigma) ** 2)
    return log_prob


def _correlated(xp):
    prec = np.linalg.inv(np.array([[1.0, 0.9], [0.9, 1.0]]))

    def log_prob(theta):
        return -0.5 * theta @ xp.asarray(prec, dtype=theta.dtype) @ theta
    return log_prob


def _nan_beyond(xp):
    """The 2-D Gaussian, NaN (value and gradient) where theta[0] > 1.3:
    a leapfrog that lands there has a NaN Hamiltonian, which ends the
    trajectory as a divergence."""
    gauss = _gauss(xp)

    def log_prob(theta):
        return xp.where(theta[0] > 1.3, xp.nan * theta[0], gauss(theta))
    return log_prob


NAMES = ("logMmin", "logM1")
BOUNDS = {"logMmin": (10.5, 12.5), "logM1": (11.5, 13.5)}


@pytest.fixture(scope="module")
def hod_targets():
    """The zheng07 wp posterior: tabcorr_tpu's over its float64 XLA
    engine, the port's over its plain float64 engine."""
    path = DATA_DIR / "examples" / "bolplanck_wp.hdf5"
    jax_tab, tab = tt.TabCorr.read(path), ttt.TabCorr.read(path)
    z = float(tab.attrs["redshift"])
    jax_model = tt.Zheng07Model(threshold=-18, redshift=z)
    model = ttt.Zheng07Model(threshold=-18, redshift=z)
    data = tab.predict(model)[1].ravel() * 1.02
    inv_cov = np.diag(1.0 / (0.05 * np.abs(data)) ** 2)
    jax_one = jax_make_predictor(jax_tab, jax_model, dtype=jnp.float64,
                                 vectorized=False, jit=False, engine="xla")
    one = ttt.make_predictor(tab, model, dtype=torch.float64,
                             vectorized=False, device="cpu")
    kwargs = dict(bounds=BOUNDS, ngal_data=0.03, ngal_sigma=0.003)
    jax_lp = jax_mcmc.make_gaussian_logpost(
        jax_one, NAMES, {k: jnp.float64(v)
                         for k, v in jax_model.param_dict.items()},
        data, inv_cov, **kwargs)
    lp = mcmc.make_gaussian_logpost(one, NAMES, dict(model.param_dict),
                                    data, inv_cov, device="cpu", **kwargs)
    truth = np.array([model.param_dict[k] for k in NAMES])
    return jax_lp, lp, truth


def _target(name, hod_targets):
    """(tabcorr_tpu's per-chain log prob, the port's batched one, a start,
    step size)."""
    if name == "hod":
        jax_lp, lp, truth = hod_targets
        return jax_lp, torch.vmap(lp), truth, 0.004
    if name == "nan":
        return (_nan_beyond(jnp), torch.vmap(_nan_beyond(torch)),
                np.array([1.0, -2.0]), 0.4)
    xp_fns = {"gauss": _gauss, "correlated": _correlated}[name]
    return (xp_fns(jnp), torch.vmap(xp_fns(torch)), np.array([0.3, -0.4]),
            0.3)


def _starts(center, n_chains, seed, scale=0.05):
    return center + scale * np.random.default_rng(seed).normal(
        size=(n_chains, len(center)))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=RTOL * np.max(np.abs(want)),
                               err_msg=what)


# ---- the pieces -----------------------------------------------------
@pytest.mark.parametrize("inv_mass", [None, (0.7, 1.9)])
def test_leapfrog_and_uturn_match_jax(inv_mass):
    rng = np.random.default_rng(0)
    q, p = rng.normal(size=(2, 6, 2))
    m = 1.0 if inv_mass is None else np.array(inv_mass)
    jax_lp, lp = _correlated(jnp), _correlated(torch)
    grad = np.asarray(jax.vmap(jax.grad(jax_lp))(jnp.asarray(q)))
    want = jax.vmap(lambda a, b, g: jax_mcmc._leapfrog(
        a, b, g, 0.17, jax_lp, jnp.asarray(m)))(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(grad))
    m_t = m if inv_mass is None else torch.tensor(m)
    got = mcmc._leapfrog(torch.tensor(q), torch.tensor(p),
                         torch.tensor(grad), 0.17, torch.vmap(lp), m_t)
    for g, w, what in zip(got, want, ("q", "p", "logp", "grad")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-14, err_msg=what)
    states = rng.normal(size=(4, 64, 2))
    want = jax.vmap(lambda a, b, c, d: jax_mcmc._uturn(
        a, b, c, d, jnp.asarray(m)))(*(jnp.asarray(x) for x in states))
    got = mcmc._uturn(*(torch.tensor(x) for x in states), m_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tz_count_matches_jax():
    for x in range(1, 200):
        for bits in (1, 3, 6, 9):
            assert mcmc._tz_count(x, bits) == int(
                jax_mcmc._tz_count(jnp.int32(x), bits)), (x, bits)


# ---- one step -------------------------------------------------------
@pytest.mark.parametrize("target", ["gauss", "correlated", "hod", "nan"])
def test_hmc_step_matches_jax(target, hod_targets):
    jax_lp, lp, center, eps = _target(target, hod_targets)
    q0 = _starts(center, 6, 1)
    keys = jax.random.split(jax.random.key(3), 6)
    want = jax.vmap(lambda k, x: jax_mcmc.hmc_step(k, x, jax_lp, eps, 5))(
        keys, jnp.asarray(q0))
    got = mcmc.hmc_step(JaxDraws([keys]), torch.tensor(q0), lp, eps, 5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[0], want[0], "positions")
    _close(got[1], want[1], "log prob")
    if target == "nan":
        assert int(got[2].sum()) < 6           # NaN end states rejected
        assert not torch.isnan(got[0]).any()


@pytest.mark.parametrize("inv_mass", [None, (0.5, 2.0)])
@pytest.mark.parametrize("target", ["gauss", "correlated", "hod", "nan"])
def test_nuts_step_matches_jax(target, inv_mass, hod_targets):
    jax_lp, lp, center, eps = _target(target, hod_targets)
    if inv_mass is not None and target == "hod":
        inv_mass = (0.002, 0.004)
    q0 = _starts(center, 6, 2)
    keys = jax.random.split(jax.random.key(4), 6)
    m = None if inv_mass is None else np.array(inv_mass)
    want = jax.vmap(lambda k, x: jax_mcmc.nuts_step(
        k, x, jax_lp, eps, max_depth=5,
        inv_mass=None if m is None else jnp.asarray(m)))(
        keys, jnp.asarray(q0))
    got = mcmc.nuts_step(JaxDraws([keys]), torch.tensor(q0), lp, eps,
                         max_depth=5,
                         inv_mass=None if m is None else torch.tensor(m))
    _close(got[0], want[0], "positions")
    _close(got[1], want[1], "log prob")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[3], want[3], "accept stat")
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert not torch.isnan(got[0]).any()
    if target == "nan":
        # Divergent chains stop below 2^max_depth - 1 leapfrogs.
        assert int(got[4].min()) < 31
    else:
        assert int(got[2].max()) >= 2


# ---- whole runs: dual averaging and the mass matrix -----------------
def test_run_hmc_and_adaptive_match_jax():
    jax_lp, lp = _gauss(jnp), torch.vmap(_gauss(torch))
    q0 = _starts(np.array([0.5, -1.0]), 4, 3, scale=1.0)
    key = jax.random.key(7)
    want = jax_mcmc.run_hmc(key, jax_lp, jnp.asarray(q0), n_steps=6,
                            step_size=0.3, n_leapfrog=4)
    got = mcmc.run_hmc(JaxDraws(_run_keys(key, 4, [(key, 6)])), lp,
                       torch.tensor(q0), n_steps=6, step_size=0.3,
                       n_leapfrog=4)
    for g, w, what in zip(got, want, ("chain", "log prob", "accept")):
        _close(g, w, what)

    want = jax_mcmc.run_hmc_adaptive(key, jax_lp, jnp.asarray(q0),
                                     n_warmup=12, n_steps=5, n_leapfrog=4,
                                     initial_step_size=1.5)
    warm, sample = jax.random.split(key)
    got = mcmc.run_hmc_adaptive(
        JaxDraws(_run_keys(key, 4, [(warm, 12), (sample, 5)])), lp,
        torch.tensor(q0), n_warmup=12, n_steps=5, n_leapfrog=4,
        initial_step_size=1.5)
    # tabcorr_tpu's accepted fraction is jnp.mean of a bool array, float32
    # even under x64, and its scan then carries h_bar in float32; the
    # port's dual averaging runs in float64 (held at 1e-12 by
    # test_run_nuts_matches_jax, whose accept statistic is float64).
    np.testing.assert_allclose(got[3], float(want[3]), rtol=1e-6)
    # The sampling steps after the first, from its positions, at
    # tabcorr_tpu's step size.
    got = mcmc.run_hmc(JaxDraws(_run_keys(key, 4, [(sample, 5)])[1:]), lp,
                       torch.tensor(np.asarray(want[0][0])), n_steps=4,
                       step_size=float(want[3]), n_leapfrog=4)
    for g, w, what in zip(got, (want[0][1:], want[1][1:]),
                          ("chain", "log prob")):
        _close(g, w, what)


@pytest.mark.parametrize("adapt", [False, True])
def test_run_nuts_matches_jax(adapt):
    scales = np.array([1.0, 6.0])

    def jax_lp(x):
        return -0.5 * jnp.sum((x / scales) ** 2)

    def lp(x):
        return -0.5 * torch.sum((x / torch.tensor(scales)) ** 2, dim=-1)

    q0 = _starts(np.zeros(2), 4, 5, scale=1.0)
    key = jax.random.key(9)
    n_warmup, n_steps = 14, 4
    want = jax_mcmc.run_nuts(key, jax_lp, jnp.asarray(q0), n_warmup,
                             n_steps, max_depth=5, initial_step_size=0.5,
                             adapt_mass_matrix=adapt)
    k1, k2, k3, ks = jax.random.split(key, 4)
    phases = ([(k1, 2), (k2, 10), (k3, 2)] if adapt else [(k1, n_warmup)])
    got = mcmc.run_nuts(
        JaxDraws(_run_keys(key, 4, phases + [(ks, n_steps)])), lp,
        torch.tensor(q0), n_warmup, n_steps, max_depth=5,
        initial_step_size=0.5, adapt_mass_matrix=adapt)
    np.testing.assert_allclose(got[3], float(want[3]), rtol=1e-12)
    _close(got[0], want[0], "chain")
    _close(got[1], want[1], "log prob")
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-6)
