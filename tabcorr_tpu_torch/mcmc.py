"""MCMC over HOD parameters: the stretch-move ensemble, HMC and NUTS.

* :func:`run_ensemble` / :func:`ensemble_step` -- the affine-invariant
  stretch move (Goodman & Weare 2010, the emcee algorithm) with the
  two-half update, on (n_walkers, n_dim) tensors.
* :func:`run_hmc` / :func:`hmc_step`, :func:`run_hmc_adaptive` --
  Hamiltonian Monte Carlo with leapfrog integration, the step size tuned
  by dual averaging (Hoffman & Gelman 2014) in the adaptive form.
* :func:`run_nuts` / :func:`nuts_step` -- the No-U-Turn sampler with
  multinomial proposals, an iterative subtree with early exit and an
  optional diagonal metric adapted in Stan's three-phase warmup.
* :func:`make_gaussian_logpost` / :func:`make_gaussian_logpost_batched` --
  Gaussian log posteriors around an unvectorized predictor
  (``make_predictor(vectorized=False)``) or a batched multi-statistic
  one (``make_multi_predictor``).
* :func:`integrated_autocorr_time`, :func:`effective_sample_size`,
  :func:`gelman_rubin` -- chain diagnostics in float64 numpy.

The gradient samplers take a batched log probability, (n_chains, n_dim)
-> (n_chains,); a per-chain one, such as :func:`make_gaussian_logpost`'s,
goes in as ``torch.vmap(log_prob)``.  They advance every chain of the
batch together: one leapfrog is one batched gradient, ``torch.autograd.grad``
of the summed log probabilities (the chains are independent, so each row
is that chain's gradient), and no graph is kept from one leapfrog to the
next.  NUTS runs each chain's doubling and leaf loops as tabcorr_tpu's
``vmap`` of ``while_loop`` does: all chains step in one batched loop,
finished chains are frozen (state and ``n_grad`` unchanged), and the loop
ends when no chain is left, which the host reads once per leapfrog.  The
log probability must be differentiable: the kernel-backed predictors
refuse (``ops.fused.NO_GRADIENT``), the plain float64 engine is the one
to sample with.

Randomness comes from an explicit ``torch.Generator`` on the chains'
device.  The gradient samplers draw only through the methods of
:class:`GeneratorDraws` (momenta, direction, per-leaf and pick uniforms,
accept uniforms); any object with those methods may stand in for the
generator, so tabcorr_tpu's exact draws can be replayed.

The chi^2 contraction of the log posteriors runs in float64 (a float32
product may run in TF32, whose ~10-bit mantissa would round the residuals
far above the predictions' 1e-6 accuracy, and a float64 one never does,
so the process-wide ``torch.backends.cuda.matmul.allow_tf32`` is neither
read nor set).  For float32 ``theta`` the residual is taken against the
data rounded to float32, for float64 ``theta`` against the caller's
float64 data; both forms are made once, when the posterior is built.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .utils.device import resolve_device


def _stretch_draws(generator, n_active, n_passive, dtype, device):
    """Random numbers of one half-step: stretch uniforms, partner picks,
    accept uniforms (the order tabcorr_tpu draws them in)."""
    u = torch.rand(n_active, generator=generator, dtype=dtype, device=device)
    picks = torch.randint(0, n_passive, (n_active,), generator=generator,
                          device=device)
    u_accept = torch.rand(n_active, generator=generator, dtype=dtype,
                          device=device)
    return u, picks, u_accept


def _stretch_half(draws, active, passive, log_prob_active, log_prob_fn, a,
                  vectorized=False):
    """Goodman & Weare stretch move of ``active`` against ``passive``,
    driven by the given ``draws = (u, picks, u_accept)``."""
    u, picks, u_accept = draws
    # z ~ g(z) proportional to 1/sqrt(z) on [1/a, a].
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partner = passive[picks]
    proposal = partner + z[:, None] * (active - partner)
    log_prob_prop = (log_prob_fn(proposal) if vectorized
                     else torch.vmap(log_prob_fn)(proposal))
    n_dim = active.shape[1]
    log_accept = ((n_dim - 1.0) * torch.log(z) +
                  log_prob_prop - log_prob_active)
    accept = torch.log(u_accept) < log_accept
    new = torch.where(accept[:, None], proposal, active)
    new_log_prob = torch.where(accept, log_prob_prop, log_prob_active)
    return new, new_log_prob, accept


def ensemble_step(generator, walkers, log_prob, log_prob_fn, a=2.0,
                  vectorized=False):
    """One stretch-move step over all walkers (two-half scheme).

    Parameters
    ----------
    generator : torch.Generator on the walkers' device
    walkers : (n_walkers, n_dim) tensor
    log_prob : (n_walkers,) current log probabilities
    log_prob_fn : callable (n_dim,) -> scalar; with ``vectorized=True``,
        (B, n_dim) -> (B,) evaluated on each half-ensemble at once
    a : float, stretch scale parameter

    Returns
    -------
    (walkers, log_prob, accept_fraction)
    """
    n = walkers.shape[0] // 2
    first, second = walkers[:n], walkers[n:]
    lp_first, lp_second = log_prob[:n], log_prob[n:]

    def draws(n_active, n_passive):
        return _stretch_draws(generator, n_active, n_passive, walkers.dtype,
                              walkers.device)

    first, lp_first, acc_1 = _stretch_half(
        draws(first.shape[0], second.shape[0]), first, second, lp_first,
        log_prob_fn, a, vectorized)
    second, lp_second, acc_2 = _stretch_half(
        draws(second.shape[0], first.shape[0]), second, first, lp_second,
        log_prob_fn, a, vectorized)
    accept = torch.cat([acc_1, acc_2]).to(walkers.dtype).mean()
    return (torch.cat([first, second]), torch.cat([lp_first, lp_second]),
            accept)


def run_ensemble(generator, log_prob_fn, walkers0, n_steps, a=2.0, thin=1,
                 vectorized=False):
    """Run the stretch-move ensemble sampler for ``n_steps`` steps.

    Returns
    -------
    chain : (n_steps // thin, n_walkers, n_dim)
    log_prob : (n_steps // thin, n_walkers)
    accept_fraction : scalar tensor, mean over all steps
    """
    walkers = walkers0
    log_prob = (log_prob_fn(walkers) if vectorized
                else torch.vmap(log_prob_fn)(walkers))
    chain, chain_lp, accepts = [], [], []
    for _ in range(n_steps // thin):
        for _ in range(thin):
            walkers, log_prob, acc = ensemble_step(
                generator, walkers, log_prob, log_prob_fn, a, vectorized)
            accepts.append(acc)
        chain.append(walkers)
        chain_lp.append(log_prob)
    return torch.stack(chain), torch.stack(chain_lp), torch.stack(
        accepts).mean()


def _data_pair(data, inv_cov, device):
    """A data vector and inverse covariance on ``device`` in the two forms
    :func:`_chi2` selects from: the caller's float64, and rounded to
    float32 (the inverse covariance then held in float64)."""
    data = torch.as_tensor(data, dtype=torch.float64,
                           device=device).reshape(-1)
    inv_cov = torch.as_tensor(inv_cov, dtype=torch.float64, device=device)
    return {torch.float64: (data, inv_cov),
            torch.float32: (data.float(), inv_cov.float().double())}


def _chi2(xi, pair, dtype):
    """chi^2 of the rows of ``xi`` (..., n) in float64, as ``dtype``: for
    float64 the caller's data, else the data and inverse covariance
    rounded to float32 (see the module docstring)."""
    data, inv_cov = pair[torch.float64 if dtype == torch.float64
                         else torch.float32]
    resid = (xi.to(data.dtype) - data).double()
    return torch.sum((resid @ inv_cov) * resid, dim=-1).to(dtype)


def make_gaussian_logpost_batched(predict_all, param_names, base_params,
                                  data_list, inv_cov_list, bounds=None,
                                  ngal_data=None, ngal_sigma=None, *,
                                  device="cuda"):
    """Batched Gaussian log posterior over several statistics at once.

    ``predict_all`` maps a dict of (B,) tensors to a list of (ngal (B,),
    xi (B, ...)); ``data_list``/``inv_cov_list`` give one data vector and
    inverse covariance per statistic, moved to ``device``.
    ``param_names`` are the sampled dimensions; the others stay at
    ``base_params``.  ``bounds`` maps names to flat (lo, hi) priors; the
    number-density term uses the first statistic's ngal.  Returns
    ``theta (B, n_dim) -> (B,)`` in ``theta``'s dtype.
    """
    device = resolve_device(device)
    if len(data_list) != len(inv_cov_list):
        raise ValueError("data_list and inv_cov_list lengths differ.")
    pairs = [_data_pair(d, c, device)
             for d, c in zip(data_list, inv_cov_list)]
    names = tuple(param_names)

    def log_prob(theta):
        batch = theta.shape[0]
        params = {k: torch.as_tensor(v, dtype=theta.dtype,
                                     device=theta.device).expand(batch)
                  for k, v in base_params.items()}
        for i, name in enumerate(names):
            params[name] = theta[:, i]
        results = predict_all(params)
        if len(results) != len(pairs):
            raise ValueError(
                f"predict_all returned {len(results)} statistics but "
                f"{len(pairs)} data vectors were given.")
        logp = torch.zeros(batch, dtype=theta.dtype, device=theta.device)
        for (_, xi), pair in zip(results, pairs):
            logp = logp - 0.5 * _chi2(xi.reshape(batch, -1), pair,
                                      theta.dtype)
        if ngal_data is not None:
            ngal0 = results[0][0]
            logp = logp - 0.5 * ((ngal0 - ngal_data) / ngal_sigma) ** 2
        logp = torch.where(torch.isfinite(logp), logp, -torch.inf)
        if bounds is not None:
            inside = torch.ones(batch, dtype=torch.bool, device=theta.device)
            for i, name in enumerate(names):
                if name in bounds:
                    lo, hi = bounds[name]
                    inside = inside & (theta[:, i] > lo) & (theta[:, i] < hi)
            logp = torch.where(inside, logp, -torch.inf)
        return logp

    return log_prob


def make_gaussian_logpost(predict_fn, param_names, base_params, data,
                          inv_cov, bounds=None, ngal_data=None,
                          ngal_sigma=None, *, device="cuda"):
    """Gaussian log posterior over a subset of HOD parameters.

    ``predict_fn`` is an unvectorized predictor (dict of 0-d tensors ->
    (ngal, xi), ``make_predictor(..., vectorized=False)``);
    ``param_names`` are the sampled dimensions, the others fixed at
    ``base_params``; ``bounds`` maps names to (lo, hi) flat priors.
    Returns ``theta (n_dim,) -> 0-d`` in ``theta``'s dtype: -inf where
    the prediction is not finite (an Interpolator outside its grid) or
    ``theta`` is out of bounds.  ``torch.vmap`` maps it over chains or
    walkers (``run_ensemble`` does so itself).
    """
    device = resolve_device(device)
    pair = _data_pair(data, inv_cov, device)
    names = tuple(param_names)

    def log_prob(theta):
        params = {k: v if torch.is_tensor(v) else
                  torch.tensor(v, dtype=theta.dtype, device=theta.device)
                  for k, v in base_params.items()}
        for i, name in enumerate(names):
            params[name] = theta[i]
        ngal, xi = predict_fn(params)
        logp = -0.5 * _chi2(xi.reshape(-1), pair, theta.dtype)
        if ngal_data is not None:
            logp = logp - 0.5 * ((ngal - ngal_data) / ngal_sigma) ** 2
        logp = torch.where(torch.isfinite(logp), logp, -torch.inf)
        if bounds is not None:
            inside = torch.ones((), dtype=torch.bool, device=theta.device)
            for i, name in enumerate(names):
                if name in bounds:
                    lo, hi = bounds[name]
                    inside = inside & (theta[i] > lo) & (theta[i] < hi)
            logp = torch.where(inside, logp, -torch.inf)
        return logp

    return log_prob


# ----------------------------------------------------------------------
# Gradient samplers: randomness, gradients, dual averaging
# ----------------------------------------------------------------------
class GeneratorDraws:
    """The random numbers of :func:`hmc_step` and :func:`nuts_step`, one
    per chain, from ``generator`` on the chains' device.

    ``doubling`` and ``leaf`` say which draw of tabcorr_tpu's key tree a
    number stands for (``fold_in(key_tree, depth)``, ``fold_in(key_sub,
    leaf)``); a generator needs no index, a replay of those keys does.
    """

    def __init__(self, generator):
        self.generator = generator

    def _uniform(self, n_chains, dtype, device):
        return torch.rand(n_chains, generator=self.generator, dtype=dtype,
                          device=device)

    def momentum(self, n_chains, n_dim, dtype, device):
        """Standard normal (n_chains, n_dim)."""
        return torch.randn((n_chains, n_dim), generator=self.generator,
                           dtype=dtype, device=device)

    def accept_uniform(self, n_chains, dtype, device):
        """HMC's Metropolis uniform."""
        return self._uniform(n_chains, dtype, device)

    def forward(self, doubling, n_chains, device):
        """Whether the doubling extends the trajectory forward (bool)."""
        return self._uniform(n_chains, torch.float32, device) < 0.5

    def leaf_uniform(self, doubling, leaf, n_chains, dtype, device):
        """The multinomial uniform of a leaf within the subtree."""
        return self._uniform(n_chains, dtype, device)

    def pick_uniform(self, doubling, n_chains, dtype, device):
        """The uniform that swaps the proposal across the doubling."""
        return self._uniform(n_chains, dtype, device)


def _draws(generator):
    """A :class:`GeneratorDraws` of a generator; any other object is taken
    to have its methods."""
    if isinstance(generator, torch.Generator):
        return GeneratorDraws(generator)
    return generator


def _value_and_grad(log_prob, q):
    """(log_prob(q) (C,), its gradient (C, D)); no graph is kept."""
    with torch.enable_grad():
        x = q.detach().requires_grad_()
        lp = log_prob(x)
        (grad,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), grad


# Dual averaging (Hoffman & Gelman 2014, algorithm 5), tabcorr_tpu's
# constants.
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75


def _dual_averaging(da, accept, mu, target_accept):
    """One update of ``da = (log_eps, log_eps_bar, h_bar, t)`` (floats)
    on the mean accept statistic ``accept``."""
    log_eps, log_eps_bar, h_bar, t = da
    t = t + 1.0
    h_bar = ((1.0 - 1.0 / (t + _T0)) * h_bar +
             (target_accept - accept) / (t + _T0))
    log_eps = mu - math.sqrt(t) / _GAMMA * h_bar
    eta = t ** -_KAPPA
    log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
    return log_eps, log_eps_bar, h_bar, t


def _mean(x):
    """The mean of a (C,) tensor as a float (one host read)."""
    return float(x.double().mean())


# ----------------------------------------------------------------------
# HMC
# ----------------------------------------------------------------------
def hmc_step(generator, positions, log_prob, step_size, n_leapfrog):
    """One HMC step of every chain: leapfrog, then Metropolis accept.

    Parameters
    ----------
    generator : torch.Generator on the chains' device (or draws, see
        :class:`GeneratorDraws`)
    positions : (n_chains, n_dim) tensor
    log_prob : callable (C, n_dim) -> (C,), differentiable
    step_size : float
    n_leapfrog : int

    Returns
    -------
    (positions, log_prob (C,), accept (C,) bool)
    """
    draws = _draws(generator)
    n_chains, n_dim = positions.shape
    dtype, device = positions.dtype, positions.device
    momentum = draws.momentum(n_chains, n_dim, dtype, device)
    lp0, grad = _value_and_grad(log_prob, positions)
    h0 = lp0 - 0.5 * torch.sum(momentum ** 2, dim=-1)
    q, p, lp = positions, momentum, lp0
    for _ in range(n_leapfrog):
        p = p + 0.5 * step_size * grad
        q = q + step_size * p
        lp, grad = _value_and_grad(log_prob, q)
        p = p + 0.5 * step_size * grad
    h_new = lp - 0.5 * torch.sum(p ** 2, dim=-1)
    accept = (torch.log(draws.accept_uniform(n_chains, dtype, device)) <
              h_new - h0)
    return (torch.where(accept[:, None], q, positions),
            torch.where(accept, lp, lp0), accept)


def run_hmc(generator, log_prob, positions0, n_steps, step_size=0.01,
            n_leapfrog=10):
    """Multi-chain HMC from ``positions0`` (n_chains, n_dim).

    Returns (chain (n_steps, n_chains, n_dim), log_prob (n_steps,
    n_chains), accept_fraction).
    """
    draws = _draws(generator)
    positions = positions0
    chain, chain_lp, accepts = [], [], []
    for _ in range(n_steps):
        positions, lp, accept = hmc_step(draws, positions, log_prob,
                                         step_size, n_leapfrog)
        chain.append(positions)
        chain_lp.append(lp)
        accepts.append(accept.to(positions.dtype).mean())
    return torch.stack(chain), torch.stack(chain_lp), torch.stack(
        accepts).mean()


def run_hmc_adaptive(generator, log_prob, positions0, n_warmup, n_steps,
                     n_leapfrog=10, initial_step_size=0.1,
                     target_accept=0.8):
    """HMC whose step size dual averaging tunes to ``target_accept`` over
    ``n_warmup`` multi-chain steps (on the accepted fraction of the
    chains), then ``n_steps`` at the adapted step size.

    Returns (chain (n_steps, n_chains, n_dim), log_prob, accept_fraction,
    step_size).
    """
    draws = _draws(generator)
    mu = math.log(10.0 * initial_step_size)
    da = (math.log(initial_step_size), math.log(initial_step_size), 0.0,
          0.0)
    positions = positions0
    for _ in range(n_warmup):
        positions, _, accept = hmc_step(draws, positions, log_prob,
                                        math.exp(da[0]), n_leapfrog)
        da = _dual_averaging(da, _mean(accept), mu, target_accept)
    step_size = math.exp(da[1])
    chain, chain_lp, accept = run_hmc(draws, log_prob, positions,
                                      n_steps, step_size, n_leapfrog)
    return chain, chain_lp, accept, step_size


# ----------------------------------------------------------------------
# NUTS (No-U-Turn Sampler)
# ----------------------------------------------------------------------
def _leapfrog(q, p, grad, step_size, log_prob, inv_mass=1.0):
    p_half = p + 0.5 * step_size * grad
    q_new = q + step_size * (inv_mass * p_half)
    logp_new, grad_new = _value_and_grad(log_prob, q_new)
    p_new = p_half + 0.5 * step_size * grad_new
    return q_new, p_new, logp_new, grad_new


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _uturn(q_left, p_left, q_right, p_right, inv_mass=1.0):
    """Generalized criterion: angles against velocities M^-1 p."""
    dq = q_right - q_left
    return (_dot(dq, inv_mass * p_left) < 0) | (_dot(dq, inv_mass * p_right)
                                                < 0)


def _tz_count(x, max_bits):
    """Trailing-zero count of the positive int ``x``, capped at
    ``max_bits``."""
    return sum(1 for b in range(1, max_bits + 1) if x & ((1 << b) - 1) == 0)


def _slot(i, max_depth):
    """The checkpoint slot of leaf ``i``: ``max_depth`` for leaf 0."""
    return max_depth if i == 0 else _tz_count(i, max_depth)


def _where(mask, new, old):
    """``new`` on the chains of ``mask`` (C,), ``old`` elsewhere."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _build_subtree_iter(draws, doubling, q0, p0, lp0, g0, depth, active,
                        step_size, log_prob, h0, inv_mass, max_depth):
    """One NUTS subtree of ``2^depth`` leaves per chain, built leaf by leaf.

    tabcorr_tpu's ``_build_subtree_iter`` for a batch of chains: the
    Hoffman & Gelman (2014) doubling subtree with multinomial sampling
    (Betancourt 2017), exiting on the first internal U-turn or divergence;
    the dyadic U-turn checks read an O(max_depth) checkpoint stack (Phan
    et al. 2019, numpyro's iterative NUTS).  A chain runs while it is
    ``active``, not bad and below its ``2^depth`` leaves; the others keep
    their state.  The leaf index ``i`` is shared, so its checkpoint slots
    are Python integers.  Integration is in the direction-flipped frame
    (``p0`` carries the direction's sign).  Returns the outward end
    state, the subtree's proposal, its log weight, the bad flag, the
    summed accept statistic and the leapfrogs run (the statistic's
    count), per chain.
    """
    n_chains = q0.shape[0]
    dtype, device = q0.dtype, q0.device
    n_leaf = torch.ones_like(depth) << depth
    q, p, lp, g = q0, p0, lp0, g0
    q_prop, lp_prop = q0, lp0
    log_sum_w = torch.full((n_chains,), -torch.inf, dtype=dtype,
                           device=device)
    bad = torch.zeros(n_chains, dtype=torch.bool, device=device)
    alpha_sum = torch.zeros(n_chains, dtype=dtype, device=device)
    steps = torch.zeros(n_chains, dtype=torch.int64, device=device)
    stack_q = [None] * (max_depth + 1)
    stack_v = [None] * (max_depth + 1)
    i = 0
    while True:
        running = active & ~bad & (i < n_leaf)
        if not bool(running.any()):      # the host reads once a leapfrog
            break
        q_n, p_n, lp_n, g_n = _leapfrog(q, p, g, step_size, log_prob,
                                        inv_mass)
        v = inv_mass * p_n
        h = -lp_n + 0.5 * _dot(p_n, v)
        # NaN-safe: a NaN Hamiltonian counts as divergent.
        divergent = ~((h - h0) <= 1000.0)
        log_w = torch.where(divergent, -torch.inf, h0 - h)
        alpha = torch.clamp(torch.exp(h0 - h), max=1.0)
        alpha = torch.where(torch.isnan(alpha), 0.0, alpha)

        # Multinomial proposal within the subtree.
        log_sum = torch.logaddexp(log_sum_w, log_w)
        u = draws.leaf_uniform(doubling, i, n_chains, dtype, device)
        take = running & (torch.log(u) < log_w - log_sum)
        q_prop = _where(take, q_n, q_prop)
        lp_prop = _where(take, lp_n, lp_prop)

        # Checkpoint this leaf if it starts a dyadic interval (a chain
        # that stops reads its stack no more).
        slot = _slot(i, max_depth)
        stack_q[slot], stack_v[slot] = q_n, v

        # U-turn checks of every dyadic interval ending at this leaf: of
        # length 2^level for level <= min(trailing ones of i + 1, depth),
        # starting at leaf i + 1 - 2^level.
        turning = torch.zeros_like(bad)
        for level in range(1, _tz_count(i + 1, max_depth) + 1):
            s_slot = _slot(i + 1 - (1 << level), max_depth)
            dq = q_n - stack_q[s_slot]
            turning = turning | ((level <= depth) & (
                (_dot(dq, stack_v[s_slot]) < 0) | (_dot(dq, v) < 0)))

        q, p = _where(running, q_n, q), _where(running, p_n, p)
        lp, g = _where(running, lp_n, lp), _where(running, g_n, g)
        log_sum_w = _where(running, log_sum, log_sum_w)
        bad = bad | (running & (divergent | turning))
        alpha_sum = alpha_sum + torch.where(running, alpha, 0.0)
        steps = steps + running
        i += 1
    return q, p, lp, g, q_prop, lp_prop, log_sum_w, bad, alpha_sum, steps


def nuts_step(generator, q, log_prob, step_size, max_depth=6,
              inv_mass=None):
    """One No-U-Turn step of every chain (dynamic doubling).

    ``q`` is (n_chains, n_dim); ``log_prob`` as in :func:`hmc_step`.
    Each chain's trajectory stops at its own U-turn or divergence; a
    batched leapfrog serves every chain still running, so a step costs
    the deepest chain's tree.  ``inv_mass`` is an optional diagonal
    inverse metric (momenta ~ N(0, M), kinetic energy p^T M^-1 p / 2,
    U-turns against velocities M^-1 p).

    Returns (q_new, logp_new, depth_reached, accept_stat, n_grad), each
    per chain: accept_stat is the mean Metropolis statistic over the
    trajectory's leapfrog states (Hoffman & Gelman 2014, algorithm 6),
    n_grad the leapfrog gradient evaluations the chain spent.
    """
    draws = _draws(generator)
    n_chains, n_dim = q.shape
    dtype, device = q.dtype, q.device
    if inv_mass is None:
        inv_mass = torch.ones((), dtype=dtype, device=device)
    p = draws.momentum(n_chains, n_dim, dtype, device) / torch.sqrt(inv_mass)
    logp, grad = _value_and_grad(log_prob, q)
    h0 = -logp + 0.5 * _dot(p, inv_mass * p)

    q_l = q_r = q_prop = q
    p_l = p_r = p
    lp_l = lp_r = lp_prop = logp
    g_l = g_r = grad
    log_sum_w = torch.zeros(n_chains, dtype=dtype, device=device)
    done = torch.zeros(n_chains, dtype=torch.bool, device=device)
    depth = torch.zeros(n_chains, dtype=torch.int64, device=device)
    alpha_sum = torch.zeros(n_chains, dtype=dtype, device=device)
    n_grad = torch.zeros(n_chains, dtype=torch.int64, device=device)
    for doubling in range(max_depth):
        active = ~done & (depth < max_depth)
        if not bool(active.any()):
            break
        forward = draws.forward(doubling, n_chains, device)
        sign = torch.where(forward, 1.0, -1.0).to(dtype)[:, None]
        q_0, p_0 = _where(forward, q_r, q_l), _where(forward, p_r, p_l)
        lp_0, g_0 = _where(forward, lp_r, lp_l), _where(forward, g_r, g_l)

        (t_q, t_p, t_lp, t_g, t_qp, t_lpp, t_lw, t_bad, t_alpha,
         t_steps) = _build_subtree_iter(
            draws, doubling, q_0, p_0 * sign, lp_0, g_0, depth, active,
            step_size, log_prob, h0, inv_mass, max_depth)
        t_p = t_p * sign                 # back to the physical frame

        # Multinomial proposal swap across the doubling.
        log_sum = torch.logaddexp(log_sum_w, t_lw)
        u = draws.pick_uniform(doubling, n_chains, dtype, device)
        take_new = active & (torch.log(u) < t_lw - log_sum) & ~t_bad
        grow = active & ~t_bad
        new_right, new_left = grow & forward, grow & ~forward
        q_l, p_l = _where(new_left, t_q, q_l), _where(new_left, t_p, p_l)
        lp_l, g_l = _where(new_left, t_lp, lp_l), _where(new_left, t_g, g_l)
        q_r, p_r = _where(new_right, t_q, q_r), _where(new_right, t_p, p_r)
        lp_r, g_r = (_where(new_right, t_lp, lp_r),
                     _where(new_right, t_g, g_r))
        q_prop = _where(take_new, t_qp, q_prop)
        lp_prop = _where(take_new, t_lpp, lp_prop)
        log_sum_w = _where(grow, log_sum, log_sum_w)
        done = done | (active & (t_bad | _uturn(q_l, p_l, q_r, p_r,
                                                inv_mass)))
        depth = depth + grow
        # The accept statistic counts every attempted doubling, the
        # terminating one included (Hoffman & Gelman's algorithm 6): its
        # count is the leapfrogs run.
        alpha_sum = alpha_sum + torch.where(active, t_alpha, 0.0)
        n_grad = n_grad + torch.where(active, t_steps, 0)
    accept_stat = alpha_sum / torch.clamp(n_grad, min=1)
    return q_prop, lp_prop, depth, accept_stat, n_grad


def run_nuts(generator, log_prob, positions0, n_warmup, n_steps,
             max_depth=6, initial_step_size=0.1, target_accept=0.8,
             adapt_mass_matrix=False):
    """Multi-chain NUTS with dual-averaging step-size warmup.

    With ``adapt_mass_matrix=True`` the warmup follows Stan's three-phase
    schedule: (I) ~15% step-size-only adaptation with the identity
    metric, (II) ~70% collecting a Welford estimate of the posterior
    variance across all chains (step size still adapting), after which
    the diagonal inverse metric is set to the regularized sample variance
    (``var * n/(n+5) + 1e-3 * 5/(n+5)``), and (III) ~15% re-running dual
    averaging from scratch under the new metric.

    Returns (chain (n_steps, n_chains, n_dim), log_prob (n_steps,
    n_chains), mean_depth, step_size).
    """
    draws = _draws(generator)
    dtype, device = positions0.dtype, positions0.device
    n_dim = positions0.shape[-1]

    def warmup(positions, da, inv_mass, n, mu, collect=False):
        mean = torch.zeros(n_dim, dtype=dtype, device=device)
        m2 = torch.zeros(n_dim, dtype=dtype, device=device)
        count = 0.0
        for _ in range(n):
            positions, _, _, accept, _ = nuts_step(
                draws, positions, log_prob, math.exp(da[0]), max_depth,
                inv_mass)
            da = _dual_averaging(da, _mean(accept), mu, target_accept)
            if collect:
                batch_mean = positions.mean(dim=0)
                count += 1.0
                delta = batch_mean - mean
                mean = mean + delta / count
                m2 = m2 + (positions.var(dim=0, correction=0) +
                           delta * (batch_mean - mean))
        return positions, da, (m2, count)

    log_eps0 = math.log(initial_step_size)
    da0 = (log_eps0, log_eps0, 0.0, 0.0)
    mu0 = math.log(10.0 * initial_step_size)
    inv_mass = torch.ones(n_dim, dtype=dtype, device=device)
    if adapt_mass_matrix:
        n_1 = max(int(0.15 * n_warmup), 1)
        n_3 = max(int(0.15 * n_warmup), 1)
        n_2 = max(n_warmup - n_1 - n_3, 1)
        positions, da, _ = warmup(positions0, da0, inv_mass, n_1, mu0)
        positions, da, (m2, count) = warmup(positions, da, inv_mass, n_2,
                                            mu0, collect=True)
        var = m2 / max(count, 1.0)
        inv_mass = var * count / (count + 5.0) + 1e-3 * 5.0 / (count + 5.0)
        # Phase III: fresh dual averaging around the last adapted step
        # size under the new metric.
        positions, da, _ = warmup(positions, (da[1], da[1], 0.0, 0.0),
                                  inv_mass, n_3, math.log(10.0) + da[1])
    else:
        positions, da, _ = warmup(positions0, da0, inv_mass, n_warmup, mu0)
    step_size = math.exp(da[1])

    chain, chain_lp, depths = [], [], []
    for _ in range(n_steps):
        positions, lp, depth, _, _ = nuts_step(
            draws, positions, log_prob, step_size, max_depth, inv_mass)
        chain.append(positions)
        chain_lp.append(lp)
        depths.append(depth)
    return (torch.stack(chain), torch.stack(chain_lp),
            torch.stack(depths).float().mean(), step_size)


# ---------------------------------------------------------------------------
# Chain diagnostics (host-side, float64 numpy), tabcorr_tpu's: emcee's
# ``get_autocorr_time`` (Goodman & Weare 2010 sec. 3; Sokal 1997
# windowing) and the split-Rhat of Gelman et al.
# ---------------------------------------------------------------------------
def _as_chain(chain):
    """A chain as a float64 (n_steps, n_walkers, n_dim) array."""
    if torch.is_tensor(chain):
        chain = chain.detach().cpu().numpy()
    x = np.asarray(chain, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, None, :]
    if x.ndim != 3:
        raise ValueError("chain must be (n_steps[, n_walkers], n_dim).")
    return x


def integrated_autocorr_time(chain, c=5.0):
    """Integrated autocorrelation time per parameter, emcee-style.

    Parameters
    ----------
    chain : (n_steps, n_walkers, n_dim) array or tensor
        A chain as the samplers return it (a 2-D (n_steps, n_dim) single
        chain is also accepted).
    c : float, optional
        Sokal window constant: the sum is truncated at the smallest lag
        M with M >= c * tau(M).  Default 5.0 (emcee's default).

    Returns
    -------
    tau : (n_dim,) float64
        Estimated integrated autocorrelation time of each parameter
        (in steps; 1 = independent samples).
    """
    x = _as_chain(chain)
    n, _, n_dim = x.shape
    # Per-walker autocovariance via FFT, averaged over walkers (emcee's
    # estimator).
    x = x - x.mean(axis=0, keepdims=True)
    n_fft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, n=n_fft, axis=0)
    acf = np.fft.irfft(f * np.conjugate(f), n=n_fft, axis=0)[:n]
    acf = acf.mean(axis=1)                     # (n, n_dim)
    with np.errstate(invalid="ignore", divide="ignore"):
        rho = acf / acf[0]
    taus = 2.0 * np.cumsum(rho, axis=0) - 1.0  # tau(M) per lag M
    out = np.empty(n_dim)
    for d in range(n_dim):
        m = np.arange(len(taus))
        window = np.argmax(m >= c * taus[:, d])
        if window == 0:                        # never crossed: use all lags
            window = len(taus) - 1
        out[d] = max(taus[window, d], 1.0)
    return out


def effective_sample_size(chain, c=5.0):
    """Effective number of independent samples per parameter:
    ``n_steps * n_walkers / tau`` with tau from
    :func:`integrated_autocorr_time`."""
    x = _as_chain(chain)
    return x.shape[0] * x.shape[1] / integrated_autocorr_time(x, c=c)


def gelman_rubin(chain):
    """Split-Rhat potential-scale-reduction per parameter.

    Each walker's chain is split in half (2 * n_walkers sub-chains of
    length n_steps // 2), then the classic Gelman-Rubin statistic
    compares between- and within-chain variances.  Values close to 1
    (conventionally < 1.01) indicate convergence.

    Returns
    -------
    rhat : (n_dim,) float64
    """
    x = _as_chain(chain)
    n = (x.shape[0] // 2) * 2
    half = n // 2
    if half < 2:
        raise ValueError("need at least 4 steps for split-Rhat.")
    # (half, 2 * n_walkers, n_dim) split sub-chains.
    x = np.concatenate([x[:half], x[half:n]], axis=1)
    mean_c = x.mean(axis=0)                    # (m, n_dim)
    var_c = x.var(axis=0, ddof=1)              # (m, n_dim)
    w = var_c.mean(axis=0)
    b = half * mean_c.var(axis=0, ddof=1)
    var_plus = (half - 1) / half * w + b / half
    with np.errstate(invalid="ignore", divide="ignore"):
        rhat = np.sqrt(var_plus / w)
    return rhat
