"""Stretch-move ensemble sampling over HOD parameters.

* :func:`run_ensemble` / :func:`ensemble_step` -- the affine-invariant
  stretch move (Goodman & Weare 2010, the emcee algorithm) with the
  two-half update, on (n_walkers, n_dim) tensors.  Randomness comes from
  an explicit ``torch.Generator`` on the walkers' device.
* :func:`make_gaussian_logpost_batched` -- a Gaussian log posterior over
  several statistics at once, around a batched multi-statistic predictor
  such as ``predictor.make_multi_predictor``.

The chi^2 contraction of ``make_gaussian_logpost_batched`` runs in
float64 and rounds to float32 once: a float32 product may run in TF32,
whose ~10-bit mantissa would round the residuals far above the
predictions' 1e-6 accuracy, and a float64 one never does, so the
process-wide ``torch.backends.cuda.matmul.allow_tf32`` is neither read
nor set.
"""

from __future__ import annotations

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


def make_gaussian_logpost_batched(predict_all, param_names, base_params,
                                  data_list, inv_cov_list, bounds=None,
                                  ngal_data=None, ngal_sigma=None, *,
                                  device="cuda"):
    """Batched Gaussian log posterior over several statistics at once.

    ``predict_all`` maps a dict of (B,) tensors to a list of (ngal (B,),
    xi (B, ...)); ``data_list``/``inv_cov_list`` give one data vector and
    inverse covariance per statistic, moved to ``device`` in float32.
    ``param_names`` are the sampled dimensions; the others stay at
    ``base_params``.  ``bounds`` maps names to flat (lo, hi) priors; the
    number-density term uses the first statistic's ngal.  Returns
    ``theta (B, n_dim) -> (B,)`` for :func:`run_ensemble` with
    ``vectorized=True``.
    """
    device = resolve_device(device)
    data_list = [torch.as_tensor(d, dtype=torch.float32,
                                 device=device).reshape(-1)
                 for d in data_list]
    inv_cov_list = [torch.as_tensor(c, dtype=torch.float32,
                                    device=device).double()
                    for c in inv_cov_list]
    if len(data_list) != len(inv_cov_list):
        raise ValueError("data_list and inv_cov_list lengths differ.")
    names = tuple(param_names)

    def log_prob(theta):
        batch = theta.shape[0]
        params = {k: torch.as_tensor(v, dtype=theta.dtype,
                                     device=theta.device).expand(batch)
                  for k, v in base_params.items()}
        for i, name in enumerate(names):
            params[name] = theta[:, i]
        results = predict_all(params)
        if len(results) != len(data_list):
            raise ValueError(
                f"predict_all returned {len(results)} statistics but "
                f"{len(data_list)} data vectors were given.")
        logp = torch.zeros(batch, dtype=theta.dtype, device=theta.device)
        for (_, xi), data, inv_cov in zip(results, data_list, inv_cov_list):
            resid = (xi.reshape(batch, -1) - data).double()
            # In float64 (see the module docstring).
            chi2 = torch.sum((resid @ inv_cov) * resid, dim=-1)
            logp = logp - 0.5 * chi2.to(logp.dtype)
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
