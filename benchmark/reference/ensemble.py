"""Plain reference of the sampler's arithmetic: the Gaussian log posterior
and the affine-invariant stretch move (Goodman & Weare 2010; the emcee
algorithm, two halves a step), in float64 plain PyTorch.

It draws its random numbers from a ``torch.Generator`` in the state the
run's generator had, in the documented order of one half-step: the
stretch uniforms, the partner picks, the accept uniforms, each at the
walkers' type.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch


def log_posterior(xis, data, inv_covs, theta, names, bounds):
    """-chi^2 / 2 summed over statistics; -inf where it is not finite or
    where ``theta`` (B, n_dim), whose columns are ``names``, is not
    strictly inside the flat priors ``bounds`` ({name: (lo, hi)}).
    ``xis`` are (B, n) predictions, ``data`` (n,) and ``inv_covs`` (n, n),
    all float64."""
    logp = None
    for xi, d, c in zip(xis, data, inv_covs):
        r = xi.double() - d
        term = -0.5 * torch.sum((r @ c) * r, dim=1)
        logp = term if logp is None else logp + term
    logp = torch.where(torch.isfinite(logp), logp, -math.inf)
    for i, name in enumerate(names):
        if name in bounds:
            lo, hi = bounds[name]
            inside = (theta[:, i] > lo) & (theta[:, i] < hi)
            logp = torch.where(inside, logp, -math.inf)
    return logp


def draws(generator, n_active, n_passive, dtype, device):
    u = torch.rand(n_active, generator=generator, dtype=dtype, device=device)
    picks = torch.randint(0, n_passive, (n_active,), generator=generator,
                          device=device)
    u_accept = torch.rand(n_active, generator=generator, dtype=dtype,
                          device=device)
    return u, picks, u_accept


def stretch_half(generator, active, passive, a, dtype):
    """The proposals of one half-step, in float64, and what decides them:
    ``(proposal, z, scale, log_u)``.  ``scale`` is the size of the
    operands of each proposal coordinate (|partner| + z |active -
    partner|), the unit of its rounding."""
    u, picks, u_accept = draws(generator, active.shape[0], passive.shape[0],
                               dtype, active.device)
    z = ((a - 1.0) * u.double() + 1.0) ** 2 / a
    partner = passive.double()[picks]
    step = z[:, None] * (active.double() - partner)
    return (partner + step, z, partner.abs() + step.abs(),
            torch.log(u_accept.double()))


def log_accept(z, n_dim, lp_proposal, lp_active):
    return (n_dim - 1.0) * torch.log(z) + lp_proposal - lp_active
