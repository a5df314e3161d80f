"""The comparison that decides ``correct``.

What the timed path produced in the window, judged against the plain
reference (``reference/<name>.py`` for the predictions,
``reference/ensemble.py`` for the log posterior and the stretch move):

* the window's first step, at the timed sizes: both half-batch predictor
  calls (ngal and every statistic, on every row), the log posterior of
  both, and the step's new walkers and log-probs, replayed from the state
  the window started from with the same draws (the reference draws them
  from a generator in the run generator's state);
* the log-probs the program carried into the window (its set-up's state)
  and out of it, against the reference's at the same walkers.

The replay follows the program's state where the step is sequential: the
second half's partners are the program's new first half, which the first
half's comparison has judged.  Each number is held to its limit in the
configuration file; counts have the limit 0.
"""

from __future__ import annotations

import math

import torch


class Capture:
    """Passes calls through to ``fn``; while armed, keeps the first ``n``
    calls' argument and result."""

    def __init__(self, fn, n):
        self.fn = fn
        self.n = n
        self.armed = False
        self.calls = []

    def __call__(self, arg):
        out = self.fn(arg)
        if self.armed and len(self.calls) < self.n:
            self.calls.append((arg, out))
        return out


def _max(x):
    """The largest element, a NaN counting as infinite; 0 if empty."""
    if not x.numel():
        return 0.0
    return float(torch.where(torch.isnan(x), math.inf, x).max())


def relative_err(got, want):
    """Max over elements of |got / want - 1|."""
    return _max((got.double() / want - 1.0).abs())


def scaled_err(got, want):
    """Max over rows of max |got - want| / max |want|."""
    diff = (got.double() - want).abs().amax(dim=1)
    return _max(diff / want.abs().amax(dim=1))


def logpost_err(got, want, sens):
    """Max of |got - want| / (1 + |want| + sens); 0 where both are -inf,
    inf where only one is.  ``sens`` is the first-order change of the log
    posterior that errors of one unit in the predictions' contract would
    make, so the number reads like the predictions' errors wherever the
    walker is."""
    got = got.double()
    both = torch.isinf(got) & torch.isinf(want) & (got == want)
    err = (got - want).abs() / (1.0 + want.abs() + sens)
    err = torch.where(both, torch.zeros_like(err), err)
    err = torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)
    return float(err.max()) if err.numel() else 0.0


class Judge:
    """Holds the reference side of one configuration."""

    def __init__(self, ref, ens, config, data, inv_covs):
        self.ref = ref
        self.ens = ens
        self.names = list(config["sampled"])
        self.fiducial = dict(config["fiducial"])
        self.stats = [(t["statistic"], t["accuracy"])
                      for t in config["tables"]]
        self.limits = dict(config["limits"])
        self.bounds = dict(config["bounds"])
        self.data = data
        self.inv_covs = inv_covs

    def params(self, theta):
        theta = theta.to(self.ref.device, torch.float64)
        p = {k: torch.full((theta.shape[0],), float(v), dtype=torch.float64,
                           device=theta.device)
             for k, v in self.fiducial.items()}
        for i, k in enumerate(self.names):
            p[k] = theta[:, i]
        return p

    def predict(self, theta):
        return self.ref.predict(self.params(theta))

    def log_prob(self, theta, preds=None):
        """The reference's log posterior at ``theta`` and its sensitivity:
        sum over elements of |C^-1 r| times the element's scale in its
        table's contract (itself, or its row's largest)."""
        preds = self.predict(theta) if preds is None else preds
        xis = [x.double().reshape(x.shape[0], -1) for _, x in preds]
        theta = theta.to(xis[0].device, torch.float64)
        lp = self.ens.log_posterior(xis, self.data, self.inv_covs, theta,
                                    self.names, self.bounds)
        sens = torch.zeros_like(lp)
        for (_, accuracy), xi, d, c in zip(self.stats, xis, self.data,
                                          self.inv_covs):
            scale = (xi.abs() if accuracy == "elementwise" else
                     xi.abs().amax(dim=1, keepdim=True))
            sens = sens + torch.sum(((xi - d) @ c).abs() * scale, dim=1)
        sens = torch.where(torch.isfinite(sens), sens, torch.zeros_like(sens))
        return lp, sens

    def _predictions(self, out, prog, ref):
        """Errors of one predictor call's statistics, on every row."""
        for (name, accuracy), (ngal_p, xi_p), (ngal_r, xi_r) in zip(
                self.stats, prog, ref):
            rows = xi_r.shape[0]
            xi_p = xi_p.double().reshape(rows, -1).to(xi_r.device)
            ngal_p = ngal_p.double().to(xi_r.device)
            nan_p = torch.isnan(xi_p).any(dim=1) | torch.isnan(ngal_p)
            nan_r = torch.isnan(xi_r).any(dim=1) | torch.isnan(ngal_r)
            out["nan_rows_mismatch"] += int((nan_p != nan_r).sum())
            keep = ~(nan_p | nan_r)
            out["ngal_rel_err"] = max(out["ngal_rel_err"], relative_err(
                ngal_p[keep], ngal_r[keep]))
            if accuracy == "elementwise":
                key, err = f"{name}_rel_err", relative_err(xi_p[keep],
                                                           xi_r[keep])
            else:
                key, err = f"{name}_scaled_err", scaled_err(xi_p[keep],
                                                            xi_r[keep])
            out[key] = max(out.get(key, 0.0), err)

    def judge(self, start, first, final, pred_calls, lp_calls, generator,
              a):
        """The numbers compared: ``{name: value}``.

        ``start`` and ``final`` are the program's (walkers, log-probs)
        before and after the window, ``first`` after its first step;
        ``pred_calls`` and ``lp_calls`` the first step's two calls of the
        predictor and the log posterior, as (argument, result);
        ``generator`` is in the state the sampler's had at the window's
        start."""
        out = {"ngal_rel_err": 0.0, "nan_rows_mismatch": 0,
               "logpost_err": 0.0, "walker_err": 0.0,
               "accept_flips": 0}
        dev = self.ref.device
        w0, lp0 = (x.to(dev) for x in start)
        w1, lp1 = (x.to(dev) for x in first)
        lp_start, sens_start = self.log_prob(w0)
        out["logpost_err"] = logpost_err(lp0, lp_start, sens_start)
        n = w0.shape[0] // 2
        n_dim = w0.shape[1]
        halves = [(slice(0, n), w0[:n], w0[n:]),
                  (slice(n, None), w0[n:], w1[:n])]
        for h, (rows, active, passive) in enumerate(halves):
            proposal, z, scale, log_u = self.ens.stretch_half(
                generator, active, passive, a, w0.dtype)
            theta = lp_calls[h][0].to(dev)
            lp_prop_p = lp_calls[h][1].to(dev)
            preds = self.predict(theta)
            self._predictions(out, pred_calls[h][1], preds)
            lp_prop, sens = self.log_prob(theta, preds)
            out["logpost_err"] = max(out["logpost_err"],
                                     logpost_err(lp_prop_p, lp_prop, sens))
            unit = scale + 1e-30
            # Decisions: the reference's, and the program's as its new
            # walkers show them; a flip counts only where the reference's
            # margin exceeds what the log-probs' own errors (and float32
            # rounding of the sum) could move.
            lp_act = lp_start[rows]
            log_acc = self.ens.log_accept(z, n_dim, lp_prop, lp_act)
            accept_r = log_u < log_acc
            accept_p = (w1[rows] == theta).all(dim=1)
            slack = ((lp_prop_p.double() - lp_prop).abs() +
                     (lp0[rows].double() - lp_act).abs())
            slack = torch.where(torch.isnan(slack), torch.zeros_like(slack),
                                slack)
            size = (lp_prop.abs() + lp_act.abs() + log_u.abs() +
                    (n_dim - 1.0) * torch.log(z).abs())
            size = torch.where(torch.isfinite(size), size,
                               torch.zeros_like(size))
            margin = slack + 4 * 2.0 ** -24 * size + 1e-12
            clear = (log_u - log_acc).abs() > margin
            flips = (accept_p != accept_r) & clear
            out["accept_flips"] += int(flips.sum())
            accept = torch.where(clear, accept_r, accept_p)
            new_w = torch.where(accept[:, None], proposal, active.double())
            new_unit = torch.where(accept[:, None], unit,
                                   active.double().abs() + 1e-30)
            out["walker_err"] = max(out["walker_err"], _max(
                ((w1[rows].double() - new_w).abs() / new_unit).amax(dim=1)))
            new_lp = torch.where(accept, lp_prop, lp_act)
            new_sens = torch.where(accept, sens, sens_start[rows])
            out["logpost_err"] = max(out["logpost_err"],
                                     logpost_err(lp1[rows], new_lp, new_sens))
        w_end, lp_end = (x.to(dev) for x in final)
        out["logpost_err"] = max(out["logpost_err"],
                                 logpost_err(lp_end, *self.log_prob(w_end)))
        return out

    def verdict(self, numbers):
        """``(correct, [(name, value, limit), ...])`` in the limits'
        order; a number without a limit, or a NaN, is not correct."""
        rows = [(k, numbers.get(k, math.nan), self.limits[k])
                for k in self.limits]
        extra = [k for k in numbers if k not in self.limits]
        ok = not extra and all(v <= lim for _, v, lim in rows)
        rows += [(k, numbers[k], math.nan) for k in extra]
        return ok, rows
