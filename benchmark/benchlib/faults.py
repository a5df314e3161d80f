"""Faults planted under the timed path, to show that the comparison
catches each fault a cell can have (``tests/`` on the CPU,
``calibrate.py --fault`` on the card).  None is used by a run."""

from __future__ import annotations

import torch


def stale(step):
    """A sampler step that does its work and returns its state unchanged."""
    def wrapped(generator, walkers, log_prob, log_prob_fn, **kwargs):
        _, _, accept = step(generator, walkers, log_prob, log_prob_fn,
                            **kwargs)
        return walkers, log_prob, accept
    return wrapped


def half_batch(predict):
    """A predictor that evaluates the first half of the batch and hands
    the second half the first half's answers."""
    def wrapped(params):
        batch = next(iter(params.values())).shape[0]
        half = (batch + 1) // 2
        outs = predict({k: v[:half] for k, v in params.items()})
        return [tuple(torch.cat([x, x])[:batch] for x in out)
                for out in outs]
    return wrapped


def altered(predict, rel=1e-4):
    """A predictor whose answer for one row is altered where it is made:
    the row's largest statistic scaled by 1 + ``rel``."""
    def wrapped(params):
        outs = predict(params)
        ngal, xi = outs[0]
        row = xi.shape[0] // 3
        flat = xi.reshape(xi.shape[0], -1).clone()
        k = int(flat[row].abs().argmax())
        flat[row, k] = flat[row, k] * (1.0 + rel)
        return [(ngal, flat.reshape(xi.shape))] + list(outs[1:])
    return wrapped


PREDICTOR = {"half": half_batch, "alter": altered}
STEP = {"stale": stale}
