"""Inversion of monotone scalar relations.

Port of ``tabcorr_tpu/utils/inversion.py``.  The SHMR-based HOD models
(models.leauthaud11, models.zu_mandelbaum15) evaluate the stellar mass at
a given halo mass where only the halo-mass-at-stellar-mass direction is
closed-form; a user model (``FunctionalHodModel``) may invert its own
relations the same way.

Two seeds feed the Newton refinement:

* **interp**: piecewise-linear interpolation of ``fn`` sampled on a fixed
  grid (``utils.backend.interp``: ``torch.searchsorted`` on tensors);
  the default.
* **bisect**: a fixed number of bracket halvings, ``where`` and
  arithmetic only; the default where no grid is given.

Both land well inside the Newton basin, and three Newton steps take either
to float precision; the refined root differentiates through the final
residual evaluations (autograd or ``torch.func``), not through the seed.
"""

from __future__ import annotations

import torch

from .backend import get_namespace, interp, is_numpy


def monotone_inverse(fn, y, x_grid=None, dfn=None, newton_steps=3,
                     bracket=None, bisect_steps=15, seed="auto",
                     clamp=False):
    """Solve fn(x) = y for a strictly monotone increasing, differentiable
    ``fn``.

    Parameters
    ----------
    fn : callable
        Strictly monotone increasing map ``x -> y`` (vectorized; on
        tensors its parameters may carry batch axes, see
        ``utils.backend.interp``).
    y : array or tensor
        Query values.
    x_grid : array or tensor, optional
        Sorted abscissae covering the solution range for the interp seed;
        roots outside clamp to the grid ends before refinement.  Required
        unless ``bracket`` is given.
    dfn : callable, optional
        Analytic derivative ``x -> dfn/dx``.  Default: ``fn``'s
        forward-mode derivative (``torch.func.jvp``; tensors only).
    newton_steps : int, optional
        Newton refinements (3).
    bracket : (float, float), optional
        Solution bounds for the bisect seed; default the ends of
        ``x_grid``.
    bisect_steps : int, optional
        Bracket halvings of the bisect seed (15).
    seed : {'auto', 'interp', 'bisect'}, optional
        'auto' is interp where ``x_grid`` is given, else bisect.
    clamp : bool, optional
        Hold each Newton step to the bracket (``bracket``, default the
        ends of ``x_grid``), so that a root beyond it gives its end: a
        nearly flat ``fn`` otherwise sends a step far outside (False).

    Returns
    -------
    The root, ``y``'s shape broadcast against ``fn``'s parameters.
    """
    xp = get_namespace(y) if x_grid is None else get_namespace(y, x_grid)
    if seed == "auto":
        seed = "bisect" if x_grid is None else "interp"
    if seed == "interp":
        if x_grid is None:
            raise ValueError("seed='interp' requires x_grid.")
        x = interp(y, fn(x_grid), x_grid)
    elif seed == "bisect":
        if bracket is None and x_grid is None:
            raise ValueError("seed='bisect' requires bracket= or x_grid.")
        bracket = bracket or (float(x_grid[0]), float(x_grid[-1]))
        y = xp.asarray(y)
        lo = xp.full(y.shape, bracket[0], dtype=y.dtype)
        hi = xp.full(y.shape, bracket[1], dtype=y.dtype)
        if xp is torch:
            lo, hi = lo.to(y.device), hi.to(y.device)
        for _ in range(bisect_steps):
            mid = 0.5 * (lo + hi)
            above = fn(mid) > y
            hi = xp.where(above, mid, hi)
            lo = xp.where(above, lo, mid)
        x = 0.5 * (lo + hi)
    else:
        raise ValueError(f"Unknown seed strategy: {seed!r}")
    if dfn is None:
        if is_numpy(x):
            raise ValueError("numpy inputs need an analytic dfn.")

        def dfn(x_value):
            return torch.func.jvp(fn, (x_value,),
                                  (torch.ones_like(x_value),))[1]
    for _ in range(newton_steps):
        x = x - (fn(x) - y) / dfn(x)
        if clamp:
            x = xp.clip(x, *(bracket or (float(x_grid[0]),
                                         float(x_grid[-1]))))
    return x
