"""Special functions shared by occupation models.

Port of ``tabcorr_tpu/utils/special.py``: the (non-regularized) upper
incomplete gamma function Gamma(a, x) for a possibly negative first
argument, which the Cacciato et al. (2009) satellites need (their
faint-end slope puts a = (alpha_sat + 1) / 2 in (-1/2, 0] at the
published fit).

``gammaincc`` (scipy, torch) is the REGULARIZED Q(a, x) for a > 0 only,
so Gamma(a, x) for a <= 0 takes one step of the upward recurrence

    Gamma(a, x) = ( Gamma(a + 1, x) - x^a e^-x ) / a,

and inside |a| < tol the value is blended linearly between the exact
evaluations at a = -tol and a = +tol (the recurrence's numerator
vanishes at a = 0), as in the JAX package, with its tolerances.

On tensors Gamma(a, x) for a > 0 is ``torch.special.gammaincc(a, x) *
exp(lgamma(a))``.  torch gives ``gammaincc`` no derivative in ``a``, which
the port needs: Cacciato09's float32 occupation absorbs the quadrature
nodes' residual through a forward-mode derivative in log M, and ``a``
depends on log M.  :class:`_GammaUpper` supplies it: d/dx is exact,
-x^(a-1) e^-x, and d/da is the forward-mode derivative, in float64, of
:func:`_gamma_upper_series_cf`, the JAX package's branchless series /
continued-fraction form of Gamma(a, x) (pure arithmetic; ~1e-7 relative
in its derivative over the range the occupation uses, see
tests/test_torch_special.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import get_namespace

# Blend half-width around a = 0 (see tabcorr_tpu/utils/special.py):
# float64 and the float32 device path.
_TOL64 = 1e-5
_TOL32 = 3e-3

# Floor for x: the integral's lower limit is delta (L_t / L*_s)^2 > 0; a
# zero only appears through float underflow at absurd halo masses.
_X_FLOOR = 1e-35

# (Gamma(1 + z) - 1) / z on z in [0, 1]: the JAX package's degree-12 fit
# (max abs err 6e-10).
_G1_COEFFS = (
    -0.5772156643037297, 0.9890558815380694, -0.9074737274559522,
    0.9816180916637941, -0.9807524315455647, 0.9844490957280668,
    -0.9553739920034312, 0.8651290094012174, -0.6822383126208814,
    0.43064844593534757, -0.19690600270488187, 0.05665806466967681,
    -0.007598458719435523)
_N_SERIES = 22
_N_CF = 26


def _gamma_upper_series_cf(a, x):
    """Gamma(a, x) for tensors a in (0, ~3.5], x > 0, branchless: the
    Temme series for x < a + 1 (a reduced by 0-2 into (0, 1], recurred
    up), the modified-Lentz continued fraction otherwise.  Port of
    ``tabcorr_tpu/utils/special.py:_gamma_upper_lowerable``; here it
    serves the derivative in ``a``, evaluated in float64."""
    xs = torch.minimum(x, a + 1.0)
    lnx = torch.log(xs)
    k1 = a > 1.0
    k2 = a > 2.0
    a_r = a - k1.to(a.dtype) - k2.to(a.dtype)
    u = a_r * lnx
    g1 = torch.zeros_like(a_r)
    for c in _G1_COEFFS[::-1]:
        g1 = g1 * a_r + c
    bracket = a_r * g1 - torch.expm1(u)
    term = torch.ones_like(xs)
    tail = torch.zeros_like(xs)
    for n in range(1, _N_SERIES):
        term = term * (-xs) / n
        tail = tail + term / (a_r + n)
    xar = torch.exp(u)
    g = bracket / a_r - xar * tail
    emx = torch.exp(-xs)
    g = torch.where(k1, a_r * g + xar * emx, g)
    a_r1 = torch.where(k1, a_r + 1.0, a_r)
    g_series = torch.where(k2, a_r1 * g + torch.exp(a_r1 * lnx) * emx, g)
    xc = torch.maximum(x, a + 1.0)
    tiny = 1e-30
    b = xc + 1.0 - a
    d = 1.0 / torch.where(torch.abs(b) < tiny, tiny, b)
    c_l = torch.full_like(xc, 1.0 / tiny)
    h = d
    for i in range(1, _N_CF):
        an = -i * (i - a)
        b = b + 2.0
        d = b + an * d
        d = 1.0 / torch.where(torch.abs(d) < tiny, tiny, d)
        c_l = b + an / c_l
        c_l = torch.where(torch.abs(c_l) < tiny, tiny, c_l)
        h = h * d * c_l
    g_cf = torch.exp(a * torch.log(xc) - xc) * h
    return torch.where(x < a + 1.0, g_series, g_cf)


def _dgamma_da(a, x):
    """d Gamma(a, x) / da in ``a``'s dtype, from the float64 forward-mode
    derivative of :func:`_gamma_upper_series_cf`."""
    a64, x64 = a.double(), x.double()
    _, d = torch.func.jvp(lambda s: _gamma_upper_series_cf(s, x64),
                          (a64,), (torch.ones_like(a64),))
    return d.to(a.dtype)


def _dgamma_dx(a, x):
    return -torch.exp((a - 1.0) * torch.log(x) - x)


class _GammaUpper(torch.autograd.Function):
    """Gamma(a, x) for a > 0 on tensors of one shape, with derivatives in
    both arguments (forward and reverse mode), under ``torch.vmap`` too
    (the unvectorized predictors are mapped over chains)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, x):
        return torch.special.gammaincc(a, x) * torch.exp(torch.lgamma(a))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, da, dx):
        a, x = ctx.saved_tensors
        out = torch.zeros_like(a)
        if da is not None:
            out = out + _dgamma_da(a, x) * da
        if dx is not None:
            out = out + _dgamma_dx(a, x) * dx
        return out

    @staticmethod
    def backward(ctx, grad):
        a, x = ctx.saved_tensors
        da = grad * _dgamma_da(a, x) if ctx.needs_input_grad[0] else None
        dx = grad * _dgamma_dx(a, x) if ctx.needs_input_grad[1] else None
        return da, dx


def _gammaincc_unreg(a, x, xp):
    """Gamma(a, x) = Q(a, x) Gamma(a) for a > 0."""
    if xp is np:
        from scipy.special import gammaincc, gammaln
        return gammaincc(a, x) * np.exp(gammaln(a))
    return _GammaUpper.apply(*torch.broadcast_tensors(a, x))


def upper_incomplete_gamma(a, x):
    """Non-regularized Gamma(a, x) = int_x^inf t^(a-1) e^-t dt, a > -1.

    Vectorized and branchless over arrays whose elements may straddle
    a = 0 (the Cacciato09 satellite slope varies with halo mass).
    Domain: a > -1 (one recurrence step), x > 0.  numpy / scipy on host
    inputs, torch otherwise (differentiable in both arguments).
    """
    xp = get_namespace(a, x)
    if xp is np:
        a = np.asarray(a)
        x = np.asarray(x)
        dtype = np.result_type(a, x)
        a = a.astype(dtype)
        x = np.maximum(x.astype(dtype), dtype.type(_X_FLOOR))
    else:
        a, x = torch.as_tensor(a), torch.as_tensor(x)
        dtype = torch.result_type(a, x)
        a = a.to(dtype)
        x = torch.clamp(x.to(dtype), min=_X_FLOOR)
    tol = _TOL64 if dtype in (np.float64, torch.float64) else _TOL32

    # The direct branch never sees a <= 0 and the recurrence branch never
    # sees a > -tol, so both are well posed for every element.
    a_hi = xp.where(a >= tol, a, tol)             # > 0
    a_lo = xp.where(a <= -tol, a, -tol)           # <= -tol, > -1
    g_hi = _gammaincc_unreg(a_hi, x, xp)
    g_lo = (_gammaincc_unreg(a_lo + 1.0, x, xp) -
            x ** a_lo * xp.exp(-x)) / a_lo
    w = xp.clip((a + tol) / (2.0 * tol), 0.0, 1.0)
    return xp.where(a >= tol, g_hi,
                    xp.where(a <= -tol, g_lo,
                             (1.0 - w) * g_lo + w * g_hi))
