"""The port's shared numerics against tabcorr_tpu and scipy: the upper
incomplete gamma function and its derivatives, monotone inversion, and
the backend's interp.

Tolerances: Gamma(a, x) in float64 1e-8 relative over a in (-1, 1.5],
x in [1e-6, 50] (tabcorr_tpu's host path, scipy); its forward-mode
derivative in ``a`` 1e-3 relative against a float64 central difference
in float64 (away from the a = 0 blend, where the derivative is the
blend's slope), and in float32 5e-3 for x <= 10 and never worse than
tabcorr_tpu's float32 derivative; d/dx -x^(a-1) e^-x; monotone_inverse
round trips 1e-10 in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tabcorr_tpu.utils.inversion import monotone_inverse as jax_inverse
from tabcorr_tpu.utils.special import (
    _gamma_upper_lowerable as jax_series_cf,
    upper_incomplete_gamma as jax_gamma)
from tabcorr_tpu_torch.utils import backend
from tabcorr_tpu_torch.utils.inversion import monotone_inverse
from tabcorr_tpu_torch.utils.special import (_gamma_upper_series_cf,
                                             upper_incomplete_gamma)

A = np.concatenate([np.linspace(-0.99, 1.5, 60),
                    [-1e-6, 0.0, 1e-6, -2e-3, 2e-3, 1e-5]])
X = np.geomspace(1e-6, 50.0, 41)


def _grid():
    a, x = np.meshgrid(A, X, indexing="ij")
    return a, x


def test_gamma_float64_matches_scipy_and_jax():
    a, x = _grid()
    want = jax_gamma(a, x)                      # numpy: scipy
    got = upper_incomplete_gamma(torch.tensor(a), torch.tensor(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=0)
    # The numpy path of the port is the JAX package's host path.
    np.testing.assert_array_equal(upper_incomplete_gamma(a, x), want)
    dev = np.asarray(jax.jit(jax_gamma)(jnp.asarray(a), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), dev, rtol=1e-8, atol=0)


def test_gamma_float32_stays_float32_and_near_float64():
    a, x = _grid()
    got = upper_incomplete_gamma(torch.tensor(a, dtype=torch.float32),
                                 torch.tensor(x, dtype=torch.float32))
    assert got.dtype == torch.float32
    want = jax_gamma(a.astype(np.float32).astype(np.float64),
                     x.astype(np.float32).astype(np.float64))
    ref = np.asarray(jax_gamma(jnp.asarray(a, jnp.float32),
                               jnp.asarray(x, jnp.float32)), np.float64)
    err = np.abs(got.double().numpy() / want - 1)
    err_jax = np.abs(ref / want - 1)
    # Both float32 evaluations share the algorithm (the recurrence for
    # a < 0 cancels as x grows, the blend near a = 0); the port is as
    # close to float64 as tabcorr_tpu's float32 path is.
    benign = (np.abs(a) > 0.05) & (x <= 2.0)
    assert np.max(err[benign]) <= 1e-5
    for lo, hi in ((1e-6, 2.0), (2.0, 10.0), (10.0, 50.0)):
        band = (x >= lo) & (x <= hi) & (np.abs(a) > 3e-3)
        assert np.max(err[band]) <= 2.0 * np.max(err_jax[band]) + 1e-6


def test_gamma_derivative_in_a_matches_central_difference():
    a, x = _grid()
    # Outside the blends around a = 0 (half-widths 1e-5 in float64, 3e-3
    # in float32), where the derivative is the blend's slope.
    keep = np.abs(a) > 4e-3
    a, x = a[keep], x[keep]
    h = 1e-6
    fd = (jax_gamma(a + h, x) - jax_gamma(a - h, x)) / (2 * h)
    for dtype in (torch.float64, torch.float32):
        at = torch.tensor(a, dtype=dtype)
        xt = torch.tensor(x, dtype=dtype)
        _, d = torch.func.jvp(lambda s: upper_incomplete_gamma(s, xt),
                              (at,), (torch.ones_like(at),))
        assert d.dtype == dtype
        if dtype == torch.float64:
            np.testing.assert_allclose(d.numpy(), fd, rtol=1e-3)
        else:
            # float32 inputs, against the difference at the float32-rounded
            # (a, x): the derivative is formed in float64, but the a < 0
            # recurrence differentiates float32 values whose difference
            # cancels as x / |a| grows; tabcorr_tpu's float32 derivative
            # (igamma_grad_a through the same recurrence) errs more.
            a32 = at.double().numpy()
            x32 = xt.double().numpy()
            fd32 = (jax_gamma(a32 + h, x32) - jax_gamma(a32 - h, x32)) / (
                2 * h)
            err = np.abs(d.double().numpy() / fd32 - 1)
            _, d_jax = jax.jvp(
                lambda s: jax_gamma(s, jnp.asarray(x, jnp.float32)),
                (jnp.asarray(a, jnp.float32),),
                (jnp.ones(a.shape, jnp.float32),))
            err_jax = np.abs(np.asarray(d_jax, np.float64) / fd32 - 1)
            assert np.max(err[x <= 10.0]) <= 5e-3
            assert np.max(err) <= min(0.1, np.max(err_jax))
        # Reverse mode gives the same derivative, up to the float32
        # rounding of the recurrence's other order of operations.
        at_r = at.clone().requires_grad_()
        upper_incomplete_gamma(at_r, xt).sum().backward()
        torch.testing.assert_close(
            at_r.grad, d, atol=0,
            rtol=1e-10 if dtype == torch.float64 else 1e-3)


def test_gamma_derivative_in_x_is_exact():
    # -x^(a-1) e^-x: exact for a > 0; the recurrence for a < 0 subtracts
    # two terms of size x^a e^-x, and the blend around a = 0 takes its
    # ends' derivatives.
    a, x = _grid()
    at, xt = torch.tensor(a), torch.tensor(x)
    _, d = torch.func.jvp(lambda s: upper_incomplete_gamma(at, s), (xt,),
                          (torch.ones_like(xt),))
    err = np.abs(d.numpy() / (-x ** (a - 1) * np.exp(-x)) - 1)
    assert np.max(err[a >= 1e-5]) <= 1e-12
    assert np.max(err[a <= -1e-5]) <= 1e-9
    assert np.max(err) <= 1e-7


def test_series_cf_form_matches_the_jax_package():
    # The derivative comes from this form: it is tabcorr_tpu's
    # Mosaic-safe Gamma(a, x), term for term.
    a = np.linspace(3e-3, 3.0, 37)[:, None] + np.zeros((1, 29))
    x = np.geomspace(1e-6, 50.0, 29)[None, :] + np.zeros((37, 1))
    got = _gamma_upper_series_cf(torch.tensor(a), torch.tensor(x)).numpy()
    ref = np.asarray(jax_series_cf(jnp.asarray(a), jnp.asarray(x), jnp))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_allclose(got, jax_gamma(a, x), rtol=1e-7)


@pytest.mark.parametrize("seed", ["interp", "bisect"])
def test_monotone_inverse_round_trips(seed):
    grid = np.linspace(-3.0, 3.0, 101)
    y = np.linspace(-20.0, 20.0, 17)

    def fn(t, c=0.0):
        return t ** 3 + 2 * t + c

    def dfn(t):
        return 3 * t ** 2 + 2

    x_np = monotone_inverse(fn, y, grid, dfn=dfn, seed=seed)
    np.testing.assert_allclose(fn(x_np), y, atol=1e-10)
    np.testing.assert_allclose(
        x_np, jax_inverse(fn, y, grid, dfn=dfn, seed=seed), rtol=1e-12)
    # Tensors with batched parameters (B, 1) against queries (17,): the
    # default derivative is forward mode.
    c = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64)[:, None]
    yt = torch.tensor(y)
    x_t = monotone_inverse(lambda t: fn(t, c), yt, torch.tensor(grid),
                           seed=seed)
    assert x_t.shape == (5, 17)
    torch.testing.assert_close(fn(x_t, c), yt.expand(5, 17), rtol=0,
                               atol=1e-10)
    # Parameter derivatives through the Newton steps: d root / dc =
    # -1 / (3 t^2 + 2).
    cg = c.clone().requires_grad_()
    root = monotone_inverse(lambda t: fn(t, cg), yt, torch.tensor(grid),
                            seed=seed)
    (g,) = torch.autograd.grad(root.sum(), cg)
    want = (-1.0 / dfn(root.detach())).sum(dim=1, keepdim=True)
    torch.testing.assert_close(g, want, rtol=1e-8, atol=0)


def test_monotone_inverse_float32_stays_float32():
    grid = torch.linspace(5.0, 13.0, 257)
    y = torch.linspace(11.0, 14.0, 9)
    x = monotone_inverse(lambda t: 1.5 * t - 2.0, y, grid,
                         dfn=lambda t: torch.full_like(t, 1.5))
    assert x.dtype == torch.float32
    torch.testing.assert_close(1.5 * x - 2.0, y, rtol=0, atol=3e-6)
    with pytest.raises(ValueError):
        monotone_inverse(lambda t: t, y, None, seed="interp")
    with pytest.raises(ValueError):
        monotone_inverse(lambda t: t, y, grid, seed="newton")


def test_interp_matches_numpy_and_clamps():
    rng = np.random.default_rng(2)
    xp = np.cumsum(rng.uniform(0.1, 1.0, 23))
    fp = rng.normal(size=23)
    x = rng.uniform(xp[0] - 2, xp[-1] + 2, (7, 11))
    x[0, :3] = xp[:3]                           # on the knots
    got = backend.interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp))
    np.testing.assert_allclose(got.numpy(), np.interp(x, xp, fp),
                               rtol=1e-14, atol=1e-14)
    # Batched knots (B, 1, G) broadcast against (7, 11) queries.
    scale = np.array([1.0, 2.0, 0.5])[:, None, None]
    xpb = torch.tensor(xp[None, None, :] * scale)
    got = backend.interp(torch.tensor(x), xpb, torch.tensor(fp))
    assert got.shape == (3, 7, 11)
    for b in range(3):
        np.testing.assert_allclose(
            got[b].numpy(), np.interp(x, xp * scale[b, 0, 0], fp),
            rtol=1e-14, atol=1e-14)


def test_asarray_keeps_the_reference_dtype_and_device():
    ref32 = torch.zeros(3)
    assert backend.asarray(10.5, ref32).dtype == torch.float32
    assert backend.asarray(np.float64(10.5), ref32).dtype == torch.float32
    assert backend.asarray(np.arange(3.0), ref32).dtype == torch.float32
    assert backend.asarray(1.0, np.zeros(2, np.float32)).dtype == np.float32
    for fn, ref in ((backend.arctan, np.arctan), (backend.log1p, np.log1p),
                    (backend.log10, np.log10)):
        v = np.array([0.3, 1.7])
        np.testing.assert_allclose(fn(torch.tensor(v)).numpy(), ref(v),
                                   rtol=1e-15)
        np.testing.assert_array_equal(fn(v), ref(v))
