"""Array-namespace dispatch for the occupation functions.

The pure model functions run on torch tensors (the float32 device path)
and on numpy arrays (the float64 host oracle).  ``get_namespace`` picks
the namespace from the input, and the functions below dispatch the same
way.  ``asarray`` puts a constant into the namespace, dtype and device of
a reference array: a float64 constant (a threshold, a grid, a spline
coefficient) never promotes a float32 tensor.

The float32 path uses torch's own functions as they are.  Measured on the
CPU in float32 against scipy/numpy float64: ``torch.special.erfc`` within
8.7e-8 relative on [-6, 6], ``torch.exp`` within 6.1e-8 relative on
[-20, 10], ``torch.log1p`` within 2.4e-7 absolute on [-0.999, 0.25] --
all inside the occupation pipeline's 1e-6 contract.  (The CUDA kernel
calls the matching CUDA math library functions, compiled without fast
math.)
"""

from __future__ import annotations

import numpy as np
import torch


def is_numpy(*arrays) -> bool:
    """True if all arguments are host numpy arrays or Python numbers."""
    return all(isinstance(a, (np.ndarray, np.generic, float, int))
               for a in arrays)


def get_namespace(*arrays):
    """numpy for host inputs, torch otherwise."""
    return np if is_numpy(*arrays) else torch


def is_float64(x) -> bool:
    """True for float64 numpy arrays and tensors."""
    return x.dtype in (np.dtype(np.float64), torch.float64)


def erfc(x):
    """Complementary error function on the matching backend.

    Occupation models prefer ``0.5 * erfc(-x)`` over ``0.5 * (1 + erf(x))``:
    the latter loses the whole x -> -inf tail to float32 cancellation
    against 1, and deep-tail halo bins carry the largest halo densities.
    """
    if is_numpy(x):
        from scipy.special import erfc as np_erfc
        return np_erfc(x)
    return torch.special.erfc(x)


def exp(x):
    """exp on the matching backend."""
    return np.exp(x) if is_numpy(x) else torch.exp(x)


def exp10(x):
    """10**x on the matching backend."""
    return 10.0 ** x


def log1p_abs(x):
    """log1p for callers whose use of the result is absolute-error bound
    (the result is added to an O(1) term), x in (-1, 0.25]."""
    return np.log1p(x) if is_numpy(x) else torch.log1p(x)


def log1p(x):
    """log1p on the matching backend."""
    return np.log1p(x) if is_numpy(x) else torch.log1p(x)


def arctan(x):
    """arctan on the matching backend."""
    return np.arctan(x) if is_numpy(x) else torch.atan(x)


def log10(x):
    """log10 on the matching backend (Python numbers count as numpy)."""
    return np.log10(x) if is_numpy(x) else torch.log10(x)


def asarray(value, like):
    """``value`` as an array of ``like``'s namespace, dtype and device."""
    if is_numpy(like):
        return np.asarray(value, dtype=np.asarray(like).dtype)
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def interp(x, xp, fp):
    """Piecewise-linear interpolation, clamped to the end values beyond
    the sample points, as ``numpy.interp``.

    On numpy ``xp`` and ``fp`` are 1-D.  On tensors ``xp`` may carry
    leading batch axes, (..., G), increasing along the last axis (a
    sampled relation per parameter vector), and ``fp`` is (G,) or of
    ``xp``'s shape; the leading axes broadcast against ``x`` as the
    parameter axes broadcast against the nodes elsewhere (``xp`` (B, 1,
    G) and ``x`` (n_bins, n_gauss) give (B, n_bins, n_gauss)).  The
    interval comes from ``torch.searchsorted``.
    """
    if is_numpy(x, xp, fp):
        return np.interp(x, xp, fp)
    n = xp.shape[-1]
    params = xp.shape[:-1] + (1,)
    out_shape = torch.broadcast_shapes(params, x.shape)
    params = (1,) * (len(out_shape) - len(params)) + params
    # The leading axes along which the samples vary; the query axes
    # after them hold no batch axis of ``xp``.
    k = len(params)
    while k > 0 and params[k - 1] == 1:
        k -= 1
    lead = tuple(out_shape[:k])
    sorted_x = xp.reshape(params[:k] + (n,)).expand(lead + (n,))
    sorted_x = sorted_x.reshape(-1, n).contiguous()
    sorted_f = torch.broadcast_to(fp, xp.shape).reshape(
        params[:k] + (n,)).expand(lead + (n,)).reshape(-1, n)
    q = x.expand(out_shape).reshape(sorted_x.shape[0], -1).contiguous()
    hi = torch.searchsorted(sorted_x, q).clamp(1, n - 1)
    lo = hi - 1
    x0, x1 = sorted_x.gather(1, lo), sorted_x.gather(1, hi)
    f0, f1 = sorted_f.gather(1, lo), sorted_f.gather(1, hi)
    t = ((q - x0) / (x1 - x0)).clamp(0.0, 1.0)
    return (f0 + t * (f1 - f0)).reshape(out_shape)
