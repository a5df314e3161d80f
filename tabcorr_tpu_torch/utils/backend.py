"""Array-namespace dispatch for the occupation functions.

The pure model functions run on torch tensors (the float32 device path)
and on numpy arrays (the float64 host oracle).  ``get_namespace`` picks
the namespace from the input, and the four transcendentals below dispatch
the same way.

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
