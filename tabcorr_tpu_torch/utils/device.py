"""Device resolution.

Every entry point that builds tables or predictors takes ``device=``,
``"cuda"`` by default: the port runs on the card unless the caller asks
for the CPU.  Asking for CUDA where torch finds none raises instead of
running on the CPU, and ``device=None`` raises too.
"""

from __future__ import annotations

import numpy as np
import torch

FLOAT_DTYPES = (torch.bfloat16, torch.float32, torch.float64)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` ('cpu' or 'cuda[:i]'), checked."""
    if device is None:
        raise ValueError("device must be given explicitly ('cpu' or 'cuda').")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for, but torch finds "
                               "no CUDA device.")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"Unsupported device {device}; use 'cpu' or 'cuda'.")
    return device


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    """``dtype`` if the tables take it (bfloat16, float32, float64)."""
    if dtype not in FLOAT_DTYPES:
        raise ValueError(f"Unsupported dtype {dtype}; use bfloat16, float32 "
                         "or float64.")
    return dtype


def host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """``a`` (array-like) as a new CPU tensor of ``dtype``, rounded once
    from float64.  numpy has no bfloat16: torch rounds it, as
    ``jnp.asarray(x64, dtype=jnp.bfloat16)`` does (rounding through
    float32 first would round twice)."""
    x64 = np.array(a, dtype=np.float64)
    return torch.from_numpy(x64).to(check_dtype(dtype))
