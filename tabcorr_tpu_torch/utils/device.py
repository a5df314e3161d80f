"""Device resolution.

Every entry point that builds tables or predictors takes ``device=``,
``"cuda"`` by default: the port runs on the card unless the caller asks
for the CPU.  Asking for CUDA where torch finds none raises instead of
running on the CPU, and ``device=None`` raises too.
"""

from __future__ import annotations

import numpy as np
import torch

NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


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


def numpy_dtype(dtype: torch.dtype):
    """The numpy dtype matching a floating torch dtype."""
    if dtype not in NUMPY_DTYPES:
        raise ValueError(f"Unsupported dtype {dtype}; use float32 or float64.")
    return NUMPY_DTYPES[dtype]
