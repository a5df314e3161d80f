"""Drop-in, signature-compatible correlation-function statistics.

The reference ships Corrfunc-backed wrappers with halotools call signatures
(reference: tabcorr/corrfunc.py); these are the same functions with the
same conventions, counting pairs with the port's labeled pair counter
(:mod:`tabcorr_tpu_torch.ops.paircount`: the CUDA kernel, or its plain
version with ``device="cpu"``).
"""

from .ops.paircount import mean_delta_sigma, s_mu_tpcf, tpcf, wp

__all__ = ["wp", "s_mu_tpcf", "tpcf", "mean_delta_sigma"]
