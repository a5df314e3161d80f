"""tabcorr_tpu_torch: the PyTorch + CUDA port of tabcorr_tpu.

Tabulates halo correlation functions from a halo catalog
(``TabCorr.tabulate``: the dense mock on the host, one labeled pair count
per projection through the CUDA pair counter, ``csrc/paircount.cu``),
reads reference-format tabulations and Interpolator grids, evaluates the
HOD families of tabcorr_tpu (zheng07, Leauthaud11, Zu & Mandelbaum 15,
Cacciato09, Tinker13, each with its Heaviside assembly-bias decoration,
user functions and the non-parametric model), predicts wp / xi_ell /
Delta Sigma for whole batches of parameter vectors -- on an NVIDIA H100
through one hand-written CUDA kernel per batch (``ops.fused``;
``csrc/bundle.cu``, ``csrc/grid.cu`` and ``csrc/slab.cu``) -- and samples
posteriors with a stretch-move ensemble, HMC or NUTS (``mcmc``; the
gradient samplers differentiate the plain float64 engine).  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``; without
a card they raise rather than fall back.
"""

from . import corrfunc, cosmology, database, mcmc, models
from .halocat import HaloCatalog, ParticleCatalog
from .interpolator import Interpolator
from .mcmc import (effective_sample_size, ensemble_step, gelman_rubin,
                   hmc_step, integrated_autocorr_time, make_gaussian_logpost,
                   make_gaussian_logpost_batched, nuts_step, run_ensemble,
                   run_hmc, run_hmc_adaptive, run_nuts)
from .models import *  # noqa: F401,F403  (every name of models.__all__)
from .predictor import (make_multi_predictor, make_occupation_predictor,
                        make_predictor, occupation_functions, params_batch)
from .table import TabCorr
from .tabulate import (compute_tpcf_matrix, distribution_index,
                       sort_into_bins)
from .utils.packing import symmetric_matrix_to_array

__all__ = ["TabCorr", "Interpolator", "make_multi_predictor",
           "make_occupation_predictor", "make_predictor", "params_batch",
           "mcmc", "models", "HaloCatalog", "ParticleCatalog", "cosmology",
           "database", "corrfunc", "sort_into_bins", "distribution_index",
           "compute_tpcf_matrix", "symmetric_matrix_to_array",
           "run_ensemble", "ensemble_step", "run_hmc", "hmc_step",
           "run_hmc_adaptive", "run_nuts", "nuts_step",
           "make_gaussian_logpost", "make_gaussian_logpost_batched",
           "integrated_autocorr_time", "effective_sample_size",
           "gelman_rubin"] + list(models.__all__)
