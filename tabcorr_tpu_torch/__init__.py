"""tabcorr_tpu_torch: the PyTorch + CUDA port of tabcorr_tpu.

Reads reference-format tabulations and Interpolator grids, evaluates the
zheng07 HOD and its Heaviside assembly-bias decoration, predicts wp /
xi_ell / Delta Sigma for whole batches of parameter vectors -- on an
NVIDIA H100 through one hand-written CUDA kernel per batch (``ops.fused``;
``csrc/bundle.cu``, ``csrc/grid.cu`` and ``csrc/slab.cu``) -- and samples
posteriors with a stretch-move ensemble.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; without a card they
raise rather than fall back.
"""

from . import mcmc
from .interpolator import Interpolator
from .models import (AssembiasZheng07Model, HeavisideAssembiasMixin,
                     HodModel, Zheng07Model, heaviside_assembias)
from .predictor import (make_multi_predictor, make_occupation_predictor,
                        make_predictor, occupation_functions, params_batch)
from .table import TabCorr

__all__ = ["TabCorr", "Interpolator", "HodModel", "Zheng07Model",
           "AssembiasZheng07Model", "HeavisideAssembiasMixin",
           "heaviside_assembias", "make_multi_predictor",
           "make_occupation_predictor", "make_predictor",
           "occupation_functions", "params_batch", "mcmc"]
