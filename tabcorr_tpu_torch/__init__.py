"""tabcorr_tpu_torch: the PyTorch + CUDA port of tabcorr_tpu.

Reads reference-format tabulations, evaluates the zheng07 HOD, predicts
wp / xi_ell / Delta Sigma for whole batches of parameter vectors -- on an
NVIDIA H100 through one hand-written CUDA kernel per batch (``ops.fused``,
``csrc/bundle.cu``) -- and samples posteriors with a stretch-move ensemble.
Every function that builds tables or predictors takes an explicit
``device=``.
"""

from . import mcmc
from .models import HodModel, Zheng07Model
from .predictor import (make_multi_predictor, make_predictor,
                        occupation_functions, params_batch)
from .table import TabCorr

__all__ = ["TabCorr", "HodModel", "Zheng07Model", "make_multi_predictor",
           "make_predictor", "occupation_functions", "params_batch", "mcmc"]
