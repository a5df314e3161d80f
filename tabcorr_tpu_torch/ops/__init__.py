"""Prediction operators: the tensor path (``predict``) and the CUDA
kernels with their plain versions (``fused``)."""

from .fused import (bundle_predict_plain, make_fused_bundle_predictor,
                    make_fused_contraction, make_fused_grid_predictor,
                    make_fused_predictor)
from .predict import (AUTO, TableData, mean_occupation,
                      predict_from_occupation,
                      predict_from_occupation_separate, quadrature_grid)

__all__ = ["AUTO", "TableData", "bundle_predict_plain",
           "make_fused_bundle_predictor", "make_fused_contraction",
           "make_fused_grid_predictor", "make_fused_predictor",
           "mean_occupation", "predict_from_occupation",
           "predict_from_occupation_separate", "quadrature_grid"]
