"""Prediction operators: the tensor path (``predict``) and the bundle
kernel with its plain version (``fused``)."""

from .fused import bundle_predict_plain, make_fused_bundle_predictor
from .predict import (AUTO, TableData, mean_occupation,
                      predict_from_occupation, quadrature_grid)

__all__ = ["AUTO", "TableData", "bundle_predict_plain",
           "make_fused_bundle_predictor", "mean_occupation",
           "predict_from_occupation", "quadrature_grid"]
