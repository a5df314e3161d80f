"""HOD occupation models of the port."""

from .protocol import CENTRALS, SATELLITES, HodModel, occupation_functions
from .zheng07 import (ZHENG07_THRESHOLD_PARAMS, Zheng07Model,
                      zheng07_centrals, zheng07_satellites)

__all__ = ["HodModel", "Zheng07Model", "occupation_functions",
           "zheng07_centrals", "zheng07_satellites",
           "ZHENG07_THRESHOLD_PARAMS", "CENTRALS", "SATELLITES"]
