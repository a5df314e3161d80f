"""HOD occupation models of the port."""

from .assembias import (ASSEMBIAS_PARAMS, AssembiasZheng07Model,
                        HeavisideAssembiasMixin, heaviside_assembias)
from .protocol import CENTRALS, SATELLITES, HodModel, occupation_functions
from .zheng07 import (ZHENG07_THRESHOLD_PARAMS, Zheng07Model,
                      zheng07_centrals, zheng07_satellites)

__all__ = ["HodModel", "Zheng07Model", "AssembiasZheng07Model",
           "HeavisideAssembiasMixin", "heaviside_assembias",
           "ASSEMBIAS_PARAMS", "occupation_functions", "zheng07_centrals",
           "zheng07_satellites", "ZHENG07_THRESHOLD_PARAMS", "CENTRALS",
           "SATELLITES"]
