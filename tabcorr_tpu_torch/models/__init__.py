"""HOD occupation models of the port (the names of tabcorr_tpu.models)."""

from .assembias import (ASSEMBIAS_PARAMS, AssembiasCacciato09Model,
                        AssembiasLeauthaud11Model, AssembiasTinker13Model,
                        AssembiasZheng07Model, AssembiasZuMandelbaum15Model,
                        HeavisideAssembiasMixin, heaviside_assembias)
from .cacciato09 import (CACCIATO09_PARAMS, Cacciato09Model,
                         cacciato09_centrals,
                         cacciato09_median_log_luminosity,
                         cacciato09_satellites)
from .functional import FunctionalHodModel
from .leauthaud11 import (LEAUTHAUD11_PARAMS, Leauthaud11Model,
                          behroozi10_log_halo_mass, fshmr_log_mstar,
                          leauthaud11_centrals, leauthaud11_satellites)
from .nonparametric import NonparametricHodModel, smoothness_log_prior
from .protocol import CENTRALS, SATELLITES, HodModel, occupation_functions
from .tinker13 import (TINKER13_PARAMS, Tinker13Model, tinker13_centrals,
                       tinker13_quiescent_fraction, tinker13_satellites)
from .zheng07 import (ZHENG07_THRESHOLD_PARAMS, Zheng07Model,
                      zheng07_centrals, zheng07_satellites)
from .zu_mandelbaum15 import (ZU_MANDELBAUM15_PARAMS, ZuMandelbaum15Model,
                              zu15_log_halo_mass, zu15_log_mstar,
                              zu15_scatter_ln_mstar,
                              zu_mandelbaum15_centrals,
                              zu_mandelbaum15_satellites)

__all__ = ["HodModel", "Zheng07Model", "AssembiasZheng07Model",
           "Leauthaud11Model", "AssembiasLeauthaud11Model",
           "ZuMandelbaum15Model", "AssembiasZuMandelbaum15Model",
           "Cacciato09Model", "AssembiasCacciato09Model",
           "Tinker13Model", "AssembiasTinker13Model",
           "tinker13_centrals", "tinker13_satellites",
           "tinker13_quiescent_fraction", "TINKER13_PARAMS",
           "HeavisideAssembiasMixin", "FunctionalHodModel",
           "NonparametricHodModel", "smoothness_log_prior",
           "zheng07_centrals", "zheng07_satellites",
           "leauthaud11_centrals", "leauthaud11_satellites",
           "zu_mandelbaum15_centrals", "zu_mandelbaum15_satellites",
           "cacciato09_centrals", "cacciato09_satellites",
           "cacciato09_median_log_luminosity",
           "behroozi10_log_halo_mass", "fshmr_log_mstar",
           "zu15_log_halo_mass", "zu15_log_mstar",
           "zu15_scatter_ln_mstar",
           "heaviside_assembias", "ZHENG07_THRESHOLD_PARAMS",
           "LEAUTHAUD11_PARAMS", "ZU_MANDELBAUM15_PARAMS",
           "CACCIATO09_PARAMS", "CENTRALS", "SATELLITES",
           "ASSEMBIAS_PARAMS", "occupation_functions"]
