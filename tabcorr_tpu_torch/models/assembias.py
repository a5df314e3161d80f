"""Heaviside assembly-bias ("decorated HOD") occupation decoration.

The tabulation bins halos by secondary-property percentile
(``sec_haloprop_percentile_bins``) and the prediction passes each bin's
percentile midpoint to the occupation (reference: tabcorr/tabcorr.py:
550-563).  The decoration, modeled on halotools' ``HeavisideAssembias``:
halos above the percentile split get their occupation perturbed by
``+delta`` and halos below by ``-delta * (1 - split) / split``, so the
mass-conditioned mean occupation is preserved.  The amplitude is

    delta = A * min(upper_bound - base, split/(1-split) * (base - lower_bound))    (A >= 0)
    delta = A * min(base - lower_bound, split/(1-split) * (upper_bound - base))    (A < 0)

which keeps both populations inside [lower_bound, upper_bound] for
|A| <= 1.  Centrals are bounded by [0, 1], satellites by [0, inf).

Every expression and its order follow ``tabcorr_tpu/models/assembias.py``;
the CUDA kernels (``csrc/zheng07.cuh``, model code 1) evaluate the same
float32 expressions in the same order for zheng07.  The other decorated
families reach the kernels through their densities (model code 2), which
the occupation kernel (``csrc/occupation.cu``) decorates in float64.
"""

from __future__ import annotations

from ..utils.backend import get_namespace
from .cacciato09 import Cacciato09Model
from .leauthaud11 import Leauthaud11Model
from .protocol import CENTRALS
from .tinker13 import QUIESCENT, Tinker13Model, tinker13_quiescent_fraction
from .zheng07 import Zheng07Model
from .zu_mandelbaum15 import ZuMandelbaum15Model

ASSEMBIAS_PARAMS = ("mean_occupation_centrals_assembias_param1",
                    "mean_occupation_satellites_assembias_param1")


def heaviside_assembias(base, strength, sec_haloprop_percentile, split=0.5,
                        lower_bound=0.0, upper_bound=None):
    """Apply the Heaviside assembly-bias perturbation to a baseline occupation.

    Parameters
    ----------
    base : tensor or ndarray
        Baseline mean occupation.
    strength : float, tensor or ndarray
        Assembly-bias strength A, clipped to [-1, 1].
    sec_haloprop_percentile : tensor or ndarray
        Secondary-property percentile of each halo (bin midpoint for
        tabulated bins).
    split : float, optional
        Percentile split between the two populations. Default 0.5.
    lower_bound, upper_bound : float, optional
        Physical bounds on the occupation; ``upper_bound=None`` means
        unbounded above (satellites).

    Returns
    -------
    tensor or ndarray
        Decorated mean occupation.
    """
    xp = get_namespace(base, sec_haloprop_percentile)
    strength = xp.clip(strength, -1.0, 1.0)
    frac_above = 1.0 - split
    ratio = split / frac_above

    head = base - lower_bound
    if upper_bound is None:
        room_up = ratio * head
        room_down = head
    else:
        room_up = xp.minimum(upper_bound - base, ratio * head)
        room_down = xp.minimum(head, ratio * (upper_bound - base))

    delta = xp.where(strength >= 0, strength * room_up, strength * room_down)
    # A percentile midpoint within one float64 ulp of the split (a single
    # bin spanning [-1e-3, 1 + 1e-3] has midpoint 0.5 - 6e-17, which is
    # exactly 0.5 in float32) would flip branches between the float64
    # host path and the float32 paths; the 1e-6 tolerance classifies such
    # bins alike everywhere.
    above = sec_haloprop_percentile >= split - 1e-6
    return xp.where(above, base + delta,
                    base - delta * frac_above / split)


class HeavisideAssembiasMixin:
    """Mix-in decorating a :class:`~.protocol.HodModel` with assembly bias.

    Compose as ``class Decorated(HeavisideAssembiasMixin, BaseModel)``.
    Adds the parameters ``mean_occupation_centrals_assembias_param1`` and
    ``mean_occupation_satellites_assembias_param1`` (halotools' names).
    ``occupation_residual`` is not overridden here: the protocol's
    forward-mode fallback differentiates the decorated occupation, which
    is correct; a base model with an exact residual absorption composes it
    through ``_ExactResidualMixin``.
    """

    def __init__(self, split=0.5, sec_haloprop_key="halo_nfw_conc", **kwargs):
        self.split = split
        super().__init__(sec_haloprop_key=sec_haloprop_key, **kwargs)
        for name in ASSEMBIAS_PARAMS:
            self.param_dict.setdefault(name, 0.0)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        base = super().occupation(params, gal_type, log_prim_haloprop,
                                  sec_haloprop_percentile)
        return self._decorate(params, gal_type, base,
                              sec_haloprop_percentile)

    def _decorate(self, params, gal_type, base, sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return heaviside_assembias(
                base, params[ASSEMBIAS_PARAMS[0]], sec_haloprop_percentile,
                split=self.split, lower_bound=0.0, upper_bound=1.0)
        return heaviside_assembias(
            base, params[ASSEMBIAS_PARAMS[1]], sec_haloprop_percentile,
            split=self.split, lower_bound=0.0, upper_bound=None)


class _ExactResidualMixin:
    """``occupation_residual`` for a decorated model whose base absorbs
    the node residual exactly: the decoration depends on log10(M) only
    through the base occupation, so the absorption composes."""

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        base = super().occupation_residual(params, gal_type,
                                           log_prim_haloprop, log_prim_res,
                                           sec_haloprop_percentile)
        return self._decorate(params, gal_type, base,
                              sec_haloprop_percentile)


class AssembiasZheng07Model(_ExactResidualMixin, HeavisideAssembiasMixin,
                            Zheng07Model):
    """Zheng07 with Heaviside assembly bias on centrals and satellites.

    The CUDA kernels evaluate it as model code 1 with the parameter
    columns ``kernel_param_names``.
    """

    kernel_param_names = Zheng07Model.param_names + ASSEMBIAS_PARAMS


class AssembiasLeauthaud11Model(_ExactResidualMixin, HeavisideAssembiasMixin,
                                Leauthaud11Model):
    """Leauthaud11 with Heaviside assembly bias on both galaxy types."""


class AssembiasZuMandelbaum15Model(_ExactResidualMixin,
                                   HeavisideAssembiasMixin,
                                   ZuMandelbaum15Model):
    """Zu & Mandelbaum (2015) with Heaviside assembly bias (halotools'
    generic decoration; it ships no prebuilt decorated variant)."""


class AssembiasCacciato09Model(HeavisideAssembiasMixin, Cacciato09Model):
    """Cacciato09 CLF with Heaviside assembly bias on both types; the
    residual goes through the protocol's forward-mode derivative."""


class AssembiasTinker13Model(HeavisideAssembiasMixin, Tinker13Model):
    """Tinker13 with Heaviside assembly bias on the instance's
    ``sfr_designation`` occupation as a whole.

    For a single population ('quiescent' / 'active') the centrals are
    bounded by the population's own ceiling, f_q(Mh) resp. 1 - f_q(Mh),
    not 1, so the decorated occupation stays physical for |A| <= 1 and two
    instances sharing a ``param_dict`` sum to at most one central per
    halo.
    """

    def _central_ceiling(self, params, log_prim_haloprop,
                         log_prim_res=None):
        fq = tinker13_quiescent_fraction(
            params, log_prim_haloprop,
            abscissa=self.quiescent_fraction_abscissa,
            log_prim_res=log_prim_res)
        return fq if self.sfr_designation == QUIESCENT else 1.0 - fq

    def _decorate_centrals(self, params, base, sec_haloprop_percentile,
                           log_prim_haloprop, log_prim_res=None):
        strength = params[ASSEMBIAS_PARAMS[0]]
        upper = self._central_ceiling(params, log_prim_haloprop,
                                      log_prim_res=log_prim_res)
        return heaviside_assembias(
            base, strength, sec_haloprop_percentile, split=self.split,
            lower_bound=0.0, upper_bound=upper)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        return self.occupation_residual(params, gal_type, log_prim_haloprop,
                                        None, sec_haloprop_percentile)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        base = Tinker13Model.occupation_residual(
            self, params, gal_type, log_prim_haloprop, log_prim_res,
            sec_haloprop_percentile)
        if gal_type == CENTRALS and self.sfr_designation != "all":
            return self._decorate_centrals(params, base,
                                           sec_haloprop_percentile,
                                           log_prim_haloprop,
                                           log_prim_res=log_prim_res)
        return self._decorate(params, gal_type, base,
                              sec_haloprop_percentile)
