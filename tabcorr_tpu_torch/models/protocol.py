"""HOD model protocol.

The reference consumes halotools models through two hooks,
``model.mean_occupation_centrals(prim_haloprop=..., sec_haloprop_percentile=...)``
and ``model.mean_occupation_satellites(...)``, plus a few metadata
attributes used in consistency checks (reference: tabcorr/tabcorr.py:496-563).

Here every model exposes a pure occupation function

    occupation(params, gal_type, log_prim_haloprop, sec_haloprop_percentile)

where ``params`` maps names to scalars (numpy host path) or to tensors that
broadcast against the node arrays (batched torch path).  The mutable
``param_dict`` stays on the model for reference-style use.
"""

from __future__ import annotations

import numpy as np
import torch

CENTRALS = "centrals"
SATELLITES = "satellites"


class HodModel:
    """Base class for HOD occupation models.

    Subclasses implement :meth:`occupation` with the array-namespace
    helpers of ``utils.backend`` and declare ``param_defaults``.
    """

    gal_types = (CENTRALS, SATELLITES)
    param_defaults: dict = {}

    def __init__(self, prim_haloprop_key="halo_mvir",
                 sec_haloprop_key=None, redshift=0.0, **params):
        self.prim_haloprop_key = prim_haloprop_key
        self.sec_haloprop_key = sec_haloprop_key
        # Plain Python float: a numpy float64 scalar here (e.g. straight
        # from HDF5 attrs) would promote float32 occupations that use it.
        self.redshift = float(redshift)
        self.param_dict = dict(self.param_defaults)
        unknown = set(params) - set(self.param_dict)
        if unknown:
            raise ValueError(f"Unknown parameters: {sorted(unknown)}")
        self.param_dict.update(params)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        """Mean occupation; a pure function of ``params``."""
        raise NotImplementedError

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        """Occupation at the double-float node ``log_prim + log_prim_res``.

        ``log_prim_res`` is the float64 residual of the float32-rounded
        quadrature node (|res| < ulp(log_prim)/2, so ``log_prim + res``
        would round it away).  The default recovers it to first order with
        a forward-mode derivative; analytic models override it with an
        exact absorption (see models.zheng07).
        """
        occ, d = torch.func.jvp(
            lambda l: self.occupation(params, gal_type, l,
                                      sec_haloprop_percentile),
            (log_prim_haloprop,), (log_prim_res,))
        return occ + d

    def _mean_occupation(self, gal_type, prim_haloprop=None,
                         sec_haloprop_percentile=None, **kwargs):
        prim_haloprop = np.asarray(prim_haloprop, dtype=np.float64)
        if sec_haloprop_percentile is None:
            sec_haloprop_percentile = np.full_like(prim_haloprop, 0.5)
        else:
            sec_haloprop_percentile = np.asarray(
                sec_haloprop_percentile, dtype=np.float64)
        return np.asarray(self.occupation(
            self.param_dict, gal_type, np.log10(prim_haloprop),
            sec_haloprop_percentile))

    def mean_occupation_centrals(self, **kwargs):
        """halotools-signature wrapper (reference: tabcorr/tabcorr.py:556)."""
        return self._mean_occupation(CENTRALS, **kwargs)

    def mean_occupation_satellites(self, **kwargs):
        """halotools-signature wrapper (reference: tabcorr/tabcorr.py:560)."""
        return self._mean_occupation(SATELLITES, **kwargs)


def occupation_functions(model):
    """The pure ``(params, logM, sec_percentile)`` occupation pair.

    Each callable carries a ``with_residual`` attribute bound to the
    model's ``occupation_residual``; the float32 paths pick it up through
    ``ops.predict.occupation_with_residual``.
    """
    def occ_cen(params, log_prim, sec):
        return model.occupation(params, CENTRALS, log_prim, sec)

    def occ_sat(params, log_prim, sec):
        return model.occupation(params, SATELLITES, log_prim, sec)

    occ_cen.with_residual = (
        lambda params, log_prim, res, sec:
        model.occupation_residual(params, CENTRALS, log_prim, res, sec))
    occ_sat.with_residual = (
        lambda params, log_prim, res, sec:
        model.occupation_residual(params, SATELLITES, log_prim, res, sec))
    return occ_cen, occ_sat
