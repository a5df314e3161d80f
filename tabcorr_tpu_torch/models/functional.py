"""User-defined occupation models from plain functions.

Port of ``tabcorr_tpu/models/functional.py``.  :class:`FunctionalHodModel`
builds a model from two pure functions, the entry point for custom
occupation statistics; any object with halotools-style
``mean_occupation_centrals`` / ``mean_occupation_satellites`` numpy
methods already works with the float64 host path (``TabCorr.predict``).
"""

from __future__ import annotations

from .protocol import CENTRALS, HodModel


class FunctionalHodModel(HodModel):
    """HOD model defined by two pure occupation functions.

    Parameters
    ----------
    occupation_cen, occupation_sat : callables
        Pure functions ``(params, log_prim_haloprop,
        sec_haloprop_percentile) -> mean occupation``, written for both
        namespaces: torch tensors on the batched paths (parameters (B, 1,
        1) against (n_bins, n_gauss) nodes), numpy on the host path
        (``utils.backend`` dispatches the usual functions).
    param_defaults : dict
        Parameter names and default values.
    **kwargs
        ``prim_haloprop_key``, ``sec_haloprop_key``, ``redshift`` and
        parameter overrides (see :class:`~.protocol.HodModel`).

    The fused engines take it (its densities are computed in tensor ops
    ahead of the kernels), and its float32 node residual is absorbed by
    the protocol's forward-mode derivative.

    Examples
    --------
    >>> def step_cen(params, log_m, sec):
    ...     return 1.0 * (log_m > params["logMmin"])
    >>> def power_sat(params, log_m, sec):
    ...     return 10.0 ** (params["alpha"] * (log_m - params["logM1"]))
    >>> model = FunctionalHodModel(step_cen, power_sat,
    ...                            {"logMmin": 12.0, "logM1": 13.5,
    ...                             "alpha": 1.0})
    """

    def __init__(self, occupation_cen, occupation_sat, param_defaults,
                 **kwargs):
        self._occupation_cen = occupation_cen
        self._occupation_sat = occupation_sat
        self.param_defaults = dict(param_defaults)
        super().__init__(**kwargs)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return self._occupation_cen(params, log_prim_haloprop,
                                        sec_haloprop_percentile)
        return self._occupation_sat(params, log_prim_haloprop,
                                    sec_haloprop_percentile)
