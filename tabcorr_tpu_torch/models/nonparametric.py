"""Non-parametric HOD: per-bin mean occupations as free parameters.

Port of ``tabcorr_tpu/models/nonparametric.py``.  With one occupation
value per tabulated halo bin the predicted statistic is an exact quadratic
(auto mode) or linear (cross mode) form in the parameter vector.

* :class:`NonparametricHodModel`: an :class:`~.protocol.HodModel` whose
  occupation is piecewise constant over fixed (log prim, sec percentile)
  cells, one parameter per cell.  Built on a tabulation's own bins by
  :meth:`NonparametricHodModel.from_table`, quadrature returns the
  parameters exactly, so the plain engines take it unchanged.  It does
  not take the fused engines (``supports_fused_engine`` is False, as in
  the JAX package); its fast path is
  :func:`~tabcorr_tpu_torch.predictor.make_occupation_predictor`.
* :func:`smoothness_log_prior`: the second-difference regularization that
  non-parametric occupation inference needs.
"""

from __future__ import annotations

import numpy as np

from ..utils.backend import asarray, get_namespace
from .protocol import CENTRALS, SATELLITES, HodModel


def _piecewise_constant(values, log_prim, sec, lo, hi, smin, smax, top):
    """sum_i values_i * 1[(log_prim, sec) in cell_i], branchless.

    Cells are half-open [lo, hi) x [smin, smax); rows flagged ``top``
    include their upper prim edge, and the sec upper edge is inclusive at
    1.0.  Points outside every cell get 0.  ``values`` (..., n) carries
    the batch axes in front of the cell axis.
    """
    xp = get_namespace(log_prim, values)
    lp = log_prim[..., None]
    sc = sec[..., None]
    inside = ((lp >= lo) & ((lp < hi) | (top & (lp <= hi))) &
              (sc >= smin) &
              ((sc < smax) | ((smax >= 1.0) & (sc <= smax))))
    return xp.sum(xp.where(inside, values, asarray(0.0, lp)), axis=-1)


class NonparametricHodModel(HodModel):
    """HOD model with one free mean-occupation value per halo cell.

    Parameters
    ----------
    cells_cen, cells_sat : dict of arrays
        Per-type cells with keys ``log_prim_min``, ``log_prim_max``,
        ``sec_min``, ``sec_max`` (each (n_t,) float).
    values_cen, values_sat : array-like, optional
        Initial occupations (default 0).
    **kwargs
        ``prim_haloprop_key``, ``sec_haloprop_key``, ``redshift``.

    Parameters are named ``n_cen_{i}`` / ``n_sat_{i}`` in cell order.  The
    occupation is piecewise constant, so ``occupation_residual`` is the
    occupation itself (a sub-ulp node shift never crosses a cell edge).
    """

    # The parameter count scales with the table; the JAX package keeps
    # the model off its in-kernel engines, and the port does the same.
    supports_fused_engine = False

    def __init__(self, cells_cen, cells_sat, values_cen=None,
                 values_sat=None, **kwargs):
        self._cells = {CENTRALS: {k: np.asarray(v, dtype=np.float64)
                                  for k, v in cells_cen.items()},
                       SATELLITES: {k: np.asarray(v, dtype=np.float64)
                                    for k, v in cells_sat.items()}}
        n_cen = len(self._cells[CENTRALS]["log_prim_min"])
        n_sat = len(self._cells[SATELLITES]["log_prim_min"])
        if n_cen == 0 or n_sat == 0:
            raise ValueError(
                "Each galaxy type needs at least one cell (got "
                f"{n_cen} centrals, {n_sat} satellites).")
        for gal_type, cells in self._cells.items():
            n = len(cells["log_prim_min"])
            if any(len(cells[k]) != n for k in cells):
                raise ValueError(f"Inconsistent {gal_type} cell arrays.")
            # Rows carrying the global upper prim edge are closed above.
            cells["top"] = (cells["log_prim_max"] >=
                            np.max(cells["log_prim_max"]) - 1e-12)
        v_cen = np.zeros(n_cen) if values_cen is None \
            else np.asarray(values_cen, dtype=np.float64)
        v_sat = np.zeros(n_sat) if values_sat is None \
            else np.asarray(values_sat, dtype=np.float64)
        if len(v_cen) != n_cen or len(v_sat) != n_sat:
            raise ValueError("values length must match the cell count.")
        self.param_defaults = {
            **{f"n_cen_{i}": float(v) for i, v in enumerate(v_cen)},
            **{f"n_sat_{i}": float(v) for i, v in enumerate(v_sat)}}
        self._names = {CENTRALS: tuple(f"n_cen_{i}" for i in range(n_cen)),
                       SATELLITES: tuple(f"n_sat_{i}"
                                         for i in range(n_sat))}
        super().__init__(**kwargs)

    @classmethod
    def from_table(cls, tab, values_cen=None, values_sat=None, **kwargs):
        """Build on a tabulation's own halo bins (each quadrature node
        falls inside exactly one cell of its galaxy type)."""
        g = tab.gal_type
        types = np.asarray(g["gal_type"]).astype(str)
        cells = {}
        for name in (CENTRALS, SATELLITES):
            m = types == name
            cells[name] = dict(
                log_prim_min=np.asarray(g["log_prim_haloprop_min"])[m],
                log_prim_max=np.asarray(g["log_prim_haloprop_max"])[m],
                sec_min=np.asarray(g["sec_haloprop_percentile_min"])[m],
                sec_max=np.asarray(g["sec_haloprop_percentile_max"])[m])
        kwargs.setdefault("prim_haloprop_key",
                          tab.attrs.get("prim_haloprop_key", "halo_mvir"))
        kwargs.setdefault("redshift", float(tab.attrs.get("redshift", 0.0)))
        return cls(cells[CENTRALS], cells[SATELLITES],
                   values_cen=values_cen, values_sat=values_sat, **kwargs)

    def occupation_vector(self, gal_type=None):
        """Current occupations as a flat array (centrals then satellites,
        the bin order of :meth:`TabCorr.mean_occupation`)."""
        if gal_type is not None:
            return np.array([self.param_dict[k]
                             for k in self._names[gal_type]])
        return np.concatenate([self.occupation_vector(CENTRALS),
                               self.occupation_vector(SATELLITES)])

    def set_occupation_vector(self, values, gal_type=None):
        """Write a flat occupation array back into ``param_dict``."""
        values = np.asarray(values, dtype=np.float64)
        if gal_type is not None:
            names = self._names[gal_type]
            if len(values) != len(names):
                raise ValueError("values length must match the cell count.")
            for k, v in zip(names, values):
                self.param_dict[k] = float(v)
            return
        n_cen = len(self._names[CENTRALS])
        self.set_occupation_vector(values[:n_cen], CENTRALS)
        self.set_occupation_vector(values[n_cen:], SATELLITES)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        xp = get_namespace(log_prim_haloprop,
                           params[self._names[gal_type][0]])
        cells = self._cells[gal_type]
        lp = asarray(log_prim_haloprop, log_prim_haloprop)
        sec = asarray(sec_haloprop_percentile, lp)
        values = xp.stack([asarray(params[k], lp)
                           for k in self._names[gal_type]], axis=-1)

        def cell(key):
            return asarray(cells[key], lp)

        return _piecewise_constant(
            values, lp, sec, cell("log_prim_min"), cell("log_prim_max"),
            cell("sec_min"), cell("sec_max"), cell("top") > 0.5)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        # Piecewise constant: the residual absorption is the identity.
        return self.occupation(params, gal_type, log_prim_haloprop,
                               sec_haloprop_percentile)


def smoothness_log_prior(values, scale=1.0, log=True, floor=1e-12):
    """Gaussian second-difference log-prior over an occupation vector,

        log p = -1/2 * sum_i (y[i-1] - 2 y[i] + y[i+1])^2 / scale^2,

    with y = log10(max(values, floor)) when ``log``, else y = values.
    Differentiable, batch-native over leading axes, and zero for
    (log-)linear runs.  Apply per galaxy type.
    """
    xp = get_namespace(values)
    y = values
    if log:
        y = xp.log10(xp.where(values > floor, values,
                              asarray(floor, values)))
    d2 = y[..., :-2] - 2.0 * y[..., 1:-1] + y[..., 2:]
    return -0.5 * xp.sum((d2 / scale) ** 2, axis=-1)
