"""Plain reference of a zheng07 HOD prediction from tabulations.

Written from the published method (Zheng et al. 2007, ApJ 667, 760 for
the occupation; TabCorr, tabcorr/tabcorr.py:543-683 and
tabcorr/interpolator.py for the quadrature, the packed contraction and
the not-a-knot grid spline), in plain PyTorch, in float64.  It imports
nothing of the program and takes nothing the program made: it reads the
raw tables (the packed matrices and the bins' columns, as stored) and
works out everything else again.

* zheng07: <N_cen> = erfc(-(log M - log Mmin) / sigma) / 2 and <N_sat> =
  ((M - M0) / M1)^alpha above M0, 0 below.  In float64 the quadrature
  nodes are exact, so no node residual is carried.
* The quadrature: ``n_gauss`` Gauss-Legendre nodes a bin in log M, with
  weights times M^(1 + dist_index), normalised a bin.
* The contraction: auto mode xi_k = sum over packed pairs (i >= j) of
  M_kp (2 - delta_ij) n_i n_j / (sum n)^2; cross mode xi = M n / sum n.
* A grid: each axis's not-a-knot cubic spline through the nodes' values,
  as weights on the nodes (their outer product over the axes), NaN
  outside the grid; ngal and xi are splined alike.

``precision="tf32"`` is the control: the same arithmetic in float32 with
the contraction's operands rounded to TF32 (10 explicit mantissa bits,
round to nearest) before a float32 product, as TF32 tensor cores take
them.
"""

from __future__ import annotations

import numpy as np
import torch

CENTRALS = b"centrals"


def round_tf32(x):
    """``x`` (float32) rounded to TF32's 10 explicit mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def gauss_quadrature(log_min, log_max, dist_index, n_gauss):
    """(n_bins, n_gauss) float64 nodes in log10 M and normalised weights."""
    x, w = np.polynomial.legendre.leggauss(n_gauss)
    x = 0.5 * (x + 1.0)
    log_min = np.asarray(log_min, dtype=np.float64)[:, None]
    width = np.asarray(log_max, dtype=np.float64)[:, None] - log_min
    nodes = log_min + width * x
    measure = w * 10.0 ** ((np.asarray(dist_index)[:, None] + 1.0) *
                           (nodes - log_min))
    return nodes, measure / measure.sum(axis=1, keepdims=True)


def zheng07_centrals(p, log_m):
    return 0.5 * torch.special.erfc(-(log_m - p["logMmin"]) /
                                    p["sigma_logM"])


def zheng07_satellites(p, log_m):
    # log10(M - M0) = log M + log10(1 - M0 / M), finite above M0.
    above = log_m > p["logM0"]
    ratio = torch.where(above, 10.0 ** (p["logM0"] - log_m),
                        torch.zeros_like(log_m))
    log_excess = log_m + torch.log1p(-ratio) / np.log(10.0)
    nsat = 10.0 ** (p["alpha"] * (log_excess - p["logM1"]))
    return torch.where(above, nsat, torch.zeros_like(nsat))


def not_a_knot_basis(xp):
    """(n_intervals, 4, n) float64: on interval k the spline through the
    values y is sum_p sum_j c[k, p, j] y_j (x - xp[k])^p.

    Solves for the second derivatives of the interpolating cubic spline
    with the not-a-knot ends (third derivative continuous at the second
    and the second-last node) for every unit vector y at once."""
    xp = np.asarray(xp, dtype=np.float64)
    n = len(xp)
    if n < 4:
        raise ValueError("a not-a-knot spline needs 4 nodes or more")
    h = np.diff(xp)
    a = np.zeros((n, n))
    rhs = np.zeros((n, n))
    eye = np.eye(n)
    slope = (eye[1:] - eye[:-1]) / h[:, None]        # (n-1, n) per y
    for i in range(1, n - 1):
        a[i, i - 1:i + 2] = h[i - 1], 2 * (h[i - 1] + h[i]), h[i]
        rhs[i] = 6.0 * (slope[i] - slope[i - 1])
    # (M1 - M0) / h0 = (M2 - M1) / h1, and the same at the other end.
    a[0, :3] = -1.0 / h[0], 1.0 / h[0] + 1.0 / h[1], -1.0 / h[1]
    a[-1, -3] = -1.0 / h[-2]
    a[-1, -2] = 1.0 / h[-2] + 1.0 / h[-1]
    a[-1, -1] = -1.0 / h[-1]
    m = np.linalg.solve(a, rhs)                     # (n, n): M_i per y_j
    c = np.zeros((n - 1, 4, n))
    for k in range(n - 1):
        c[k, 0] = eye[k]
        c[k, 1] = slope[k] - h[k] * (2 * m[k] + m[k + 1]) / 6.0
        c[k, 2] = m[k] / 2.0
        c[k, 3] = (m[k + 1] - m[k]) / (6.0 * h[k])
    return c


class Reference:
    """zheng07 predictions of every table of a configuration.

    ``tables`` are raw tables (:class:`RawTable`-like objects with
    ``matrix`` (n_nodes, n_xi, n_stored), ``columns`` (the bins' columns),
    ``mode``, ``tpcf_shape`` and ``grid``: None, or ``(keys, values)``
    with ``values`` (n_nodes, len(keys)), each node's grid point).
    """

    def __init__(self, tables, config, device, precision="float64",
                 block_bytes=2 ** 29):
        # Plain float32 products, never TF32 (the control rounds itself).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.n_gauss = int(config["n_gauss"])
        self.block_bytes = block_bytes
        self.tables = [self._prepare(t) for t in tables]

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype or self.dtype,
                               device=self.device)

    def _prepare(self, t):
        cols = t.columns
        n_bins = len(cols["n_h"])
        nodes, weights = gauss_quadrature(
            cols["log_prim_haloprop_min"], cols["log_prim_haloprop_max"],
            cols["prim_haloprop_dist_index"], self.n_gauss)
        is_cen = np.asarray(cols["gal_type"]) == CENTRALS
        matrix = np.asarray(t.matrix, dtype=np.float64)
        prep = dict(mode=t.mode, n_bins=n_bins, n_xi=matrix.shape[1],
                    n_nodes=matrix.shape[0], tpcf_shape=tuple(t.tpcf_shape),
                    log_m=self._tensor(nodes), weight=self._tensor(weights),
                    is_cen=torch.as_tensor(is_cen,
                                           device=self.device)[:, None],
                    n_h=self._tensor(cols["n_h"]))
        if t.mode == "auto":
            i, j = np.tril_indices(n_bins)
            prep["pair_i"] = torch.as_tensor(i, device=self.device)
            prep["pair_j"] = torch.as_tensor(j, device=self.device)
            prep["pair_factor"] = self._tensor(np.where(i == j, 1.0, 2.0))
        # (n_stored, n_nodes * n_xi): one product gives every node's rows.
        m = self._tensor(matrix.reshape(-1, matrix.shape[-1]).T)
        prep["matrix"] = round_tf32(m) if self.precision == "tf32" else m
        prep["grid"] = None
        if t.grid is not None:
            keys, values = t.grid
            values = np.asarray(values, dtype=np.float64)
            axes = []
            for a, key in enumerate(keys):
                xp = np.unique(values[:, a])
                axes.append(dict(
                    key=key, xp=self._tensor(xp),
                    basis=self._tensor(not_a_knot_basis(xp)),
                    index=torch.as_tensor(np.searchsorted(xp, values[:, a]),
                                          device=self.device)))
            prep["grid"] = axes
        return prep

    def _occupation(self, t, p):
        log_m = t["log_m"][None]                                 # 1, bins, g
        q = {k: v[:, None, None] for k, v in p.items()}
        occ = torch.where(t["is_cen"][None], zheng07_centrals(q, log_m),
                          zheng07_satellites(q, log_m))
        return torch.sum(occ * t["weight"][None], dim=-1)        # B, bins

    def _node_weights(self, t, p):
        w = None
        for axis in t["grid"]:
            x = p[axis["key"]].contiguous()
            xp = axis["xp"]
            k = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0,
                            xp.shape[0] - 2)
            dx = (x - xp[k])[:, None]
            powers = torch.cat([torch.ones_like(dx), dx, dx * dx,
                                dx * dx * dx], dim=1)            # B, 4
            wa = torch.einsum("bpj,bp->bj", axis["basis"][k], powers)
            inside = (x >= xp[0]) & (x <= xp[-1])
            wa = torch.where(inside[:, None], wa, torch.nan)
            wn = wa[:, axis["index"]]                            # B, nodes
            w = wn if w is None else w * wn
        return w

    def _contract(self, t, n):
        total = n.sum(dim=1)
        if t["mode"] == "auto":
            lhs = (n[:, t["pair_i"]] * n[:, t["pair_j"]] * t["pair_factor"])
            denom = total * total
        else:
            lhs = n
            denom = total
        if self.precision == "tf32":
            lhs = round_tf32(lhs)
        xi = (lhs @ t["matrix"]) / denom[:, None]                # B, nodes*xi
        return total, xi.reshape(n.shape[0], t["n_nodes"], t["n_xi"])

    def _rows_per_block(self, t):
        width = (t["n_bins"] * (t["n_bins"] + 1) // 2 +
                 t["n_nodes"] * t["n_xi"] + t["n_bins"] * self.n_gauss)
        return max(256, self.block_bytes // (8 * width))

    def predict(self, params):
        """``[(ngal (B,), xi (B, n_xi)), ...]`` a table, in this
        reference's precision, for a dict of (B,) parameter tensors."""
        p = {k: v.to(self.device, self.dtype) for k, v in params.items()}
        batch = next(iter(p.values())).shape[0]
        out = []
        for t in self.tables:
            rows = self._rows_per_block(t)
            ngal, xi = [], []
            for lo in range(0, batch, rows):
                pb = {k: v[lo:lo + rows] for k, v in p.items()}
                n = self._occupation(t, pb) * t["n_h"]
                total, x = self._contract(t, n)
                if t["grid"] is None:
                    ngal.append(total)
                    xi.append(x[:, 0])
                    continue
                w = self._node_weights(t, pb)
                ngal.append(total * w.sum(dim=1))
                xi.append(torch.einsum("bk,bkx->bx", w, x))
            out.append((torch.cat(ngal), torch.cat(xi)))
        return out

    def shapes(self):
        """What the roofline counts: ``[(n_bins, n_gauss, n_xi, auto,
        n_nodes), ...]`` a table."""
        return [(t["n_bins"], self.n_gauss, t["n_xi"], t["mode"] == "auto",
                 t["n_nodes"]) for t in self.tables]
