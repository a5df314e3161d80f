"""Labeled pair counting: the tabulation's device work.

Port of ``tabcorr_tpu/ops/paircount.py``.  The reference farms one
pair-count task per halo-bin pair to a process pool (tabcorr/tabcorr.py:
846-922); tabcorr_tpu and this port run ONE sweep over all tracers, each
carrying an integer (mass bin x percentile bin x galaxy type) label, into a
dense ``counts[label_1, label_2, r_bin]`` histogram per projection.

:func:`labeled_pair_count` is the host-facing function, with tabcorr_tpu's
conventions (``paircount.py:462-701``): ordered pairs, self-pairs excluded
by index in auto mode, periodic minimum-image separations, labels below 0
ignored, weights scaled to a largest magnitude of 1 on the device and
rescaled in float64 on the host, and kinds ``rppi`` / ``smu`` / ``proj``
with channels ``unit`` / ``log_rp`` / ``unit+log_rp``.  It hands a
:class:`Sweep` to :func:`paircount`, which runs

* :func:`paircount_launch`, the CUDA kernel (``csrc/paircount.cu``), for
  tensors on the card: the tracers bucketed by label and z on the card
  (:func:`bucket_layout`), one block per (tile of one label_1, label_2
  bucket) over the tile's z-window; or
* :func:`paircount_plain`, its plain version in tensor ops, for tensors on
  the CPU: tabcorr_tpu's sweep -- tracers sorted in z, chunks of 1024,
  each i-chunk against the circular run of j-chunks within the
  line-of-sight cut (:func:`chunk_windows`, used only where ``2 * z_cut <
  period_z``) -- with the histogram scattered in int64 (unit counts) or
  float64.

Geometry is float32 and the same in both, bit for bit, as tabcorr_tpu's
``_tile_geometry`` (:99-127): unit counts are exact integers given float32
separations, and only a pair within one float32 ulp of a bin edge can
classify differently from a float64 counter (tabcorr_tpu measured ~1
unordered pair per 10^6.5).  Accumulation is exact: int64 counts, float64
sums of float32 pair weights (no TwoSum: the 1e-8 relative contract of
tabcorr_tpu's ``paircount.py:24-40`` is met by float64 sums).

The halotools-signature statistics (``wp``, ``s_mu_tpcf``, ``tpcf``,
``mean_delta_sigma``; reference: tabcorr/corrfunc.py) close the counts
against the analytic random expectation.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..utils.build import load_library
from ..utils.device import resolve_device

CHUNK = 1024
# i-tracers a block of the kernel (csrc/paircount.cu kTile).
TILE = 256
KINDS = ("rppi", "smu", "proj")
PAIR_WEIGHTS = ("unit", "log_rp", "unit+log_rp")
# Histogram cells a block of the kernel keeps in shared memory, and edges.
MAX_BLOCK_CELLS = 4096
MAX_EDGES = 512

# Launches of the CUDA pair counter in this process (paircount_launch).
PAIRCOUNT_LAUNCHES = 0
KERNEL_SOURCES = {"paircount": ("paircount.cu",)}

# j-tracers one step of the plain version pairs with an i-chunk.
_J_BLOCK = {"cpu": 2048, "cuda": 16384}


@dataclasses.dataclass(frozen=True)
class Sweep:
    """One labeled sweep's inputs, as tensors on one device.

    ``pos1`` (N1, 3) float32 and ``labels1`` (N1,) int32; ``pos2`` and
    ``labels2`` likewise, or None for auto mode; ``weights2`` (N2,) float32
    (N1 in auto mode) scaled to a largest magnitude of 1, or None for unit
    weights.  ``period``, ``pi_max``: float32 values; ``edges_sq``: the
    squared radial edges rounded once to float32, non-decreasing;
    ``mu_edges``: float32 (smu; else ``[0, 0]``).  ``z_cut``: the
    line-of-sight window (pi_max for rppi, the largest s for smu), or None
    where the sweep has none (proj, or ``2 * z_cut >= period_z``).
    """

    pos1: torch.Tensor
    labels1: torch.Tensor
    n_labels_1: int
    pos2: torch.Tensor | None
    labels2: torch.Tensor | None
    n_labels_2: int
    weights2: torch.Tensor | None
    period: tuple
    kind: str
    edges_sq: np.ndarray
    mu_edges: np.ndarray
    pi_max: float
    pair_weight: str
    z_cut: float | None

    @property
    def auto(self):
        return self.pos2 is None

    @property
    def n_r(self):
        return len(self.edges_sq) - 1

    @property
    def n_mu(self):
        return len(self.mu_edges) - 1 if self.kind == "smu" else 1

    @property
    def n_hist_r(self):
        return self.n_r * self.n_mu

    @property
    def n_channels(self):
        return 2 if self.pair_weight == "unit+log_rp" else 1

    @property
    def n_hist(self):
        """Cells of one channel."""
        return self.n_labels_1 * self.n_labels_2 * self.n_hist_r

    @property
    def unit_counts(self):
        return self.weights2 is None and self.pair_weight == "unit"

    @property
    def device(self):
        return self.pos1.device

    def j_side(self):
        """(pos2, labels2, weights2 or ones) of the j-tracers."""
        pos = self.pos1 if self.auto else self.pos2
        labels = self.labels1 if self.auto else self.labels2
        w = (torch.ones(len(pos), dtype=torch.float32, device=pos.device)
             if self.weights2 is None else self.weights2)
        return pos, labels, w


def check_sweep(sweep: Sweep):
    """Raise on inputs neither version takes: kinds, channels, shapes,
    types, devices, edges, and labels at or above their count."""
    if sweep.kind not in KINDS:
        raise ValueError(f"Unknown kind {sweep.kind!r}; use one of {KINDS}.")
    if sweep.pair_weight not in PAIR_WEIGHTS:
        raise ValueError(f"Unknown pair_weight {sweep.pair_weight!r}.")
    if sweep.n_r < 1 or sweep.n_mu < 1:
        raise ValueError("need at least one radial (and mu) bin.")
    for edges in (sweep.edges_sq, sweep.mu_edges):
        if edges.dtype != np.float32 or np.any(np.diff(edges) < 0):
            raise ValueError("bin edges must be float32 and non-decreasing.")
    device = sweep.device
    sides = [(sweep.pos1, sweep.labels1, sweep.n_labels_1, "1")]
    if not sweep.auto:
        sides.append((sweep.pos2, sweep.labels2, sweep.n_labels_2, "2"))
    for pos, labels, n_labels, name in sides:
        if (pos.dim() != 2 or pos.shape[1] != 3 or
                pos.dtype != torch.float32 or pos.device != device):
            raise ValueError(f"pos{name} must be (N, 3) float32 on {device}.")
        if (labels is None or labels.shape != (pos.shape[0],) or
                labels.dtype != torch.int32 or labels.device != device):
            raise ValueError(f"labels{name} must be (N,) int32 on {device}.")
        if n_labels < 1:
            raise ValueError(f"n_labels_{name} must be at least 1.")
        if len(labels) and int(labels.max()) >= n_labels:
            raise ValueError(f"labels{name} must be below n_labels_{name} "
                             f"({n_labels}).")
    if sweep.auto and sweep.n_labels_2 != sweep.n_labels_1:
        raise ValueError("auto mode: n_labels_2 must equal n_labels_1.")
    w = sweep.weights2
    n2 = len(sweep.pos1 if sweep.auto else sweep.pos2)
    if w is not None and (w.shape != (n2,) or w.dtype != torch.float32 or
                          w.device != device):
        raise ValueError(f"weights2 must be ({n2},) float32 on {device}.")


# ----------------------------------------------------------------------
# The host-facing function
# ----------------------------------------------------------------------
def labeled_pair_count(pos1, labels1, n_labels_1, pos2=None, labels2=None,
                       n_labels_2=None, weights2=None, period=1.0,
                       kind="rppi", r_edges=None, pi_max=None,
                       mu_edges=None, mesh=None, sort=True,
                       pair_weight="unit", *, device="cuda"):
    """Count pairs between labeled tracer sets.

    Parameters
    ----------
    pos1, pos2 : (N, 3) arrays.  ``pos2=None`` means auto-correlation
        (self-pairs excluded, each unordered pair counted twice).  On the
        card, coordinates must lie in [0, period] (the kernel's minimum
        image takes no more than one period apart).
    labels1, labels2 : (N,) int bin labels; negative labels are ignored.
    weights2 : (N2,) optional weights (e.g. particle masses), or a scalar.
    period : float or (3,) periodic box.
    kind : 'rppi' | 'smu' | 'proj'.
    r_edges : radial (rp or s) bin edges.
    pi_max : line-of-sight cut for 'rppi'.
    mu_edges : mu bin edges for 'smu'.
    mesh : the mesh-sharded sweep is not ported (ROADMAP Queue A item 10).
    sort : bool, optional
        Sort along z so each i-chunk (each tile on the card) visits only
        the j-tracers within the line-of-sight cut.  No effect on results.
    pair_weight : 'unit' (default), 'log_rp' (weights2 * ln(rp), the
        annulus-mean delta-sigma estimator's sum) or 'unit+log_rp' (both
        channels from one enumeration; leading axis 2 on the result).
    device : 'cuda' (default: the CUDA kernel) or 'cpu' (the plain
        version).

    Returns
    -------
    counts : (n_labels_1, n_labels_2, n_r[, n_mu]) float64 array, with a
        leading channel axis of size 2 for 'unit+log_rp'.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded sweep is not ported: ROADMAP Queue A item 10.")
    device = resolve_device(device)
    if kind not in KINDS:
        raise ValueError(f"Unknown kind {kind!r}; use one of {KINDS}.")
    if pair_weight not in PAIR_WEIGHTS:
        raise ValueError(f"Unknown pair_weight {pair_weight!r}.")
    period = np.broadcast_to(np.asarray(period, dtype=np.float64), (3,))
    r_edges = np.asarray(r_edges, dtype=np.float64)
    n_r = len(r_edges) - 1
    if kind == "smu":
        mu_edges = np.asarray(mu_edges, dtype=np.float64)
        n_mu = len(mu_edges) - 1
    else:
        mu_edges = np.zeros(2)
        n_mu = 1

    # z-window for the sorted sweep (None: no window).
    z_cut = {"rppi": pi_max, "smu": r_edges[-1], "proj": None}[kind]
    if not (sort and z_cut is not None and 2 * z_cut < period[2]):
        z_cut = None

    auto = pos2 is None
    pos1 = np.asarray(pos1, dtype=np.float32).reshape(-1, 3)
    labels1 = np.asarray(labels1, dtype=np.int32)
    if auto:
        n_labels_2 = n_labels_1
    else:
        pos2 = np.asarray(pos2, dtype=np.float32).reshape(-1, 3)
        labels2 = (np.zeros(len(pos2), dtype=np.int32) if labels2 is None
                   else np.asarray(labels2, dtype=np.int32))
        n_labels_2 = n_labels_2 or int(labels2.max()) + 1
    # Weights are normalized to order unity on the device and rescaled in
    # float64 on the host (tabcorr_tpu's paircount.py:559-574).
    weight_scale = 1.0
    if weights2 is not None:
        weights2 = np.asarray(weights2, dtype=np.float64)
        if weights2.ndim == 0:
            weights2 = np.full(len(pos1) if auto else len(pos2), weights2)
        weight_scale = float(np.max(np.abs(weights2), initial=0.0)) or 1.0
        weights2 = (weights2 / weight_scale).astype(np.float32)

    def tensor(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)

    sweep = Sweep(
        pos1=tensor(pos1), labels1=tensor(labels1),
        n_labels_1=int(n_labels_1), pos2=tensor(pos2),
        labels2=None if auto else tensor(labels2),
        n_labels_2=int(n_labels_2), weights2=tensor(weights2),
        period=tuple(float(np.float32(p)) for p in period), kind=kind,
        edges_sq=(r_edges ** 2).astype(np.float32),
        mu_edges=mu_edges.astype(np.float32),
        pi_max=float(np.float32(pi_max if pi_max is not None else 0.0)),
        pair_weight=pair_weight, z_cut=z_cut)
    hist = paircount(sweep)
    counts = hist.cpu().numpy().astype(np.float64) * weight_scale
    shape = (n_labels_1, n_labels_2, n_r) if kind != "smu" else \
        (n_labels_1, n_labels_2, n_r, n_mu)
    if sweep.n_channels == 2:
        return counts.reshape((2,) + shape)
    return counts.reshape(shape)


def paircount(sweep: Sweep) -> torch.Tensor:
    """The flat histogram (n_channels * n_hist,) of ``sweep``: int64 for
    unit counts, else float64, on the sweep's device.  The CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU."""
    if sweep.device.type == "cuda":
        return paircount_launch(sweep)
    return paircount_plain(sweep)


def _empty_hist(sweep):
    dtype = torch.int64 if sweep.unit_counts else torch.float64
    return torch.zeros(sweep.n_channels * sweep.n_hist, dtype=dtype,
                       device=sweep.device)


# ----------------------------------------------------------------------
# The plain version (tabcorr_tpu's chunked, z-windowed sweep)
# ----------------------------------------------------------------------
def chunk_windows(z1, z2, z_cut, period_z):
    """Circular j-chunk visit window (start_chunk, count) per i-chunk of
    z-sorted tracers (tabcorr_tpu's ``_chunk_windows``, :389, for one
    device; chunks of ``CHUNK``, the last one partial).

    A j-chunk can hold pairs within ``z_cut`` of an i-chunk only if the
    periodic gap between their z intervals is at most ``z_cut``; the
    qualifying chunks are one circular run (else every chunk).
    """
    def bounds(z):
        z = np.asarray(z, dtype=np.float64)
        starts = np.arange(0, len(z), CHUNK)
        return np.minimum.reduceat(z, starts), np.maximum.reduceat(z, starts)

    a1, b1 = bounds(z1)
    a2, b2 = bounds(z2)
    n2c = len(a2)
    margin = 1e-3 + 1e-6 * period_z   # float32 edge safety
    windows = []
    for i in range(len(a1)):
        gap = np.minimum.reduce([
            np.maximum(np.maximum(a2 + k - b1[i], a1[i] - (b2 + k)), 0.0)
            for k in (-period_z, 0.0, period_z)])
        mask = gap <= z_cut + margin
        run_starts = np.flatnonzero(mask & ~np.roll(mask, 1))
        if mask.all() or len(run_starts) != 1:
            windows.append((0, n2c))
        else:
            windows.append((int(run_starts[0]), int(mask.sum())))
    return windows


def _window_ranges(window, n2c, n2):
    """The j index ranges [a, b) of a circular chunk window."""
    start, count = window
    if count >= n2c:
        return [(0, n2)]
    end = start + count
    if end <= n2c:
        return [(start * CHUNK, min(end * CHUNK, n2))]
    return [(start * CHUNK, n2), (0, min((end - n2c) * CHUNK, n2))]


def _bin_right(edges, values):
    """searchsorted(edges, values, 'right') - 1: the count of edges at or
    below each value, minus one (edges non-decreasing)."""
    return torch.searchsorted(edges, values, right=True) - 1


def sqrt32(x):
    """The correctly rounded float32 square root (tabcorr_tpu's, the
    kernel's ``__fsqrt_rn``): the float64 root rounded once to float32.
    torch's float32 sqrt on the CPU is not correctly rounded (its AVX-512
    kernel puts ~0.7% of values one ulp off, and a process's first call
    can differ from its later ones)."""
    return torch.sqrt(x.double()).float()


def pair_geometry(p1, i1, p2, i2, sweep: Sweep, consts):
    """tabcorr_tpu's ``_tile_geometry`` for labels already known to be
    valid: (sub_bin, valid, rp_sq), each (C1, C2), float32 throughout.
    ``i1`` / ``i2`` are tracer indices (self-pairs excluded in auto mode);
    ``consts`` holds the sweep's period, edges and cut as tensors."""
    period, edges_sq, mu_edges, pi_max = consts
    d = p1[:, None, :] - p2[None, :, :]
    d = d - period * torch.round(d / period)
    rp_sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    dz = torch.abs(d[..., 2])
    valid = torch.ones(rp_sq.shape, dtype=torch.bool, device=p1.device)
    if sweep.auto:
        valid &= i1[:, None] != i2[None, :]
    if sweep.kind == "smu":
        s_sq = rp_sq + dz * dz
        s_bin = _bin_right(edges_sq, s_sq)
        s = sqrt32(s_sq)
        mu = torch.where(s > 0, dz / torch.clamp(s, min=1e-30),
                         torch.zeros((), dtype=s.dtype, device=s.device))
        mu_bin = torch.clamp(_bin_right(mu_edges, mu), 0, sweep.n_mu - 1)
        valid &= (s_bin >= 0) & (s_bin < sweep.n_r) & (s > 0)
        return s_bin * sweep.n_mu + mu_bin, valid, rp_sq
    r_bin = _bin_right(edges_sq, rp_sq)
    valid &= (r_bin >= 0) & (r_bin < sweep.n_r)
    if sweep.kind == "rppi":
        valid &= dz < pi_max
    return r_bin, valid, rp_sq


def sweep_constants(sweep: Sweep):
    """The sweep's period, edges and cut as float32 tensors."""
    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32),
                            device=sweep.device)
    return (t(sweep.period), t(sweep.edges_sq), t(sweep.mu_edges),
            t(sweep.pi_max))


def pair_channels(w2, rp_sq, sweep: Sweep):
    """The float32 pair weights of each channel for the kept pairs: the
    j weight, and (w * 0.5) * ln(max(rp^2, 1e-20))."""
    if sweep.pair_weight == "unit":
        return (w2,)
    w_log = (w2 * 0.5) * torch.log(torch.clamp(rp_sq, min=1e-20))
    return (w_log,) if sweep.pair_weight == "log_rp" else (w2, w_log)


def accumulate(hist, sub, valid, rp_sq, l1, l2, w2, sweep: Sweep):
    """Add the kept pairs of one (C1, C2) block to the flat histogram."""
    flat = ((l1.long()[:, None] * sweep.n_labels_2 + l2.long()[None, :]) *
            sweep.n_hist_r + sub)[valid]
    if sweep.unit_counts:
        hist += torch.bincount(flat, minlength=sweep.n_hist)
        return
    w = w2[None, :].expand(valid.shape)[valid]
    for ch, vals in enumerate(pair_channels(w, rp_sq[valid], sweep)):
        hist[ch * sweep.n_hist:(ch + 1) * sweep.n_hist].index_add_(
            0, flat, vals.double())


def paircount_plain(sweep: Sweep) -> torch.Tensor:
    """The kernel's plain version, in tensor ops on the sweep's device:
    tabcorr_tpu's sweep (z-sorted chunks of ``CHUNK`` and their circular
    windows where the sweep has one), the geometry of
    :func:`pair_geometry`, and an int64 or float64 scatter."""
    check_sweep(sweep)
    hist = _empty_hist(sweep)
    pos2, lab2, w2 = sweep.j_side()
    keep1, keep2 = sweep.labels1 >= 0, lab2 >= 0
    pos1, lab1 = sweep.pos1[keep1], sweep.labels1[keep1]
    idx1 = torch.nonzero(keep1).flatten()
    pos2, lab2, w2 = pos2[keep2], lab2[keep2], w2[keep2]
    idx2 = torch.nonzero(keep2).flatten()
    if not sweep.auto:
        idx2 = torch.full_like(idx2, -1)
    n1, n2 = len(pos1), len(pos2)
    if n1 == 0 or n2 == 0:
        return hist
    if sweep.z_cut is not None:
        o1 = torch.argsort(pos1[:, 2], stable=True)
        o2 = torch.argsort(pos2[:, 2], stable=True)
        pos1, lab1, idx1 = pos1[o1], lab1[o1], idx1[o1]
        pos2, lab2, idx2, w2 = pos2[o2], lab2[o2], idx2[o2], w2[o2]
        windows = chunk_windows(pos1[:, 2].cpu().numpy(),
                                pos2[:, 2].cpu().numpy(), sweep.z_cut,
                                sweep.period[2])
    n2c = -(-n2 // CHUNK)
    consts = sweep_constants(sweep)
    j_block = _J_BLOCK[sweep.device.type]
    for c, a in enumerate(range(0, n1, CHUNK)):
        sl = slice(a, min(a + CHUNK, n1))
        window = windows[c] if sweep.z_cut is not None else (0, n2c)
        for ja, jb in _window_ranges(window, n2c, n2):
            for j0 in range(ja, jb, j_block):
                js = slice(j0, min(j0 + j_block, jb))
                sub, valid, rp_sq = pair_geometry(pos1[sl], idx1[sl],
                                                  pos2[js], idx2[js], sweep,
                                                  consts)
                accumulate(hist, sub, valid, rp_sq, lab1[sl], lab2[js],
                           w2[js], sweep)
    return hist


# ----------------------------------------------------------------------
# The CUDA kernel: layout, wrapper
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PairLayout:
    """The kernel's inputs, built on the card by :func:`bucket_layout`.

    ``pos1`` / ``pos2``: (N, 4) float32 (x, y, z, weight), labels below 0
    dropped, sorted by (label, z) (in auto mode one tensor); ``offsets1``
    / ``offsets2``: (n_labels + 1,) int64 bucket starts; ``tile_label``,
    ``tile_start``, ``tile_count``: (n_tiles,) int32, tiles of at most
    ``TILE`` i-tracers of one label; ``runs``: (n_tiles, n_labels_2, 4)
    int32, the j-runs [a0, b0) and [a1, b1) each block scans;
    ``candidates``: the pairs the kernel will evaluate."""

    pos1: torch.Tensor
    offsets1: torch.Tensor
    pos2: torch.Tensor
    offsets2: torch.Tensor
    tile_label: torch.Tensor
    tile_start: torch.Tensor
    tile_count: torch.Tensor
    runs: torch.Tensor
    candidates: int

    @property
    def n_tiles(self):
        return len(self.tile_label)


def wrap_thresholds(period):
    """Per axis, the least float32 |d| for which tabcorr_tpu's minimum
    image ``d - period * round(d / period)`` moves ``d`` by a period, for
    |d| <= period: the correctly rounded |d| / period exceeds 0.5 exactly
    when |d| > period * (0.5 + 2^-25) (0.5 rounds half to even, to 0)."""
    out = []
    for p in period:
        exact = float(np.float32(p)) * (0.5 + 2.0 ** -25)   # exact in f64
        t = np.float32(exact)
        if float(t) <= exact:
            t = np.nextafter(t, np.float32(np.inf))
        out.append(float(t))
    return tuple(out)


def _bucket(pos, labels, weights, n_labels):
    keep = labels >= 0
    pos, labels = pos[keep], labels[keep]
    w = (torch.ones(len(pos), dtype=torch.float32, device=pos.device)
         if weights is None else weights[keep])
    order = torch.argsort(pos[:, 2], stable=True)
    order = order[torch.argsort(labels[order], stable=True)]
    packed = torch.cat([pos[order], w[order, None]], dim=1).contiguous()
    counts = torch.bincount(labels.long(), minlength=n_labels)
    offsets = torch.zeros(n_labels + 1, dtype=torch.int64,
                          device=pos.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return packed, labels[order], offsets


def bucket_layout(sweep: Sweep) -> PairLayout:
    """Bucket the tracers by label, sorted in z inside each bucket, cut the
    i-buckets into tiles and find each (tile, j-bucket) block's j-runs:
    the j-tracers of the bucket within ``z_cut`` (plus tabcorr_tpu's
    float32 margin) of the tile's z range across the periodic boundary,
    at most two runs of the bucket, or the whole bucket where the sweep
    has no window or the window spans the period.  Tensor ops on the
    sweep's device."""
    dev = sweep.device
    n_l1, n_l2 = sweep.n_labels_1, sweep.n_labels_2
    pos2, labels2, w2 = sweep.j_side()
    pos1, lab1s, off1 = _bucket(sweep.pos1, sweep.labels1,
                                sweep.weights2 if sweep.auto else None,
                                n_l1)
    if sweep.auto:
        pos2, lab2s, off2 = pos1, lab1s, off1
    else:
        pos2, lab2s, off2 = _bucket(pos2, labels2, sweep.weights2, n_l2)
    counts1 = off1[1:] - off1[:-1]
    tiles_per = (counts1 + TILE - 1) // TILE
    tile_label = torch.repeat_interleave(
        torch.arange(n_l1, device=dev), tiles_per)
    first_tile = torch.cumsum(tiles_per, 0) - tiles_per
    k = torch.arange(len(tile_label), device=dev) - first_tile[tile_label]
    tile_start = off1[tile_label] + TILE * k
    tile_count = torch.minimum(off1[tile_label + 1] - tile_start,
                               torch.full_like(tile_start, TILE))
    n_tiles = len(tile_label)

    lo2, hi2 = off2[:-1], off2[1:]
    runs = torch.zeros((n_tiles, n_l2, 4), dtype=torch.int64, device=dev)
    runs[:, :, 0] = lo2
    runs[:, :, 1] = hi2
    if sweep.z_cut is not None and n_tiles:
        pz = float(sweep.period[2])
        zc = sweep.z_cut + 1e-3 + 1e-6 * pz
        # The tile's z range (sorted in z within its label), widened.
        lo = pos1[tile_start, 2].double() - zc
        hi = pos1[tile_start + tile_count - 1, 2].double() + zc
        full = (hi - lo) >= pz
        wrap_lo = lo <= 0
        wrap_hi = ~wrap_lo & (hi >= pz)
        wraps = wrap_lo | wrap_hi
        # Two closed z intervals [u0, v0] and [u1, v1] per tile; [u1, v1]
        # is empty (v1 < u1) where the window does not wrap.
        u0 = torch.where(wrap_lo, lo + pz, lo)
        v0 = torch.where(wraps, torch.full_like(lo, pz + 1), hi)
        u1 = torch.where(wraps, torch.full_like(lo, -1.0),
                         torch.full_like(lo, 1.0))
        v1 = torch.where(wrap_lo, hi, torch.where(wrap_hi, hi - pz,
                                                  torch.zeros_like(lo)))
        # One sorted key over all buckets: label * span + z.
        span = 4.0 * pz + 4.0
        key = lab2s.double() * span + pos2[:, 2].double()
        base = torch.arange(n_l2, device=dev, dtype=torch.float64) * span

        def search(bound, right):
            q = base[None, :] + bound[:, None]
            return torch.searchsorted(key, q.contiguous(), right=right)

        a0, b0 = search(u0, False), search(v0, True)
        a1, b1 = search(u1, False), search(v1, True)
        b1 = torch.where((v1 >= u1)[:, None], torch.minimum(b1, a0), a1)
        windowed = (~full)[:, None]
        runs[:, :, 0] = torch.where(windowed, a0, lo2[None, :])
        runs[:, :, 1] = torch.where(windowed, b0, hi2[None, :])
        runs[:, :, 2] = torch.where(windowed, a1, 0)
        runs[:, :, 3] = torch.where(windowed, b1, 0)
    lengths = runs[:, :, 1] - runs[:, :, 0] + runs[:, :, 3] - runs[:, :, 2]
    candidates = int((tile_count[:, None] * lengths).sum()) if n_tiles \
        else 0
    i32 = torch.int32
    return PairLayout(pos1=pos1, offsets1=off1, pos2=pos2, offsets2=off2,
                      tile_label=tile_label.to(i32),
                      tile_start=tile_start.to(i32),
                      tile_count=tile_count.to(i32),
                      runs=runs.to(i32).contiguous(), candidates=candidates)


@functools.cache
def _paircount_lib():
    """Build (first call only) and bind csrc/paircount.cu."""
    lib = load_library("paircount", KERNEL_SOURCES["paircount"])
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tabcorr_paircount.argtypes = (
        [vp] * 4 + [i] + [vp] * 2 + [i] * 5 + [vp, i, vp, i] + [f] * 7 +
        [vp, i, vp])
    lib.tabcorr_paircount.restype = i
    lib.tabcorr_cuda_error_string.argtypes = [i]
    lib.tabcorr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels():
    """Build the pair counter's library now (else at its first launch)."""
    _paircount_lib()


def check_kernel_sweep(sweep: Sweep):
    """Raise on what the kernel does not take, beyond :func:`check_sweep`:
    tensors not on a CUDA device or not contiguous, coordinates outside
    [0, period], more than 65,535 j-labels, a block histogram or edge list
    over its shared memory, and buckets so full that a block's 32-bit
    counts could wrap."""
    check_sweep(sweep)
    if sweep.device.type != "cuda":
        raise ValueError("paircount_launch needs CUDA tensors.")
    pos2, labels2, _ = sweep.j_side()
    for t in (sweep.pos1, sweep.labels1, pos2, labels2, sweep.weights2):
        if t is not None and not t.is_contiguous():
            raise ValueError("the pair counter takes contiguous tensors.")
    period = torch.tensor(sweep.period, dtype=torch.float32,
                          device=sweep.device)
    for pos in (sweep.pos1, pos2):
        if len(pos) and not bool(((pos >= 0) & (pos <= period)).all()):
            raise ValueError("the pair counter takes coordinates in [0, "
                             "period] (wrap them into the box).")
    if sweep.n_labels_2 > 65535:
        raise ValueError("the pair counter takes at most 65,535 j-labels.")
    if (sweep.n_channels * sweep.n_hist_r > MAX_BLOCK_CELLS or
            sweep.n_r + 1 + len(sweep.mu_edges) > MAX_EDGES):
        raise ValueError(f"at most {MAX_BLOCK_CELLS} histogram cells and "
                         f"{MAX_EDGES} edges a label pair.")
    if sweep.unit_counts and len(labels2):
        largest = int(torch.bincount(labels2[labels2 >= 0].long()).max()) \
            if bool((labels2 >= 0).any()) else 0
        if largest * TILE >= 2 ** 32:
            raise ValueError("a j-label holds too many tracers for the "
                             "kernel's 32-bit block counts.")


def paircount_launch(sweep: Sweep,
                     layout: PairLayout | None = None) -> torch.Tensor:
    """Launch the CUDA pair counter once on ``sweep`` (tensors on the
    card), over ``layout`` (built here by :func:`bucket_layout` unless
    given).  Returns the flat histogram as :func:`paircount` does.
    Raises on any input the kernel does not take and on any launch
    error."""
    global PAIRCOUNT_LAUNCHES
    check_kernel_sweep(sweep)
    if layout is None:
        layout = bucket_layout(sweep)
    hist = _empty_hist(sweep)
    if layout.n_tiles == 0:
        return hist
    lib = _paircount_lib()
    edges = torch.tensor(sweep.edges_sq, device=sweep.device)
    mu = torch.tensor(sweep.mu_edges, device=sweep.device)
    pw = (0 if sweep.unit_counts else
          {"unit": 1, "log_rp": 2, "unit+log_rp": 3}[sweep.pair_weight])
    code = lib.tabcorr_paircount(
        layout.pos1.data_ptr(), layout.tile_label.data_ptr(),
        layout.tile_start.data_ptr(), layout.tile_count.data_ptr(),
        layout.n_tiles, layout.pos2.data_ptr(), layout.runs.data_ptr(),
        sweep.n_labels_1, sweep.n_labels_2, int(sweep.auto),
        KINDS.index(sweep.kind), pw, edges.data_ptr(), sweep.n_r,
        mu.data_ptr(), sweep.n_mu, *sweep.period,
        *wrap_thresholds(sweep.period), sweep.pi_max, hist.data_ptr(),
        sweep.device.index,
        torch.cuda.current_stream(sweep.device).cuda_stream)
    if code != 0:
        raise RuntimeError(
            f"paircount kernel launch failed: CUDA error {code} "
            f"({lib.tabcorr_cuda_error_string(code).decode()})")
    PAIRCOUNT_LAUNCHES += 1
    return hist


# ----------------------------------------------------------------------
# halotools-signature statistics (reference: tabcorr/corrfunc.py:6-175)
# ----------------------------------------------------------------------
def _check_auto_cross(do_auto, do_cross):
    if do_auto == do_cross:
        raise ValueError("'do_auto' and 'do_cross' cannot both be True or "
                         "False.")


def _single_label(sample):
    return np.zeros(len(sample), dtype=np.int32)


def wp(sample1, rp_bins, pi_max, sample2=None, period=None, do_auto=True,
       do_cross=False, *, device="cuda"):
    """Projected correlation function wp(rp), natural estimator: ordered
    pairs with |dz| < pi_max against the analytic random expectation, wp =
    (DD / RR - 1) * 2 * pi_max (reference: tabcorr/corrfunc.py:6-87)."""
    _check_auto_cross(do_auto, do_cross)
    period = np.broadcast_to(np.asarray(period, dtype=np.float64), (3,))
    rp_bins = np.asarray(rp_bins, dtype=np.float64)
    counts = labeled_pair_count(
        sample1, _single_label(sample1), 1,
        pos2=None if do_auto else sample2, period=period, kind="rppi",
        r_edges=rp_bins, pi_max=pi_max, device=device)
    n_pairs = len(sample1) * len(sample1 if do_auto else sample2)
    n_exp = (n_pairs / np.prod(period) * np.pi * np.diff(rp_bins**2) *
             2 * pi_max)
    return (counts[0, 0] / n_exp - 1) * 2 * pi_max


def s_mu_tpcf(sample1, s_bins, mu_bins, sample2=None, period=None,
              do_auto=True, do_cross=False, *, device="cuda"):
    """Redshift-space xi(s, mu), mu = |dz| / s on [0, 1], in uniform mu
    bins (reference: tabcorr/corrfunc.py:90-175)."""
    _check_auto_cross(do_auto, do_cross)
    mu_bins = np.asarray(mu_bins, dtype=np.float64)
    if not np.allclose(mu_bins, np.linspace(0, 1, len(mu_bins))):
        raise ValueError("Bins in mu must be uniform from 0 to 1.")
    period = np.broadcast_to(np.asarray(period, dtype=np.float64), (3,))
    s_bins = np.asarray(s_bins, dtype=np.float64)
    counts = labeled_pair_count(
        sample1, _single_label(sample1), 1,
        pos2=None if do_auto else sample2, period=period, kind="smu",
        r_edges=s_bins, mu_edges=mu_bins, device=device)
    n_pairs = len(sample1) * len(sample1 if do_auto else sample2)
    n_exp = (n_pairs / np.prod(period) * 4 * np.pi / 3 *
             np.diff(s_bins**3) / (len(mu_bins) - 1))
    return counts[0, 0] / n_exp[:, None] - 1


def tpcf(sample1, r_bins, sample2=None, period=None, do_auto=True,
         do_cross=False, *, device="cuda"):
    """Real-space xi(r), natural estimator: an (s, mu) sweep with one mu
    bin (the halotools ``tpcf`` signature subset)."""
    xi = s_mu_tpcf(sample1, np.asarray(r_bins, dtype=np.float64),
                   np.array([0.0, 1.0]), sample2=sample2, period=period,
                   do_auto=do_auto, do_cross=do_cross, device=device)
    return xi[:, 0]


def delta_sigma_from_mass_profiles(rp_bins, mass_in, mass_annulus,
                                   log_mass_annulus, n_gal):
    """Exact annulus-averaged delta-sigma from per-annulus mass sums:

        <ds>_i = 2 / (pi (r2^2 - r1^2) N) *
                 [ ln(r2/r1) M(<r1) + S0_i ln(r2) - SL_i - S0_i / 2 ]

    with S0_i the pair mass in the annulus and SL_i = Sum m ln(rp) over
    its pairs.  Leading axes of the mass arrays broadcast."""
    r1, r2 = rp_bins[:-1], rp_bins[1:]
    bracket = (np.log(r2 / r1) * mass_in + mass_annulus * np.log(r2) -
               log_mass_annulus - 0.5 * mass_annulus)
    return 2.0 * bracket / (np.pi * (r2**2 - r1**2) * n_gal)


def mean_delta_sigma(galaxies, particles, particle_masses, rp_bins,
                     period=None, estimator="annulus_mean", *,
                     device="cuda"):
    """Mean excess surface density delta-sigma(rp) [h Msun / Mpc^2] from
    galaxy-particle pair mass sums in projected annuli (the full periodic z
    column; halotools' ``mean_delta_sigma``, reference
    scripts/tabulate_snapshot.py:235-237).

    ``'annulus_mean'`` (default): the exact area-weighted average over
    each annulus (:func:`delta_sigma_from_mass_profiles`), both channels
    from one sweep.  ``'midpoint'``: sigma_bar(< r_mid) - sigma(annulus)
    at r_mid = sqrt(r1 r2).
    """
    period = np.broadcast_to(np.asarray(period, dtype=np.float64), (3,))
    rp_bins = np.asarray(rp_bins, dtype=np.float64)
    particle_masses = np.asarray(particle_masses, dtype=np.float64)
    if particle_masses.ndim == 0:
        particle_masses = np.full(len(particles), particle_masses)
    n_gal = len(galaxies)
    labels = _single_label(galaxies)

    if estimator == "annulus_mean":
        edges = np.concatenate([[0.0], rp_bins])
        mass, log_mass = labeled_pair_count(
            galaxies, labels, 1, pos2=particles,
            weights2=particle_masses, period=period, kind="proj",
            r_edges=edges, pair_weight="unit+log_rp",
            device=device)[:, 0, 0]
        mass_in = np.cumsum(mass)[:-1]
        return delta_sigma_from_mass_profiles(
            rp_bins, mass_in, mass[1:], log_mass[1:], n_gal)

    if estimator != "midpoint":
        raise ValueError(f"Unknown estimator '{estimator}'.")

    # One histogram over the deduplicated edges [0, mids + edges]; the
    # cylinder masses looked up by searchsorted index.
    rp_mids = np.sqrt(rp_bins[:-1] * rp_bins[1:])
    all_edges = np.unique(np.concatenate([[0.0], rp_bins, rp_mids]))
    counts = labeled_pair_count(
        galaxies, labels, 1, pos2=particles, weights2=particle_masses,
        period=period, kind="proj", r_edges=all_edges, device=device)[0, 0]
    cum_mass = np.concatenate([[0.0], np.cumsum(counts)])

    def mass_at(r):
        return cum_mass[np.searchsorted(all_edges, r)]

    sigma_bar = mass_at(rp_mids) / (np.pi * rp_mids**2 * n_gal)
    annulus_mass = mass_at(rp_bins[1:]) - mass_at(rp_bins[:-1])
    sigma = annulus_mass / (np.pi * np.diff(rp_bins**2) * n_gal)
    return sigma_bar - sigma
