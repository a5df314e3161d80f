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
  tensors on the card, over the cell-list layout built on the card
  (:func:`bucket_layout`): one block per (spatially compact tile of
  i-tracers of mixed labels, label_2), scanning that label's xy cell
  columns around the tile within its z-window (:func:`pair_runs`); or
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
tabcorr_tpu's ``paircount.py:24-40`` is met by float64 sums).  A sweep
sharded over a mesh (``labeled_pair_count(mesh=)``) counts each rank's
block of j-tracers and sums the ranks' histograms in one all-reduce.

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
import torch.distributed as dist

from ..utils.build import load_library
from ..utils.device import resolve_device
from ..utils.progress import progress as progress_bar

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
    ``j_range``: (start, stop), the j-tracers this sweep pairs the
    i-tracers with -- one rank's block of a sharded sweep, whose tracers
    keep their index in the whole j-side (the self-pair test of auto mode
    compares them with the i-tracers') -- or None for every j-tracer.
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
    j_range: tuple | None = None

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

    @property
    def j_first(self):
        """The index of the sweep's first j-tracer in the whole j-side."""
        return 0 if self.j_range is None else self.j_range[0]

    def j_side(self):
        """(pos2, labels2, weights2 or ones) of the j-tracers the sweep
        pairs with (those of ``j_range``)."""
        pos = self.pos1 if self.auto else self.pos2
        labels = self.labels1 if self.auto else self.labels2
        w = (torch.ones(len(pos), dtype=torch.float32, device=pos.device)
             if self.weights2 is None else self.weights2)
        if self.j_range is None:
            return pos, labels, w
        js = slice(*self.j_range)
        return pos[js], labels[js], w[js]


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
    if sweep.j_range is not None and not (
            0 <= sweep.j_range[0] <= sweep.j_range[1] <= n2):
        raise ValueError(f"j_range {sweep.j_range} must lie in [0, {n2}].")


# ----------------------------------------------------------------------
# The host-facing function
# ----------------------------------------------------------------------
def labeled_pair_count(pos1, labels1, n_labels_1, pos2=None, labels2=None,
                       n_labels_2=None, weights2=None, period=1.0,
                       kind="rppi", r_edges=None, pi_max=None,
                       mu_edges=None, progress=False, mesh=None,
                       strategy=None, sort=True, pair_weight="unit", *,
                       device="cuda"):
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
    progress : report the sweep's steps (tqdm, else plain lines on
        stderr): one a launch on the card, one an i-chunk window on the
        plain version.
    mesh : DeviceMesh, optional
        Shard the sweep over the mesh's first dimension
        (:mod:`tabcorr_tpu_torch.parallel`; tabcorr_tpu's
        ``_sweep_block_sharded``): every rank of the world calls with the
        same tracers, counts the i-tracers against its contiguous block of
        the j-tracers (:func:`shard_sweep`), and one all-reduce over that
        dimension sums the histograms (int64 unit counts, else float64),
        so every rank returns the whole counts.
    strategy : None (default: the CUDA kernel or its plain version, by
        ``device``) or 'native': the host C++ counter
        (:mod:`tabcorr_tpu_torch.native`, float64 geometry, uniform mu
        bins only), which counts on the host and takes ``device='cpu'``
        only.  Nothing routes to it unless asked.
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
    if strategy not in (None, "native"):
        raise ValueError(f"Unknown strategy {strategy!r}; use None (the "
                         "device given by device=) or 'native'.")
    if strategy == "native":
        if mesh is not None:
            raise ValueError("strategy='native' counts on one host and "
                             "takes no mesh.")
        if device is None or torch.device(device).type != "cpu":
            raise ValueError("strategy='native' counts on the host: pass "
                             "device='cpu'.")
        from .. import native
        return native.labeled_pair_count(
            pos1, labels1, n_labels_1, pos2=pos2, labels2=labels2,
            n_labels_2=n_labels_2, weights2=weights2, period=period,
            kind=kind, r_edges=r_edges, pi_max=pi_max, mu_edges=mu_edges,
            pair_weight=pair_weight)
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
    if mesh is None:
        hist = paircount(sweep, progress=progress)
    else:
        hist = paircount(shard_sweep(sweep, mesh), progress=progress)
        dist.all_reduce(hist, group=mesh.get_group(0))
    counts = hist.cpu().numpy().astype(np.float64) * weight_scale
    shape = (n_labels_1, n_labels_2, n_r) if kind != "smu" else \
        (n_labels_1, n_labels_2, n_r, n_mu)
    if sweep.n_channels == 2:
        return counts.reshape((2,) + shape)
    return counts.reshape(shape)


def shard_sweep(sweep: Sweep, mesh) -> Sweep:
    """This rank's share of ``sweep`` over the first dimension of
    ``mesh``: the j-tracers cut into that dimension's size of contiguous
    blocks (``ceil(N2 / n)`` each, the last ones shorter or empty), the
    rank's block as ``j_range``.  The blocks' histograms sum to the
    sweep's."""
    n = mesh.size(0)
    rank = mesh.get_local_rank(0)
    n2 = len(sweep.pos1 if sweep.auto else sweep.pos2)
    block = -(-n2 // n)
    return dataclasses.replace(sweep, j_range=(
        min(rank * block, n2), min((rank + 1) * block, n2)))


def paircount(sweep: Sweep, progress=False) -> torch.Tensor:
    """The flat histogram (n_channels * n_hist,) of ``sweep``: int64 for
    unit counts, else float64, on the sweep's device.  The CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU;
    ``progress`` reports one step a launch, one an i-chunk window."""
    if sweep.device.type == "cuda":
        for _ in progress_bar(range(1), disable=not progress,
                              desc="pair counting"):
            hist = paircount_launch(sweep)
        return hist
    return paircount_plain(sweep, progress=progress)


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


def paircount_plain(sweep: Sweep, progress=False) -> torch.Tensor:
    """The kernel's plain version, in tensor ops on the sweep's device:
    tabcorr_tpu's sweep (z-sorted chunks of ``CHUNK`` and their circular
    windows where the sweep has one), the geometry of
    :func:`pair_geometry`, and an int64 or float64 scatter.  ``progress``
    reports one step an i-chunk window."""
    check_sweep(sweep)
    hist = _empty_hist(sweep)
    pos2, lab2, w2 = sweep.j_side()
    keep1, keep2 = sweep.labels1 >= 0, lab2 >= 0
    pos1, lab1 = sweep.pos1[keep1], sweep.labels1[keep1]
    idx1 = torch.nonzero(keep1).flatten()
    pos2, lab2, w2 = pos2[keep2], lab2[keep2], w2[keep2]
    idx2 = torch.nonzero(keep2).flatten() + sweep.j_first
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
    chunks = progress_bar(range(0, n1, CHUNK), disable=not progress,
                          desc="pair counting")
    for c, a in enumerate(chunks):
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
# xy cells per axis: the period over (the largest radial edge /
# CELLS_PER_REACH), rounded down, at most MAX_AXIS_CELLS; fewer where the
# (label_2, cell) columns would pass MAX_COLUMNS or a tile's neighbour
# cells MAX_NEIGHBOURS (csrc/paircount.cu kMaxNeighbours).
CELLS_PER_REACH = 4
MAX_AXIS_CELLS = 128
MAX_COLUMNS = 2 ** 24
MAX_NEIGHBOURS = 128
# Shared memory for a block's label-group histogram (a block has 227 KB
# on an H100), and the most that the private float64 rows of a weighted
# sweep's block may take.
HIST_BYTES = 40 * 1024
PRIVATE_ROWS_BYTES = 64 * 1024
# (tile, label_2, neighbour) columns one step of pair_runs searches.
_RUN_CHUNK = 2 ** 21


@dataclasses.dataclass(frozen=True)
class PairLayout:
    """The kernel's inputs, built on the sweep's device by
    :func:`bucket_layout`; labels below 0 dropped on both sides.

    i-side, sorted by (label group, xy cell, z): ``pos1`` (N1, 4) float32
    (x, y, z, 0), ``labels1`` and ``index1`` (each tracer's index in the
    sweep) (N1,) int32; tiles of at most ``TILE`` i-tracers of one (group,
    cell), ``tile_start``, ``tile_count``, ``tile_group``, ``tile_cell``
    (n_tiles,) int32; ``group_start`` (n_groups + 1,) int32, the first
    label_1 of each group (a run of consecutive labels), ``group_rows``
    the most labels a group holds.

    j-side, sorted by (label_2, xy cell, z): ``pos2`` (N2, 4) float32 (x,
    y, z, weight), ``index2`` (N2,) int32; ``columns`` (n_labels_2 *
    n_cells + 1,) int32, the start of each (label_2, cell) column.

    ``cells``: (n_x, n_y) cells per axis, a cell's index ``cx * n_y +
    cy``; ``neighbours`` (n_nb, 2) int32: the cell offsets (rx, ry), each
    a residue of its axis, that a tile scans; ``reach_z`` (n_nb,) float64:
    each offset's z reach (-1: whole columns, the sweep has no window).
    ``private_rows``: a weighted sweep whose threads each add into a
    private float64 row (one group of every label)."""

    pos1: torch.Tensor
    labels1: torch.Tensor
    index1: torch.Tensor
    tile_start: torch.Tensor
    tile_count: torch.Tensor
    tile_group: torch.Tensor
    tile_cell: torch.Tensor
    group_start: torch.Tensor
    group_rows: int
    pos2: torch.Tensor
    index2: torch.Tensor
    columns: torch.Tensor
    cells: tuple
    neighbours: torch.Tensor
    reach_z: torch.Tensor
    private_rows: bool

    @property
    def n_tiles(self):
        return len(self.tile_start)


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


def _margin(period):
    """tabcorr_tpu's float32 safety margin on a distance cut."""
    return 1e-3 + 1e-6 * period


def cell_grid(sweep: Sweep):
    """The xy cells per axis and the cell offsets a tile scans.

    A kept pair lies within the largest radial edge in projection (rp <=
    s for 'smu').  An offset (rx, ry) is a residue of each axis, so a
    wrapped offset never names a cell twice however few cells an axis
    has; it is kept when the least periodic gap between two cells that far
    apart -- ``max(m - 1, 0) * side`` per axis, m the circular distance in
    cells -- is within that edge (plus the margin) in quadrature: a lower
    bound of every minimum-image separation between the two cells, so
    no offset within reach is dropped however the reach compares with the
    period.  Returns ((n_x, n_y), offsets (n_nb, 2) int64, gaps (n_nb,)
    float64)."""
    r_max = float(np.sqrt(np.float64(sweep.edges_sq[-1])))
    reach = r_max + _margin(max(sweep.period[:2]))
    n = [MAX_AXIS_CELLS if r_max <= 0 else
         int(min(MAX_AXIS_CELLS, max(1.0, np.floor(p * CELLS_PER_REACH /
                                                    r_max))))
         for p in sweep.period[:2]]
    while True:
        gap = []
        for p, n_a in zip(sweep.period[:2], n):
            r = np.arange(n_a)
            gap.append(np.maximum(np.minimum(r, n_a - r) - 1, 0) * (p / n_a))
        gap_sq = gap[0][:, None] ** 2 + gap[1][None, :] ** 2
        rx, ry = np.nonzero(gap_sq <= reach ** 2)
        if n == [1, 1] or (len(rx) <= MAX_NEIGHBOURS and
                           sweep.n_labels_2 * n[0] * n[1] <= MAX_COLUMNS):
            return (tuple(n), np.stack([rx, ry], axis=1),
                    np.sqrt(gap_sq[rx, ry]))
        n = [max(1, n_a * 3 // 4) for n_a in n]


def _z_reach(sweep: Sweep, gaps):
    """Each offset's z reach: the line-of-sight cut plus the margin
    ('rppi'); for 'smu' the sphere's half-chord at the offset's least xy
    gap, sqrt((s_max + m)^2 - gap^2) + m; -1 where the sweep has no
    window."""
    if sweep.z_cut is None:
        return np.full(len(gaps), -1.0)
    m = _margin(sweep.period[2])
    if sweep.kind == "smu":
        s = max(sweep.z_cut, float(np.sqrt(np.float64(sweep.edges_sq[-1]))))
        return np.sqrt(np.maximum((s + m) ** 2 - gaps ** 2, 0.0)) + m
    return np.full(len(gaps), sweep.z_cut + m)


def _sorted(key, z):
    """The order by (key, z), or by key alone where z is None."""
    if z is None:
        return torch.argsort(key, stable=True)
    order = torch.argsort(z, stable=True)
    return order[torch.argsort(key[order], stable=True)]


def _starts(key, n_keys):
    """(n_keys + 1,) int64 starts of each key's run in a sorted order."""
    starts = torch.zeros(n_keys + 1, dtype=torch.int64, device=key.device)
    starts[1:] = torch.cumsum(torch.bincount(key, minlength=n_keys), 0)
    return starts


def bucket_layout(sweep: Sweep) -> PairLayout:
    """The kernel's layout (tensor ops on the sweep's device).

    j-side: one cell list per label_2, its tracers sorted by (xy cell, z)
    (by cell alone where the sweep has no z window).  i-side: spatially
    compact tiles that mix labels: the tracers sorted by (label group,
    cell, z) and cut into tiles of at most ``TILE`` within one (group,
    cell).  A label group is a run of consecutive labels_1 whose block
    histogram (rows x n_channels x n_hist_r cells of 4 or 8 bytes) fits
    HIST_BYTES; a weighted sweep whose 256 private float64 rows fit
    PRIVATE_ROWS_BYTES takes one group of every label (the kernel's
    float64 shared atomics are compare-and-swap loops; private rows need
    none).  Each block (tile, label_2) then scans the columns of
    its label_2 in the cells of :func:`cell_grid` around its tile's cell,
    each over the tile's z range widened by the offset's z reach
    (:func:`pair_runs`)."""
    dev = sweep.device
    n_l1, n_l2 = sweep.n_labels_1, sweep.n_labels_2
    (n_x, n_y), offsets, gaps = cell_grid(sweep)
    n_cells = n_x * n_y
    windowed = sweep.z_cut is not None
    row_cells = sweep.n_channels * sweep.n_hist_r
    private = (not sweep.unit_counts and
               TILE * (row_cells | 1) * 8 <= PRIVATE_ROWS_BYTES)
    row_bytes = row_cells * (4 if sweep.unit_counts else 8)
    n_groups = 1 if private else -(-n_l1 // max(1, HIST_BYTES // row_bytes))
    rows = -(-n_l1 // n_groups)
    n_groups = -(-n_l1 // rows)
    scale = torch.tensor([n_x / sweep.period[0], n_y / sweep.period[1]],
                         dtype=torch.float32, device=dev)
    last = torch.tensor([n_x - 1, n_y - 1], device=dev)

    def side(pos, labels, weights, label_key, first=0):
        """Drop labels below 0; sort by (label_key * n_cells + cell, z);
        tracer indices count from ``first``."""
        keep = labels >= 0
        index = torch.nonzero(keep).flatten() + first
        pos, labels = pos[keep], labels[keep].long()
        cxy = torch.minimum(torch.floor(pos[:, :2] * scale).long(), last)
        key = label_key(labels) * n_cells + cxy[:, 0] * n_y + cxy[:, 1]
        order = _sorted(key, pos[:, 2] if windowed else None)
        w = (torch.zeros(len(pos), dtype=torch.float32, device=dev)
             if weights is None else weights[keep][order])
        packed = torch.cat([pos[order], w[:, None]], dim=1).contiguous()
        return (packed, labels[order].int(), index[order].int(),
                key[order])

    pos2, labels2, w2 = sweep.j_side()
    pos2, _, index2, key2 = side(pos2, labels2, w2, lambda lab: lab,
                                 sweep.j_first)
    columns = _starts(key2, n_l2 * n_cells)
    pos1, labels1, index1, key1 = side(sweep.pos1, sweep.labels1, None,
                                       lambda lab: lab // rows)
    col1 = _starts(key1, n_groups * n_cells)
    counts = col1.diff()
    tiles_per = (counts + TILE - 1) // TILE
    tile_col = torch.repeat_interleave(
        torch.arange(len(counts), device=dev), tiles_per)
    first = torch.cumsum(tiles_per, 0) - tiles_per
    k = torch.arange(len(tile_col), device=dev) - first[tile_col]
    tile_start = col1[tile_col] + TILE * k
    tile_count = torch.minimum(col1[tile_col + 1] - tile_start,
                               torch.full_like(tile_start, TILE))
    group_start = torch.tensor(list(range(0, n_l1, rows)) + [n_l1],
                               dtype=torch.int32, device=dev)
    i32 = torch.int32
    return PairLayout(
        pos1=pos1, labels1=labels1, index1=index1,
        tile_start=tile_start.to(i32), tile_count=tile_count.to(i32),
        tile_group=(tile_col // n_cells).to(i32),
        tile_cell=(tile_col % n_cells).to(i32),
        group_start=group_start, group_rows=rows, pos2=pos2,
        index2=index2, columns=columns.to(i32), cells=(n_x, n_y),
        neighbours=torch.tensor(offsets, dtype=i32, device=dev),
        reach_z=torch.tensor(_z_reach(sweep, gaps), dtype=torch.float64,
                             device=dev), private_rows=private)


def _f32_bits(x):
    """The float32 bit patterns of non-negative values, as int64 (ordered
    as the values are)."""
    return x.contiguous().view(torch.int32).long()


def pair_runs(sweep: Sweep, layout: PairLayout, tiles) -> torch.Tensor:
    """The j-runs [a0, b0) and [a1, b1) of each (tile, label_2, offset)
    column as the kernel finds them (csrc/paircount.cu ``column_runs``):
    the column's j-tracers whose z lies within the offset's z reach of the
    tile's z range across the periodic boundary -- at most two runs of
    the column, the second before the first -- or the whole column where
    the sweep has no window or the widened range spans the period.
    (len(tiles), n_labels_2, n_nb, 4) int64, in tensor ops; the searches
    are exact (keys of column and float32 bits), as the kernel's float64
    comparisons are."""
    dev = layout.pos2.device
    tiles = torch.as_tensor(tiles, device=dev).long()
    n_x, n_y = layout.cells
    n_cells = n_x * n_y
    n_l2 = sweep.n_labels_2
    cell = layout.tile_cell[tiles].long()
    rx = layout.neighbours[:, 0].long()
    ry = layout.neighbours[:, 1].long()
    ncell = (((cell // n_y)[:, None] + rx) % n_x * n_y +
             ((cell % n_y)[:, None] + ry) % n_y)
    col = (torch.arange(n_l2, device=dev)[None, :, None] * n_cells +
           ncell[:, None, :])
    starts = layout.columns.long()
    cs, ce = starts[col], starts[col + 1]
    if not bool((layout.reach_z >= 0).all()):
        return torch.stack([cs, ce, cs, cs], dim=-1)
    first = layout.tile_start[tiles].long()
    z_lo = layout.pos1[first, 2].double()
    z_hi = layout.pos1[first + layout.tile_count[tiles].long() - 1,
                       2].double()
    lo = z_lo[:, None] - layout.reach_z[None, :]
    hi = z_hi[:, None] + layout.reach_z[None, :]
    pz = float(sweep.period[2])
    full = (hi - lo) >= pz
    wrap_lo = lo <= 0
    wrap_hi = ~wrap_lo & (hi >= pz)
    wraps = wrap_lo | wrap_hi
    u0 = torch.where(wrap_lo, lo + pz, lo)
    v0 = torch.where(wraps, torch.full_like(hi, pz + 1), hi)
    v1 = torch.where(wrap_lo, hi, hi - pz)
    z2 = layout.pos2[:, 2] + 0.0             # -0.0 to +0.0
    keys = (torch.repeat_interleave(
        torch.arange(len(starts) - 1, device=dev), starts.diff()) << 32) + \
        _f32_bits(z2)
    base = col << 32

    def first_at_or_above(u):
        f = u.float()
        f = torch.where(f.double() < u,
                        torch.nextafter(f, torch.full_like(f, np.inf)), f)
        f = torch.where(f > 0, f, torch.zeros_like(f))
        q = base + _f32_bits(f)[:, None, :]
        return torch.searchsorted(keys, q.contiguous())

    def first_above(v):
        g = v.float()
        g = torch.where(g.double() > v,
                        torch.nextafter(g, torch.full_like(g, -np.inf)), g)
        bits = torch.where(g < 0, torch.full_like(g, -1, dtype=torch.int64),
                           _f32_bits(torch.where(g > 0, g,
                                                 torch.zeros_like(g))))
        return torch.searchsorted(keys, (base + bits[:, None, :])
                                  .contiguous(), right=True)

    a0 = first_at_or_above(u0)
    b0 = torch.maximum(first_above(v0), a0)
    b1 = torch.where(wraps[:, None, :], torch.minimum(first_above(v1), a0),
                     cs)
    whole = full[:, None, :]
    return torch.stack([torch.where(whole, cs, a0),
                        torch.where(whole, ce, b0), cs,
                        torch.where(whole, cs, b1)], dim=-1)


def candidate_count(sweep: Sweep, layout: PairLayout) -> int:
    """The pairs the kernel evaluates over ``layout``: each tile's tracers
    times the j-tracers of its runs, summed over every block."""
    per = max(1, _RUN_CHUNK // (sweep.n_labels_2 * len(layout.neighbours)))
    total = 0
    for t0 in range(0, layout.n_tiles, per):
        tiles = torch.arange(t0, min(t0 + per, layout.n_tiles),
                             device=layout.pos2.device)
        runs = pair_runs(sweep, layout, tiles)
        lengths = (runs[..., 1] - runs[..., 0] + runs[..., 3] -
                   runs[..., 2]).sum(dim=(1, 2))
        total += int((layout.tile_count[tiles].long() * lengths).sum())
    return total


@functools.cache
def _paircount_lib():
    """Build (first call only) and bind csrc/paircount.cu."""
    lib = load_library("paircount", KERNEL_SOURCES["paircount"])
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tabcorr_paircount.argtypes = (
        [vp] * 7 + [i] + [vp, i] + [vp] * 5 + [i] * 3 + [i] * 5 +
        [vp, i, vp, i] + [f] * 7 + [i, vp, vp, i, vp])
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
    [0, period], more than 65,535 j-labels, a label pair's histogram row
    or edge list over its shared memory, and buckets so full that a
    block's 32-bit counts could wrap: a block visits each j-tracer of its
    label_2 at most once (distinct cells, disjoint runs), so a cell gains
    at most TILE x that label's tracers."""
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


def paircount_launch(sweep: Sweep, layout: PairLayout | None = None,
                     visited: torch.Tensor | None = None,
                     events=None) -> torch.Tensor:
    """Launch the CUDA pair counter once on ``sweep`` (tensors on the
    card), over ``layout`` (built here by :func:`bucket_layout` unless
    given).  Returns the flat histogram as :func:`paircount` does.

    ``visited``: an optional (1,) int64 tensor on the card to which the
    kernel adds the pairs it evaluated (:func:`candidate_count`);
    ``events``: an optional (start, end) pair of CUDA events recorded on
    the stream just before and after the kernel.  Raises on any input the
    kernel does not take and on any launch error."""
    global PAIRCOUNT_LAUNCHES
    check_kernel_sweep(sweep)
    if layout is None:
        layout = bucket_layout(sweep)
    if visited is not None and (visited.shape != (1,) or
                                visited.dtype != torch.int64 or
                                visited.device != sweep.device):
        raise ValueError("visited must be a (1,) int64 tensor on the card.")
    hist = _empty_hist(sweep)
    if layout.n_tiles == 0:
        return hist
    lib = _paircount_lib()
    edges = torch.tensor(sweep.edges_sq, device=sweep.device)
    mu = torch.tensor(sweep.mu_edges, device=sweep.device)
    pw = (0 if sweep.unit_counts else
          {"unit": 1, "log_rp": 2, "unit+log_rp": 3}[sweep.pair_weight])
    stream = torch.cuda.current_stream(sweep.device)
    if events is not None:
        events[0].record(stream)
    code = lib.tabcorr_paircount(
        layout.pos1.data_ptr(), layout.labels1.data_ptr(),
        layout.index1.data_ptr(), layout.tile_start.data_ptr(),
        layout.tile_count.data_ptr(), layout.tile_group.data_ptr(),
        layout.tile_cell.data_ptr(), layout.n_tiles,
        layout.group_start.data_ptr(), layout.group_rows,
        layout.pos2.data_ptr(), layout.index2.data_ptr(),
        layout.columns.data_ptr(), layout.neighbours.data_ptr(),
        layout.reach_z.data_ptr(), len(layout.neighbours), *layout.cells,
        sweep.n_labels_1, sweep.n_labels_2, int(sweep.auto),
        KINDS.index(sweep.kind), pw, edges.data_ptr(), sweep.n_r,
        mu.data_ptr(), sweep.n_mu, *sweep.period,
        *wrap_thresholds(sweep.period), sweep.pi_max,
        int(layout.private_rows), hist.data_ptr(),
        None if visited is None else visited.data_ptr(),
        sweep.device.index, stream.cuda_stream)
    if events is not None:
        events[1].record(stream)
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
