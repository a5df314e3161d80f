"""Fused predictors: the hand-written CUDA kernels and their plain versions.

Ports of the four Pallas kernels of ``tabcorr_tpu/ops/fused.py``.  Every
kernel has a plain version in tensor ops beside it; a wrapper runs the
plain version for CPU tensors and launches the kernel (or raises) for
CUDA tensors.  B3 computes in full float32 and B2 contracts in float64
on the tensor cores, under both accuracy contracts ('elementwise',
'scaled'); B1 and B4 take the tensor cores under 'scaled' (below).

The kernels that evaluate the occupation themselves (B1, B2, B4) take
every model whose ``supports_fused_engine`` is true, by the model code of
:func:`kernel_model`: zheng07 (code 0) and zheng07 with the Heaviside
assembly-bias decoration (code 1,
:class:`~..models.assembias.AssembiasZheng07Model`) are evaluated in the
kernel, chosen on the model's exact type; every other model, subclasses of
those two included, is code 2 (densities in): the kernel reads its
densities, (n_bins, B) bin-major (``csrc/zheng07.cuh``), from the
occupation kernel below where that evaluates the model, else from
:func:`occupation_density` in tensor ops (:func:`kernel_densities`).  The
plain version of a code-2 launch is the plain contraction of the same
densities.  A model whose flag is false (the non-parametric HOD) takes
none of these kernels.

* **Occupation**, the occupation phase the Pallas kernels B1, B2 and B4
  trace in their bodies for the SHMR, CLF and quiescent/active families
  (Leauthaud11, ZuMandelbaum15, Tinker13, Cacciato09 and their Heaviside
  decorations; :class:`OccupationFamily`, on the exact type), as a launch
  of its own ahead of theirs: the per-bin densities, each node at its
  float64 abscissa, every table of one predictor (a bundle's too) in one
  launch.  Its node plan (:func:`occupation_plan`, built once per
  predictor) lists the distinct mass bins of those tables and the output
  bins each serves, so each distinct node is evaluated once per row.
  :func:`occupation_launch` (``csrc/occupation.cu``) and
  :func:`occupation_density`.  The contraction route takes its densities
  too.

* **Bundle (B1)**, port of ``make_fused_bundle_predictor``: for a batch of
  parameter vectors and a list of tabulations, the per-bin galaxy density

      n[b, i] = sum_g occ(params_b, node_ig) * quad_weight[i, g] * n_h[i]

  (occupation at the float64 Gauss-Legendre nodes, residual absorbed),
  then per table

      auto:  xi[b, k] = n_b^T F_k n_b / (sum_i n_bi)^2
      cross: xi[b, k] = (F n_b)_k / sum_i n_bi

  :func:`bundle_launch` (``csrc/bundle.cu``) and
  :func:`bundle_predict_plain` (any model).  Each table takes a route by
  its contract (:func:`bundle_routes`): a 'scaled' auto table is
  contracted in 3xTF32 on ``wgmma`` from its split constants (slab_tc's
  machinery for one node), every other table in FP32, all in one launch.
* **Contraction (B3)**, port of ``make_fused_contraction`` and
  ``make_fused_predictor``: the same contraction for one table from a
  given density ``n`` -- the occupation runs before it (the occupation
  kernel, or tensor ops), so any model takes this route.  :func:`contraction_launch`
  (``csrc/bundle.cu``) and :func:`contraction_plain`.  On a bfloat16
  table (tabcorr_tpu's bf16 route, densities and results bfloat16) the
  BF16 tensor-core kernel :func:`contraction_bf16_launch`
  (``csrc/bf16.cu``, ``wgmma`` fed by TMA, float32 accumulators) and
  :func:`contraction_bf16_plain`, on :class:`Bf16Table` constants.
* **Grid (B2)**, port of ``_make_grid_packed_predictor`` behind
  ``make_fused_grid_predictor``: an Interpolator grid of one halo binning,
  every node's statistics from the packed symmetric matrices, optionally
  reduced in the kernel by the grid spline's per-sample node weights.
  :func:`grid_launch` (``csrc/grid.cu``) and :func:`grid_predict_plain`.
* **Slab (B4)**, port of ``make_fused_grid_predictor(layout='slab')``:
  the same grid for auto tables too wide for the packed layout (more
  than 127 bins), every node's statistics from B1's contraction over the
  node's matrix, without the spline fold.  :func:`slab_launch`
  (``csrc/slab.cu``) and :func:`slab_predict_plain`.

B2 has one kernel: it contracts in float64 on the tensor cores and serves
both contracts, as B3's FP32 kernel does (:func:`grid_kernel_for`).  B4
keeps two tiers by contract, the counterpart of tabcorr_tpu's MXU pass
classes: :func:`slab_tc_launch` (3xTF32 on ``wgmma`` fed by TMA,
``csrc/slab.cu`` and ``csrc/hopper.cuh``) under 'scaled', the FP32 slab
kernel under 'elementwise'; B1 routes a table by the same rule, in one
kernel.  The plain versions serve every kernel.

On the card B1, B3 and the FP32 tier of B4 read their matrices in one
layout, the block-triangular half of each symmetric matrix
(:class:`SlabTcTable`, a bundle table as one node; ``csrc/contract.cuh``);
slab_tc and B1's tensor-core route read the same columns split into TF32
halves once on the host (:class:`SlabSplitTable`); the dense layouts
(:class:`BundleTable`, :class:`SlabTable`) serve the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..models.assembias import (ASSEMBIAS_PARAMS, AssembiasCacciato09Model,
                                AssembiasLeauthaud11Model,
                                AssembiasTinker13Model,
                                AssembiasZheng07Model,
                                AssembiasZuMandelbaum15Model)
from ..models.cacciato09 import CACCIATO09_PARAMS, Cacciato09Model
from ..models.leauthaud11 import LEAUTHAUD11_PARAMS, Leauthaud11Model
from ..models.protocol import occupation_functions
from ..models.tinker13 import (QUIESCENT, Tinker13Model,
                               tinker13_fq_spline_map)
from ..models.zheng07 import Zheng07Model
from ..models.zu_mandelbaum15 import (ZU_MANDELBAUM15_PARAMS,
                                      ZuMandelbaum15Model)
from ..utils import profiling
from ..utils.build import build_libraries, load_library
from .predict import AUTO, TableData, mean_occupation, occupation_with_residual

# Launches of each CUDA kernel in this process (see the launch functions;
# each launch function is a span, ``fused.<function>``, while a profiler
# records: utils.profiling).
BUNDLE_LAUNCHES = 0
CONTRACTION_LAUNCHES = 0
GRID_LAUNCHES = 0
SLAB_LAUNCHES = 0
SLAB_TC_LAUNCHES = 0
OCCUPATION_LAUNCHES = 0
CONTRACTION_BF16_LAUNCHES = 0
# Tables the bundle kernel has contracted on the tensor cores, summed over
# its launches (each launch's count is the ``tc_tables`` of its
# ``fused.bundle_launch`` span).
BUNDLE_TC_TABLES = 0

ACCURACY_CONTRACTS = ("elementwise", "scaled")

# The CUDA sources of each library (one nvcc each); grid.cu and slab.cu
# hold their _tc kernels too.
KERNEL_SOURCES = {"bundle": ("bundle.cu",), "grid": ("grid.cu",),
                  "slab": ("slab.cu",), "occupation": ("occupation.cu",),
                  "bf16": ("bf16.cu",)}

# The models the kernels evaluate in-kernel, by model code
# (csrc/zheng07.cuh); every other fused-engine model is DENSITY_IN.
KERNEL_MODELS = (Zheng07Model, AssembiasZheng07Model)
DENSITY_IN = 2
# The models the occupation kernel evaluates (csrc/occupation.cu), by exact
# type: (family code, decorated).
OCCUPATION_FAMILIES = {
    Leauthaud11Model: (0, False), AssembiasLeauthaud11Model: (0, True),
    ZuMandelbaum15Model: (1, False), AssembiasZuMandelbaum15Model: (1, True),
    Tinker13Model: (2, False), AssembiasTinker13Model: (2, True),
    Cacciato09Model: (3, False), AssembiasCacciato09Model: (3, True)}
_SFR_CODES = {"all": 0, QUIESCENT: 1, "active": 2}
# Tinker13's quiescent-fraction control masses the kernel takes at most.
_MAX_SPLINE_POINTS = 8

# Tile geometry of csrc/grid.cu and of the dense layouts: the matrix is
# staged in chunks of _KT rows and _CT columns, and each thread owns 4
# consecutive columns.
_KT = 32
_CT = 128
_MAX_TABLES = 4
_SMEM_LIMIT = 232448          # bytes a block may use on sm_90
_PLAIN_CHUNK = 4096
# Rows of per-row parameter terms in a block's shared memory, plus the
# row totals (csrc/zheng07.cuh kParTerms + 1).
_ROW_TERMS = 9
# Rows per tensor-op occupation pass (the plain version of the occupation
# kernel, and the densities of a model it does not evaluate): it bounds
# the (chunk, n_bins, n_gauss) intermediates.
_OCC_CHUNK = 32768
# The occupation kernel (csrc/occupation.cu): rows per block, output bins
# one unit of its node plan serves at most (a mass bin more bins read is
# split into units of at most this many; csrc/occupation.cu kMaxOuts), and
# the blocks a launch aims at (8-10 waves of the 6-8 blocks of 128 rows an
# SM holds at the families' registers): a block takes as many consecutive
# units as keep that many blocks.
_OCC_ROWS = 128
_OCC_MAX_OUTS = 4
_OCC_TARGET_BLOCKS = 8192
# Batch rows per block the grid kernel may take, largest first, and the
# stages of its cp.async ring.
_GRID_BLOCK_ROWS = (64, 32, 16)
_GRID_STAGES = {64: 2, 32: 3, 16: 3}
# Tile geometry of csrc/tf32x3.cuh: a staged tile of the grid kernel's
# packed matrix is _KT rows of _CT columns at a row stride of _TC_BS
# floats.  The cp.async ring stages of contract.cuh's FP32 contraction.
_TC_BS = _CT + 8
_RING_STAGES = 2
# slab_tc (csrc/slab.cu, namespace stc): a ring slot holds one stage, one
# k-step (8 K rows) of a 128-column tile, TF32 hi and lo (8 KB), plus its
# two mbarriers.  A block has 1 or 2 consumer warpgroups of 64 rows; two
# take at least 3 slots, one at least 2; 4 where they fit (on the wide
# grid 4, 8 and 15 slots time within 1.5% of each other, 4 fastest;
# scripts/torch_slab_probe.py).
_SPLIT_STEP_FLOATS = 2 * _CT * 8
_SLAB_TC_SLOT_BYTES = 4 * _SPLIT_STEP_FLOATS + 16
_SLAB_TC_STAGES = 4
_SLAB_TC_MIN_STAGES = {2: 3, 1: 2}
# The bundle kernel's tensor-core block (csrc/bundle.cu btc): rows per
# block (two tensor-core warpgroups of 64), and the slots of its ring.
_BUNDLE_TC_ROWS = 128
_BUNDLE_TC_SLOTS = 4
# The FP32 contraction (bundle, contraction, slab): rows per block, and the
# K steps of 8 rows per ring stage, first choice first; the second is the
# smaller ring, where the first does not fit in shared memory.
_FP32_ROWS = 64
_FP32_STAGE_STEPS = (4, 2)
# Bin-tile width of the block-triangular half layout, and the n8 column
# tiles whose sums one lane pair of contract.cuh's FP32 epilogue combines.
SLAB_TC_WIDTH = 8
_PAIR_SLOTS = 2
# The bfloat16 contraction (csrc/bf16.cu): padded bins up to which the
# registers kernel holds a row's densities in registers (bins padded to a
# multiple of 32; wider tables run the streamed kernel, bins padded to a
# multiple of 64), the widest table it takes (the widest its tests hold it
# to the plain version at), the consumer warpgroups of a block, the
# statistics of a staging window, the ring's most slots, the shared memory
# of a streamed block when two share an SM, and the bytes of the plain
# version's float64 product per chunk of rows.
_BF16_REG_BINS = 160
_BF16_MAX_BINS = 1792
_BF16_CONSUMERS = 2
_BF16_WIN = 64
_BF16_MAX_STAGES = 8
_BF16_HALF_SM = 115712
_BF16_PLAIN_BYTES = 2 ** 29


def _round_up(n, m):
    return -(-n // m) * m


def _tensor(a, device, dtype=np.float32):
    return torch.tensor(np.ascontiguousarray(a, dtype=dtype), device=device)


def _quadrature_arrays(table: TableData):
    """Per-bin quadrature in the kernels' layout, float32 (n_bins,
    n_gauss): node, its float64 residual, secondary percentile, and
    quad_weight * n_h (port of ``_quad_segment_constants``)."""
    n_gauss = table.log_prim_quad.shape[1]
    logm = table.log_prim_quad.cpu().numpy().astype(np.float32)
    res = (np.zeros_like(logm) if table.log_prim_quad_lo is None else
           table.log_prim_quad_lo.cpu().numpy().astype(np.float32))
    weight = (table.quad_weight.cpu().numpy().astype(np.float64) *
              table.n_h.cpu().numpy().astype(np.float64)[:, None])
    sec = np.repeat(table.sec_perc.cpu().numpy().astype(np.float32)[:, None],
                    n_gauss, axis=1)
    device = table.n_h.device
    return dict(logm=_tensor(logm, device), logm_res=_tensor(res, device),
                sec=_tensor(sec, device), weight=_tensor(weight, device))


def _check_tensor(a, device, dtype, what):
    if a.device != device or a.dtype != dtype or not a.is_contiguous():
        raise ValueError(f"{what} must be contiguous {dtype} on {device}.")


def kernel_model(model):
    """The kernels' code for ``model``'s occupation: 0 for zheng07, 1 for
    zheng07 with the Heaviside assembly-bias decoration (both on the exact
    type: a subclass may change the occupation, which the in-kernel code
    would silently ignore), 2 (:data:`DENSITY_IN`) for every other model
    whose ``supports_fused_engine`` is true, None for a model whose flag is
    false."""
    for code, kind in enumerate(KERNEL_MODELS):
        if type(model) is kind:
            return code
    return DENSITY_IN if getattr(model, "supports_fused_engine",
                                 True) else None


@dataclasses.dataclass(frozen=True)
class OccupationFamily:
    """What a launch of the occupation kernel needs of the model
    (csrc/occupation.cu): its family code, whether it is decorated, its
    parameter columns in the kernel's order, and its constants."""

    family: int
    decorated: bool
    param_names: tuple
    threshold: float
    a: float = 1.0
    log_h: float = 0.0
    modulate: bool = False
    sfr: int = 0
    split: float = 0.5
    abscissa: tuple = ()

    @classmethod
    def of(cls, model):
        """The family of ``model``, on its exact type (a subclass may
        change the occupation), or None for a model the kernel does not
        evaluate: its densities come from tensor ops."""
        code = OCCUPATION_FAMILIES.get(type(model))
        if code is None:
            return None
        family, decorated = code
        extra = dict(split=float(model.split)) if decorated else {}
        if family == 0:
            names = tuple(LEAUTHAUD11_PARAMS)
            extra.update(a=model._a, log_h=math.log10(model.littleh),
                         modulate=bool(model.modulate_with_cenocc))
        elif family == 1:
            names = tuple(ZU_MANDELBAUM15_PARAMS)
            extra.update(modulate=bool(model.modulate_with_cenocc))
        elif family == 2:
            abscissa = tuple(model.quiescent_fraction_abscissa)
            if len(abscissa) > _MAX_SPLINE_POINTS:
                return None
            names = tuple(f"{k}_{sfr}" for sfr in (QUIESCENT, "active")
                          for k in LEAUTHAUD11_PARAMS) + tuple(
                f"quiescent_fraction_ordinates_param{i + 1}"
                for i in range(len(abscissa)))
            extra.update(a=model._a, log_h=math.log10(model.littleh),
                         sfr=_SFR_CODES[model.sfr_designation],
                         abscissa=abscissa)
        else:
            names = tuple(CACCIATO09_PARAMS)
        if decorated:
            names += ASSEMBIAS_PARAMS
        return cls(family=family, decorated=decorated, param_names=names,
                   threshold=float(model.threshold), **extra)


@dataclasses.dataclass(frozen=True)
class KernelModel:
    """What a kernel launch needs of the model: its code, zheng07's
    central modulation and the assembly-bias split (zheng07.cuh), and for
    densities in the occupation kernel's family, where it evaluates the
    model (None: the densities come from tensor ops)."""

    code: int = 0
    modulate: bool = False
    split: float = 0.5
    family: OccupationFamily | None = None

    @classmethod
    def of(cls, model):
        code = kernel_model(model)
        if code is None:
            raise ValueError(f"{type(model).__name__} takes no fused engine "
                             "(its supports_fused_engine is False); use the "
                             "plain engine.")
        if code == DENSITY_IN:
            return cls(code=code, family=OccupationFamily.of(model))
        return cls(code=code, modulate=bool(model.modulate_with_cenocc),
                   split=float(getattr(model, "split", 0.5)))

    @property
    def density_in(self):
        return self.code == DENSITY_IN

    @property
    def param_names(self):
        """The parameter matrix's columns, in the kernels' order (none for
        densities in)."""
        if self.density_in:
            return ()
        return KERNEL_MODELS[self.code].kernel_param_names

    def launch_args(self):
        return self.code, int(self.modulate), self.split


def _check_params(pmat, hod: KernelModel, n_bins):
    """Raise unless ``pmat`` is what a launch of ``hod`` reads: the
    (B, n_params) float32 parameter matrix, or for densities in the
    (n_bins, B) float32 densities, bin-major.  Returns the batch size."""
    if not pmat.is_cuda:
        raise ValueError("the kernels need CUDA tensors.")
    if hod.density_in:
        what, want = "densities", f"({n_bins}, B)"
        ok = pmat.dim() == 2 and pmat.shape[0] == n_bins
    else:
        n_cols = len(hod.param_names)
        what, want = "params", f"(B, {n_cols})"
        ok = pmat.dim() == 2 and pmat.shape[1] == n_cols
    if pmat.dtype != torch.float32 or not ok:
        raise ValueError(f"{what} must be {want} float32, got "
                         f"{tuple(pmat.shape)} {pmat.dtype}.")
    if not pmat.is_contiguous():
        raise ValueError(f"{what} must be contiguous.")
    batch = pmat.shape[1] if hod.density_in else pmat.shape[0]
    if batch >= 2 ** 31:
        raise ValueError("batch too large.")
    return batch


def _raise_on_error(code, what, err_str):
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} "
                           f"({err_str(code).decode()})")


def _plain_ngal(c, p, occupation_cen, occupation_sat):
    """n[b, i] in tensor ops from a table's quadrature arrays (``c`` has
    ``logm``, ``logm_res``, ``sec``, ``weight`` and ``n_centrals``) for
    the parameter chunk ``p`` of (chunk, 1, 1) tensors."""
    nc = c.n_centrals
    occ_c = occupation_with_residual(occupation_cen, p, c.logm[:nc],
                                     c.logm_res[:nc], c.sec[:nc])
    occ_s = occupation_with_residual(occupation_sat, p, c.logm[nc:],
                                     c.logm_res[nc:], c.sec[nc:])
    return torch.cat([torch.sum(occ_c * c.weight[:nc], dim=-1),
                      torch.sum(occ_s * c.weight[nc:], dim=-1)], dim=-1)


def _total(ngal):
    # Summed in float64 like the kernels: xi scales as 1/total^2, and a
    # float32 sum over ~100 bins can carry ~5e-7 relative error.
    return torch.sum(ngal, dim=-1, dtype=torch.float64).to(ngal.dtype)


def load_kernels():
    """Build every kernel library now, in parallel, and load them (they
    are otherwise built at first use)."""
    build_libraries(KERNEL_SOURCES)
    _bundle_lib()
    _grid_lib()
    _slab_lib()
    _occupation_lib()
    _bf16_lib()


def check_accuracy(accuracy, n_tables):
    """Validated per-table accuracy contracts ('elementwise' default)."""
    if accuracy is None:
        return ("elementwise",) * n_tables
    accuracy = tuple(accuracy)
    if len(accuracy) != n_tables:
        raise ValueError("accuracy must give one contract per table.")
    for a in accuracy:
        if a not in ACCURACY_CONTRACTS:
            raise ValueError(f"Unknown accuracy contract: {a!r}")
    return accuracy


# ----------------------------------------------------------------------
# Bundle (B1) and contraction (B3): constants, plain versions, kernels
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BundleTable:
    """Host-built constants of one table for the plain versions of the
    bundle and contraction kernels, as tensors on one device (the kernels
    read a one-node :class:`SlabTcTable`).

    ``logm``, ``logm_res``, ``sec`` and ``weight`` hold the quadrature
    nodes per bin (n_bins, n_gauss): float32 node, its float64 residual,
    secondary percentile, and quad_weight * n_h.  ``f_t`` is the dense
    matrix (k_pad, c_pad) float32, zero-padded: auto ``f_t[j, k * nbp + i]
    = F[k, i, j]``, with ``nbp`` the bin count rounded up to 4; cross
    ``f_t[j, k] = F[k, j]``.
    """

    auto: bool
    n_bins: int
    n_centrals: int
    n_xi: int
    nbp: int
    tpcf_shape: tuple
    logm: torch.Tensor
    logm_res: torch.Tensor
    sec: torch.Tensor
    weight: torch.Tensor
    f_t: torch.Tensor

    @property
    def n_gauss(self):
        return self.logm.shape[1]

    @property
    def k_pad(self):
        return self.f_t.shape[0]

    @property
    def c_pad(self):
        return self.f_t.shape[1]


def _contraction_matrices(dense, auto):
    """The matrices ``dense`` (n, n_xi, nb, nb) (auto) or (n, n_xi, nb)
    (cross) in the dense contraction layout of the plain versions,
    float32, zero-padded to (n, k_pad, c_pad): ``f_t[m, j, k * nbp + i] =
    F_m[k, i, j]`` (auto) or ``f_t[m, j, k] = F_m[k, j]`` (cross).
    Returns (f_t, nbp)."""
    n, n_xi, nb = dense.shape[:3]
    nbp = _round_up(nb, 4)
    k_pad = _round_up(nb, _KT)
    if auto:
        f_t = np.zeros((n, k_pad, _round_up(n_xi * nbp, _CT)), np.float32)
        blocks = np.zeros((n, nb, n_xi, nbp), np.float32)
        blocks[..., :nb] = dense.transpose(0, 3, 1, 2)    # [m, j, k, i]
        f_t[:, :nb, :n_xi * nbp] = blocks.reshape(n, nb, n_xi * nbp)
    else:
        f_t = np.zeros((n, k_pad, _round_up(n_xi, _CT)), np.float32)
        f_t[:, :nb, :n_xi] = dense.transpose(0, 2, 1)
    return f_t, nbp


def bundle_table_constants(table: TableData) -> BundleTable:
    """Per-table constants of the plain versions (port of
    ``_quad_segment_constants`` and the table part of
    ``_bundle_table_constants``)."""
    auto = table.mode == AUTO
    dense = table.tpcf_dense.cpu().numpy().astype(np.float32)
    f_t, nbp = _contraction_matrices(dense[None], auto)
    return BundleTable(auto=auto, n_bins=table.n_bins,
                       n_centrals=table.n_centrals, n_xi=dense.shape[0],
                       nbp=nbp, tpcf_shape=tuple(table.tpcf_shape),
                       f_t=_tensor(f_t[0], table.n_h.device),
                       **_quadrature_arrays(table))


def bundle_predict_plain(consts, params, occupation_cen, occupation_sat):
    """The bundle in tensor ops, ``_PLAIN_CHUNK`` batch rows at a time
    (bounding the (chunk, n_xi * nbp) contraction intermediate): float32
    densities, as in the kernel, contracted in float64
    (:func:`_contract_chunk`).

    Returns ``[(total (B,), xi (B, n_xi)), ...]`` per table.
    """
    batch = next(iter(params.values())).shape[0]
    outs = [([], []) for _ in consts]
    for lo in range(0, batch, _PLAIN_CHUNK):
        p = {k: v[lo:lo + _PLAIN_CHUNK, None, None] for k, v in params.items()}
        for c, (totals, xis) in zip(consts, outs):
            total, xi = _contract_chunk(
                c, _plain_ngal(c, p, occupation_cen, occupation_sat))
            totals.append(total)
            xis.append(xi)
    return [(torch.cat(t), torch.cat(x)) for t, x in outs]


def contraction_plain(c: BundleTable, ngal):
    """The contraction kernel's plain version: ngal (B, n_bins) float32 ->
    (total (B,), xi (B, n_xi)), ``_PLAIN_CHUNK`` rows at a time."""
    outs = [_contract_chunk(c, ngal[lo:lo + _PLAIN_CHUNK])
            for lo in range(0, ngal.shape[0], _PLAIN_CHUNK)]
    return (torch.cat([t for t, _ in outs]), torch.cat([x for _, x in outs]))


def _contract_chunk(c: BundleTable, ngal):
    """(total, xi) of one chunk of float32 densities: the contraction in
    float64, rounded to float32 before the division, as the grid and slab
    plain versions do, so that the plain version is the more accurate
    side of a comparison with the kernels (a float32 product sums the
    bins in another order than the kernels and in TF32 where a caller
    allows it)."""
    total = _total(ngal)
    n = torch.nn.functional.pad(ngal, (0, c.k_pad - c.n_bins)).double()
    t = n @ c.f_t.double()
    if not c.auto:
        return total, t[:, :c.n_xi].float() / total[:, None]
    t = t[:, :c.n_xi * c.nbp].reshape(-1, c.n_xi, c.nbp)
    q = torch.sum(t * n[:, None, :c.nbp], dim=-1)
    return total, q.float() / (total * total)[:, None]


@functools.cache
def _bundle_lib():
    """Build (first call only) and bind the entry points of bundle.cu."""
    lib = load_library("bundle", KERNEL_SOURCES["bundle"])
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tabcorr_bundle.argtypes = [vp, i, i, i, ctypes.c_double, i,
                                   ctypes.POINTER(vp), ctypes.POINTER(i), i,
                                   i, vp]
    lib.tabcorr_contraction.argtypes = ([vp, i] + [vp] * 6 + [i] * 5 +
                                        [vp, vp, i, vp])
    lib.tabcorr_bundle.restype = lib.tabcorr_contraction.restype = i
    lib.tabcorr_cuda_error_string.argtypes = [i]
    lib.tabcorr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _fp32_smem_bytes(stage_steps, n_bins, n_xi) -> int:
    """Dynamic shared memory of one block of the FP32 kernels built on
    csrc/contract.cuh with ring stages of ``stage_steps`` K steps (the
    layout ``fp32_smem_floats`` sizes)."""
    return 4 * (_round_up(n_bins, 8) * _FP32_ROWS +
                _RING_STAGES * stage_steps * 8 * _CT + _FP32_ROWS * n_xi +
                _ROW_TERMS * _FP32_ROWS)


def fp32_stage_steps(n_bins, n_xi):
    """K steps per ring stage of the FP32 contraction kernels (bundle,
    contraction, slab) for tables of at most ``n_bins`` bins and ``n_xi``
    statistics: the first of ``_FP32_STAGE_STEPS`` whose block fits in
    shared memory; None where none fits."""
    for stage_steps in _FP32_STAGE_STEPS:
        if _fp32_smem_bytes(stage_steps, n_bins, n_xi) <= _SMEM_LIMIT:
            return stage_steps
    return None


def _check_smem(block, what):
    if block is None:
        raise ValueError(f"tables too large for the {what} kernel's shared "
                         f"memory ({_SMEM_LIMIT} bytes a block).")
    return block


def contraction_fits(n_bins, n_xi) -> bool:
    """Whether the contraction kernel takes a table of this shape."""
    return fp32_stage_steps(n_bins, n_xi) is not None


def bundle_routes(tables, accuracy=None):
    """Each table's route in the bundle kernel under the contracts
    ``accuracy``: 'tc' (3xTF32 on ``wgmma``, from
    :func:`slab_split_table_constants`) for an auto table under 'scaled',
    the counterpart of tabcorr_tpu's MXU pass classes and the rule of
    :func:`grid_kernel_for`; else 'fp32' (the CUDA cores,
    :func:`slab_tc_table_constants`), which meets both contracts.  A
    cross table stays FP32 under 'scaled' too: its contraction is a
    matrix-vector product, n_xi * n_bins multiply-adds a row.  The
    tensor-core block holds every table's densities for its 128 rows at
    once; where that block does not fit in shared memory, every table
    takes the FP32 route."""
    accuracy = check_accuracy(accuracy, len(tables))
    routes = ["tc" if a == "scaled" and t.mode == AUTO else "fp32"
              for t, a in zip(tables, accuracy)]
    shapes = [(t.n_bins, t.tpcf_dense.shape[0]) for t in tables]
    if "tc" in routes and _bundle_smem_bytes(shapes, tc=True) is None:
        return ["fp32"] * len(tables)
    return routes


def bundle_constants(tables, accuracy=None):
    """The constants a bundle launch reads for ``tables`` under the
    contracts ``accuracy``, on the tables' device, one table each by its
    route (:func:`bundle_routes`): the split :class:`SlabSplitTable` on
    the tensor-core route, the :class:`SlabTcTable` on the FP32 route,
    one node each."""
    return [slab_split_table_constants(t, 1) if r == "tc" else
            slab_tc_table_constants(t, 1)
            for t, r in zip(tables, bundle_routes(tables, accuracy))]


def bundle_tc_tables(consts) -> int:
    """The tables of a bundle launch on the tensor-core route."""
    return sum(isinstance(c, SlabSplitTable) for c in consts)


def _bundle_smem_bytes(shapes, tc):
    """Dynamic shared memory of a bundle block over tables of these
    (n_bins, n_xi): the FP32-only block, or with a table on the
    tensor-core route (``tc``) the tensor-core block (csrc/bundle.cu
    btc::smem_bytes: its ring (consumer 0's FP32 ring first) and
    barriers, consumer 1's FP32 ring, and 128 rows of every table's
    densities, statistics, parameter terms and totals); None where it does
    not fit.  Both take the FP32 ring stage of :func:`fp32_stage_steps`, so
    the 'elementwise' tables keep their bits."""
    n_bins = max(n for n, _ in shapes)
    n_xi = max(k for _, k in shapes)
    stage_steps = fp32_stage_steps(n_bins, n_xi)
    if stage_steps is None:
        return None
    if not tc:
        return _fp32_smem_bytes(stage_steps, n_bins, n_xi)
    smem = ((_BUNDLE_TC_SLOTS + stage_steps) * 4 * _SPLIT_STEP_FLOATS +
            16 * _BUNDLE_TC_SLOTS + 4 * _BUNDLE_TC_ROWS * (
                sum(_round_up(n, 8) for n, _ in shapes) + n_xi + _ROW_TERMS))
    return smem if smem <= _SMEM_LIMIT else None


def bundle_takes(shapes) -> bool:
    """Whether one bundle launch takes tables of these (n_bins, n_xi)."""
    return (1 <= len(shapes) <= _MAX_TABLES and
            _bundle_smem_bytes(shapes, tc=False) is not None)


def _half_arrays(h: SlabTcTable):
    return (h.b, h.ct_step0, h.ct_steps, h.ct_off, h.col_k, h.col_i0)


def _check_half(h, device, what, n_nodes=None):
    """Raise unless ``h`` is the kernels' layout on ``device`` (of
    ``n_nodes`` nodes, where given)."""
    if not isinstance(h, SlabTcTable):
        raise ValueError(f"the {what} kernel reads the half layout "
                         "(slab_tc_table_constants).")
    if n_nodes is not None and h.n_nodes != n_nodes:
        raise ValueError(f"the {what} kernel takes tables of {n_nodes} node.")
    for a in (h.logm, h.logm_res, h.sec, h.weight, h.b):
        _check_tensor(a, device, torch.float32, f"{what} constants")
    for a in _half_arrays(h)[1:]:
        _check_tensor(a, device, torch.int32, f"{what} column tables")


def _stream_args(device):
    return device.index, torch.cuda.current_stream(device).cuda_stream


def _check_bundle_table(c, device):
    """Raise unless ``c`` is one table of a bundle launch on ``device``:
    a one-node :class:`SlabTcTable` (the FP32 route) or a one-node auto
    :class:`SlabSplitTable` (the tensor-core route)."""
    if isinstance(c, SlabSplitTable):
        if c.n_nodes != 1:
            raise ValueError("the bundle kernel takes tables of 1 node.")
        if not c.auto:
            raise ValueError("the bundle kernel's tensor-core route takes "
                             "auto tables only.")
        _check_split(c, device)
    else:
        _check_half(c, device, "bundle", n_nodes=1)


def bundle_launch(consts, pmat, hod=KernelModel()):
    """Launch the CUDA bundle kernel once for every table in ``consts``:
    a one-node :class:`SlabTcTable` (``slab_tc_table_constants(table,
    1)``) is contracted in FP32, a one-node auto :class:`SlabSplitTable`
    (``slab_split_table_constants(table, 1)``) in 3xTF32 on the tensor
    cores (:func:`bundle_routes` picks them by the contract).

    ``pmat`` is the float32 parameter matrix of the model ``hod`` (zheng07
    by default), one column per name of ``hod.param_names``, on the
    tables' CUDA device; for densities in (``hod.code`` 2) it is the list
    of each table's (n_bins, B) float32 densities instead
    (:func:`kernel_densities`).  Returns ``[(total (B,), xi (B,
    n_xi)), ...]``.  Raises on any input the kernel does not take and on
    any launch error.  The ``fused.bundle_launch`` span counts the
    tables on the tensor cores (``tc_tables``).
    """
    global BUNDLE_LAUNCHES, BUNDLE_TC_TABLES
    with profiling.span("fused.bundle_launch") as sp:
        outs, n_tc = _bundle_launch(consts, pmat, hod)
        if sp:
            sp.counts["tc_tables"] = n_tc
    BUNDLE_LAUNCHES += 1
    BUNDLE_TC_TABLES += n_tc
    return outs


def _bundle_launch(consts, pmat, hod):
    if not 1 <= len(consts) <= _MAX_TABLES:
        raise ValueError(f"the kernel takes 1 to {_MAX_TABLES} tables.")
    if hod.density_in:
        dens = list(pmat)
        if len(dens) != len(consts):
            raise ValueError("densities in: one (n_bins, B) tensor per "
                             "table.")
        batches = {_check_params(d, hod, h.n_bins)
                   for d, h in zip(dens, consts)}
        if len(batches) != 1 or len({d.device for d in dens}) != 1:
            raise ValueError("the tables' densities differ in batch or "
                             "device.")
        params_ptr, first = None, dens[0]
        batch = batches.pop()
    else:
        batch = _check_params(pmat, hod, None)
        dens = [None] * len(consts)
        params_ptr, first = pmat.data_ptr(), pmat
    device = first.device
    for h in consts:
        _check_bundle_table(h, device)
    n_tc = bundle_tc_tables(consts)
    ptrs, dims, outs = [], [], []
    for h, d in zip(consts, dens):
        total = torch.empty(batch, device=device, dtype=torch.float32)
        xi = torch.empty((batch, h.n_xi), device=device, dtype=torch.float32)
        outs.append((total, xi))
        tc = isinstance(h, SlabSplitTable)
        ptrs += [a.data_ptr() for a in (h.logm, h.logm_res, h.sec, h.weight,
                                        h.b, h.ct_step0, h.ct_steps)]
        ptrs.append(None if tc else h.ct_off.data_ptr())
        ptrs += [a.data_ptr() for a in (h.col_k, h.col_i0, total, xi)]
        ptrs.append(None if d is None else d.data_ptr())
        dims += [h.n_bins, h.n_centrals, h.n_gauss, h.n_xi, h.n_ct,
                 int(h.auto), h.node_steps if tc else 0]
    n_bins = max(h.n_bins for h in consts)
    n_xi = max(h.n_xi for h in consts)
    _check_smem(_bundle_smem_bytes([(h.n_bins, h.n_xi) for h in consts],
                                   n_tc > 0), "bundle")
    lib = _bundle_lib()
    code = lib.tabcorr_bundle(
        params_ptr, batch, *hod.launch_args(), len(consts),
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(dims))(*dims), fp32_stage_steps(n_bins, n_xi),
        *_stream_args(device))
    _raise_on_error(code, "bundle", lib.tabcorr_cuda_error_string)
    return outs, n_tc


@profiling.spanned("fused.contraction_launch")
def contraction_launch(h: SlabTcTable, ngal):
    """Launch the CUDA contraction kernel on ngal (B, n_bins) float32 on
    the CUDA device of the one-node table ``h``.  Returns (total (B,), xi
    (B, n_xi)); raises on any input the kernel does not take and on any
    launch error."""
    global CONTRACTION_LAUNCHES
    if not ngal.is_cuda:
        raise ValueError("contraction_launch needs CUDA tensors.")
    _check_half(h, ngal.device, "contraction", n_nodes=1)
    if ngal.dim() != 2 or ngal.shape[1] != h.n_bins:
        raise ValueError(f"ngal must be (B, {h.n_bins}), got "
                         f"{tuple(ngal.shape)}.")
    _check_tensor(ngal, h.b.device, torch.float32, "ngal")
    stage_steps = _check_smem(fp32_stage_steps(h.n_bins, h.n_xi),
                              "contraction")
    batch = ngal.shape[0]
    if batch >= 2 ** 31:
        raise ValueError("batch too large.")
    device = ngal.device
    total = torch.empty(batch, device=device, dtype=torch.float32)
    xi = torch.empty((batch, h.n_xi), device=device, dtype=torch.float32)
    lib = _bundle_lib()
    code = lib.tabcorr_contraction(
        ngal.data_ptr(), batch, *(a.data_ptr() for a in _half_arrays(h)),
        h.n_ct, h.n_bins, h.n_xi, int(h.auto), stage_steps,
        total.data_ptr(), xi.data_ptr(), *_stream_args(device))
    _raise_on_error(code, "contraction", lib.tabcorr_cuda_error_string)
    CONTRACTION_LAUNCHES += 1
    return total, xi


def shaped(tables, results):
    """Reshape each table's flat xi to (B, *tpcf_shape)."""
    return [(total, xi.reshape((xi.shape[0],) + tuple(t.tpcf_shape)))
            for t, (total, xi) in zip(tables, results)]


NO_GRADIENT = (
    "the kernel-backed predictors (make_predictor(engine='fused'), "
    "make_multi_predictor(engine='bundle')) compute no gradient: "
    "differentiate the plain float64 engine instead, "
    "make_predictor(..., dtype=torch.float64) or "
    "make_multi_predictor(..., dtype=torch.float64)")


class _NoGradient(torch.autograd.Function):
    """The identity on a kernel's output, tied to the tensors it was
    computed from; its backward raises :data:`NO_GRADIENT`, so autograd
    never returns a zero or missing gradient through a kernel."""

    @staticmethod
    def forward(ctx, out, *inputs):
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(NO_GRADIENT)


def refuse_gradient(out, params, *extra):
    """``out`` (a tensor or nested tuples and lists of them) tied through
    :class:`_NoGradient` to every tensor of ``params`` (a dict) and
    ``extra`` that requires a gradient; unchanged where none does."""
    inputs = [v for v in (*params.values(), *extra)
              if torch.is_tensor(v) and v.requires_grad]
    if not inputs or not torch.is_grad_enabled():
        return out

    def tie(x):
        if torch.is_tensor(x):
            return _NoGradient.apply(x, *inputs)
        return type(x)(tie(y) for y in x)

    return tie(out)


def rank_rows(fn, mesh, batch_axis="dp"):
    """``fn(params, *per_row)`` over this rank's rows of a global batch:
    the counterpart of tabcorr_tpu's ``jax.shard_map`` of a kernel over
    ``batch_axis`` (``tabcorr_tpu/ops/fused.py:1009-1020, 1403-1410,
    1971-1978``), with one process per GPU.  Every rank holds the same
    global batch and the tables whole; the wrapper cuts the rank's rows of
    the parameters and of any per-row tensor (None passes through) by
    :func:`~tabcorr_tpu_torch.parallel.mesh.batch_sharding` and calls
    ``fn`` on them, so each rank launches its kernel on its own rows and
    returns them, with no collective.  ``fn`` itself for ``mesh=None``."""
    if mesh is None:
        return fn
    from ..parallel.mesh import batch_sharding

    def on_rank_rows(params, *per_row):
        batch = next(iter(params.values())).shape[0]
        rows = batch_sharding(mesh, batch, batch_axis)
        return fn({k: v[rows] for k, v in params.items()},
                  *(None if x is None else x[rows] for x in per_row))

    return on_rank_rows


def make_fused_bundle_predictor(tables, model, accuracy=None, mesh=None,
                                batch_axis="dp"):
    """One-kernel multi-statistic predictor.

    Parameters
    ----------
    tables : sequence of TableData
        float32 tabulations (auto or cross mode) on one device, sharing the
        model's parameters (their halo binnings may differ).
    model : HodModel
        Any model whose ``supports_fused_engine`` is true
        (:func:`kernel_model`): zheng07 with or without assembly bias is
        evaluated in the kernel; any other model's densities are read by it
        (densities in), every table's from one launch of the occupation
        kernel for the families it evaluates, else from tensor ops.
    accuracy : sequence of str, optional
        One contract per table, 'elementwise' (default) or 'scaled'; it
        picks the table's route on the card (:func:`bundle_routes`), all
        tables in one launch.  A 'scaled' auto table is contracted in
        3xTF32 on the tensor cores (``wgmma`` fed by TMA, from its split
        constants), which meets 1e-6 of the row's largest statistic; every
        other table in FP32 on the CUDA cores, which meets 1e-6 per element,
        with the bits of an all-'elementwise' launch.  On the CPU every
        table runs the plain version.
    mesh : DeviceMesh, optional
        Split the batch over ``batch_axis`` (:func:`rank_rows`): ``f``
        takes the global batch and returns this rank's rows, one launch a
        call and no collective.

    Returns
    -------
    callable
        ``f(params dict of (B,) float32 tensors) -> [(ngal (B,), xi (B,
        *tpcf_shape)), ...]``: the kernel for CUDA tensors, the plain
        version for CPU tensors.
    """
    check_accuracy(accuracy, len(tables))
    device = tables[0].n_h.device
    if any(t.n_h.device != device for t in tables):
        raise ValueError("all tables must be on one device.")
    hod = KernelModel.of(model)
    occ_cen, occ_sat = occupation_functions(model)
    if device.type == "cuda":
        _check_smem(_bundle_smem_bytes(
            [(t.n_bins, t.tpcf_dense.shape[0]) for t in tables], tc=False),
            "bundle")
        consts = bundle_constants(tables, accuracy)
        if hod.family is not None:
            plan = occupation_plan(consts)
    else:
        consts = [bundle_table_constants(t) for t in tables]

    def densities(params):
        """Every table's (n_bins, B) densities on the card: one launch of
        the occupation kernel over the tables' node plan, or tensor ops."""
        if hod.family is not None:
            return occupation_launch(plan, hod.family,
                                     family_columns(params, hod.family),
                                     consts=consts)
        return [kernel_densities(c, t, model, hod, params)
                for c, t in zip(consts, tables)]

    def predict_batch(params):
        _check_params_device(params, device)
        if hod.density_in and device.type == "cpu":
            results = [contraction_plain(c, occupation_density(t, model,
                                                               params))
                       for c, t in zip(consts, tables)]
        elif hod.density_in:
            results = bundle_launch(consts, densities(params), hod)
        elif device.type == "cpu":
            results = bundle_predict_plain(consts, params, occ_cen, occ_sat)
        else:
            results = bundle_launch(consts, _param_matrix(params, hod), hod)
        return refuse_gradient(shaped(tables, results), params)

    return rank_rows(predict_batch, mesh, batch_axis)


def _check_params_device(params, device):
    p_device = next(iter(params.values())).device
    if p_device != device:
        raise ValueError(f"parameters on {p_device}, tables on {device}.")


def _param_matrix(params, hod: KernelModel):
    return torch.stack([params[k] for k in hod.param_names], dim=1)


def make_fused_contraction(table: TableData, accuracy="elementwise"):
    """Fused contraction ``ngal (B, n_bins) -> (total (B,), xi (B,
    n_xi))`` for one table: the kernel for CUDA tensors, the plain version
    for CPU tensors.  A float32 table runs full FP32 under both contracts;
    a bfloat16 table (bfloat16 densities and results) the BF16 tensor-core
    kernel under both, as tabcorr_tpu's 'scaled' tier collapses to the
    same bfloat16 products on a bfloat16 table."""
    check_accuracy([accuracy], 1)
    if table.tpcf_dense.dtype == torch.bfloat16:
        c = bf16_table_constants(table)
        if c.bt.is_cuda:
            return lambda ngal: contraction_bf16_launch(c, ngal)
        return lambda ngal: contraction_bf16_plain(c, ngal)
    if table.n_h.device.type == "cuda":
        half = slab_tc_table_constants(table, 1)
        return lambda ngal: contraction_launch(half, ngal)
    dense = bundle_table_constants(table)
    return lambda ngal: contraction_plain(dense, ngal)


def bf16_densities(table: TableData, model, params):
    """The bfloat16 routes' densities (B, n_bins): the parameters rounded
    to bfloat16, the occupation in tensor ops (float32 on a bfloat16
    table, :func:`~.predict.mean_occupation`) times n_h, rounded once to
    bfloat16."""
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    return occupation_density(table, model, params).to(torch.bfloat16)


def occupation_density(table: TableData, model, params):
    """The per-bin density n[b, i] = <N>(params_b) n_h[i] (B, n_bins) in
    tensor ops, ``_OCC_CHUNK`` rows at a time: the plain version of the
    occupation kernel (:func:`occupation_launch`), and the densities of a
    model it does not evaluate."""
    occ_cen, occ_sat = occupation_functions(model)
    batch = next(iter(params.values())).shape[0]
    return torch.cat([
        mean_occupation(table, occ_cen, occ_sat,
                        {k: v[lo:lo + _OCC_CHUNK] for k, v in params.items()})
        * table.n_h for lo in range(0, batch, _OCC_CHUNK)])


@functools.cache
def _occupation_lib():
    """Build (first call only) and bind the entry point of occupation.cu."""
    lib = load_library("occupation", KERNEL_SOURCES["occupation"])
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.tabcorr_occupation.argtypes = (
        [vp] + [i] * 6 + [d] * 4 + [vp] + [i] * 3 + [vp] * 7 + [i] * 6 +
        [ctypes.POINTER(i)] * 2 + [ctypes.POINTER(vp), i, i, vp])
    lib.tabcorr_occupation.restype = i
    lib.tabcorr_cuda_error_string.argtypes = [i]
    lib.tabcorr_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _spline_on(abscissa, device):
    """Tinker13's quiescent-fraction map on ``device`` as the occupation
    kernel reads it: float64, the breaks and then the coefficients; and
    the coefficients' shape (n_seg, n_coef, n_pts)."""
    breaks, coeffs = tinker13_fq_spline_map(abscissa)
    flat = np.concatenate([breaks, coeffs.ravel()])
    return (torch.tensor(flat, dtype=torch.float64, device=device),
            coeffs.shape)


def family_columns(params, fam: OccupationFamily):
    """The occupation kernel's (n_params, B) float32 parameter matrix."""
    return torch.stack([params[k] for k in fam.param_names])


@dataclasses.dataclass(frozen=True, eq=False)
class OccupationPlan:
    """The node plan of the occupation kernel: the work of one launch for
    the tables it serves (one table, a grid's stacked table, or every
    table of a bundle), built once on the host (:func:`occupation_plan`),
    as tensors on the tables' device.

    A *unit* is one mass bin's n_gauss quadrature nodes, each the exact
    (float32 node, float32 residual) pair of the tables.  Bins whose nodes
    are identical bit for bit share a unit; nothing is merged by
    tolerance.  Units are sorted by their first node's float64 abscissa
    (node + residual), ascending.  ``node``, ``res`` (n_units, n_gauss)
    float32 hold them; unit u serves the outputs ``first_out[u]`` to
    ``first_out[u + 1]`` ((n_units + 1,) int32; ``max_outs`` at most,
    itself at most ``_OCC_MAX_OUTS``; in (table, bin) order), output o
    being bin ``out_bin[o]`` of table ``out_table[o]`` (int32), with its
    secondary percentile ``out_sec[o]`` and weights ``weight[o]``
    (n_gauss,) float32, quad_weight * n_h.  ``n_bins`` and ``n_centrals``
    give each table's bins (its centrals first); ``sources`` the
    quadrature tensors' addresses it was built from (:meth:`built_from`).
    """

    n_bins: tuple
    n_centrals: tuple
    node: torch.Tensor
    res: torch.Tensor
    first_out: torch.Tensor
    out_bin: torch.Tensor
    out_table: torch.Tensor
    out_sec: torch.Tensor
    weight: torch.Tensor
    max_outs: int
    sources: tuple

    @property
    def n_units(self):
        return self.node.shape[0]

    @property
    def n_gauss(self):
        return self.node.shape[1]

    @property
    def n_out(self):
        return self.out_bin.shape[0]

    @property
    def n_evaluated(self):
        """(bin, node) pairs of the tables: the evaluations without the
        plan."""
        return sum(self.n_bins) * self.n_gauss

    @property
    def n_distinct(self):
        """Nodes the kernel evaluates per row."""
        return self.n_units * self.n_gauss

    def built_from(self, consts):
        """Whether the plan was built from these constants (their
        quadrature tensors, in this order)."""
        return tuple(_plan_source(c) for c in consts) == self.sources


def _plan_source(c):
    return tuple(a.data_ptr() for a in (c.logm, c.logm_res, c.sec, c.weight))


def occupation_plan(consts) -> OccupationPlan:
    """The node plan (:class:`OccupationPlan`) of the tables whose
    constants are ``consts`` (each with the quadrature ``logm``,
    ``logm_res``, ``sec``, ``weight`` (n_bins, n_gauss) float32 and
    ``n_bins``, ``n_centrals``: :class:`SlabTcTable`, :class:`GridTable`,
    :class:`BundleTable`), on their device."""
    consts = list(consts)
    if not 1 <= len(consts) <= _MAX_TABLES:
        raise ValueError(f"a node plan serves 1 to {_MAX_TABLES} tables.")
    device = consts[0].logm.device
    n_gauss = consts[0].logm.shape[1]
    if any(c.logm.device != device or c.logm.shape[1] != n_gauss
           for c in consts):
        raise ValueError("the tables of a node plan share a device and a "
                         "node count.")
    units = {}          # (node bytes, residual bytes) -> [(t, bin)]
    arrays = []
    for t, c in enumerate(consts):
        logm, res, sec, weight = (a.cpu().numpy() for a in (
            c.logm, c.logm_res, c.sec, c.weight))
        arrays.append((sec[:, 0], weight))
        for i in range(c.n_bins):
            key = (logm[i].tobytes(), res[i].tobytes())
            units.setdefault(key, (logm[i], res[i], []))[2].append((t, i))
    order = sorted(units, key=lambda k: (
        float(np.float64(units[k][0][0]) + np.float64(units[k][1][0])), k))
    node, res, first, outs = [], [], [0], []
    for key in order:
        lm, rs, bins = units[key]
        for o in range(0, len(bins), _OCC_MAX_OUTS):
            chunk = bins[o:o + _OCC_MAX_OUTS]
            node.append(lm)
            res.append(rs)
            outs += chunk
            first.append(len(outs))
    out_table = np.array([t for t, _ in outs], np.int32)
    out_bin = np.array([i for _, i in outs], np.int32)
    out_sec = np.array([arrays[t][0][i] for t, i in outs], np.float32)
    weight = np.array([arrays[t][1][i] for t, i in outs], np.float32)
    return OccupationPlan(
        n_bins=tuple(c.n_bins for c in consts),
        n_centrals=tuple(c.n_centrals for c in consts),
        node=_tensor(np.array(node), device),
        res=_tensor(np.array(res), device),
        first_out=_tensor(first, device, np.int32),
        out_bin=_tensor(out_bin, device, np.int32),
        out_table=_tensor(out_table, device, np.int32),
        out_sec=_tensor(out_sec, device),
        weight=_tensor(weight.reshape(-1, n_gauss), device),
        max_outs=int(np.diff(first).max()),
        sources=tuple(_plan_source(c) for c in consts))


def occupation_units_per_block(n_units, batch):
    """Units of the node plan per block of the occupation kernel: the
    most that keep ``_OCC_TARGET_BLOCKS`` blocks, at least one."""
    row_blocks = max(1, -(-batch // _OCC_ROWS))
    return max(1, min(n_units, n_units * row_blocks // _OCC_TARGET_BLOCKS))


def occupation_outputs(plan: OccupationPlan, batch, bin_major, device):
    """The densities one launch over ``plan`` writes, uninitialised: per
    table (n_bins, B) float32 (``bin_major``) or (B, n_bins)."""
    return [torch.empty((nb, batch) if bin_major else (batch, nb),
                        device=device, dtype=torch.float32)
            for nb in plan.n_bins]


def occupation_launch(plan: OccupationPlan, fam: OccupationFamily, pcols,
                      bin_major=True, consts=None):
    """Launch the CUDA occupation kernel once (``csrc/occupation.cu``) over
    the node plan ``plan`` (:func:`occupation_plan`): the densities of
    every table the plan serves.

    ``pcols`` is the (n_params, B) float32 parameter matrix of ``fam``
    (:func:`family_columns`) on the plan's CUDA device.  ``consts``, where
    given, are the constants the densities are for: the plan must have been
    built from them.  Returns one float32 tensor per table of the plan,
    n[b, i] (n_bins, B) bin-major (what model code 2 reads) or (B, n_bins)
    (the contraction kernel's input).  Raises on any input the kernel does
    not take and on any launch error.  The plain version is
    :func:`occupation_density`.  The ``fused.occupation_launch`` span
    counts the batch (``rows``) and the plan's distinct abscissae a row
    (``abscissae``, :attr:`OccupationPlan.n_distinct`).
    """
    global OCCUPATION_LAUNCHES
    with profiling.span("fused.occupation_launch") as sp:
        dens = _occupation_launch(plan, fam, pcols, bin_major, consts)
        if sp:
            sp.counts["rows"] = pcols.shape[1]
            sp.counts["abscissae"] = plan.n_distinct
    OCCUPATION_LAUNCHES += 1
    return dens


def _occupation_launch(plan, fam, pcols, bin_major, consts):
    if not isinstance(plan, OccupationPlan):
        raise ValueError("the occupation kernel reads a node plan "
                         "(occupation_plan).")
    if consts is not None and not plan.built_from(consts):
        raise ValueError("the node plan was not built from these "
                         "constants.")
    if not pcols.is_cuda:
        raise ValueError("the kernels need CUDA tensors.")
    n_params = len(fam.param_names)
    if pcols.dtype != torch.float32 or pcols.dim() != 2 or \
            pcols.shape[0] != n_params:
        raise ValueError(f"params must be ({n_params}, B) float32, got "
                         f"{tuple(pcols.shape)} {pcols.dtype}.")
    if not pcols.is_contiguous():
        raise ValueError("params must be contiguous.")
    batch = pcols.shape[1]
    if batch >= 2 ** 31:
        raise ValueError("batch too large.")
    device = pcols.device
    for a in (plan.node, plan.res, plan.out_sec, plan.weight):
        _check_tensor(a, device, torch.float32, "node plan")
    for a in (plan.first_out, plan.out_bin, plan.out_table):
        _check_tensor(a, device, torch.int32, "node plan")
    spline, (n_seg, n_coef, n_pts) = None, (0, 0, 0)
    if fam.abscissa:
        spline, (n_seg, n_coef, n_pts) = _spline_on(fam.abscissa, device)
    dens = occupation_outputs(plan, batch, bin_major, device)
    n_tables = len(dens)
    lib = _occupation_lib()
    code = lib.tabcorr_occupation(
        pcols.data_ptr(), batch, n_params, fam.family, int(fam.decorated),
        int(fam.modulate), fam.sfr, fam.threshold, fam.a, fam.log_h,
        fam.split, None if spline is None else spline.data_ptr(), n_seg,
        n_coef, n_pts, *(a.data_ptr() for a in (
            plan.node, plan.res, plan.first_out, plan.out_bin,
            plan.out_table, plan.out_sec, plan.weight)),
        plan.n_units, plan.n_out, plan.max_outs, plan.n_gauss,
        occupation_units_per_block(plan.n_units, batch), n_tables,
        (ctypes.c_int * n_tables)(*plan.n_bins),
        (ctypes.c_int * n_tables)(*plan.n_centrals),
        (ctypes.c_void_p * n_tables)(*(d.data_ptr() for d in dens)),
        int(bin_major), *_stream_args(device))
    _raise_on_error(code, "occupation", lib.tabcorr_cuda_error_string)
    return dens


def kernel_densities(c, table: TableData, model, hod: KernelModel, params,
                     bin_major=True):
    """The densities of a densities-in launch on the card, (n_bins, B)
    float32 (``bin_major``; else (B, n_bins)): the occupation kernel over
    the constants' node plan (``c.occupation_plan``) where it evaluates
    the model (``hod.family``), else the model's occupation in tensor ops
    (:func:`occupation_density`)."""
    if hod.family is not None:
        return occupation_launch(c.occupation_plan, hod.family,
                                 family_columns(params, hod.family),
                                 bin_major, consts=[c])[0]
    dens = occupation_density(table, model, params)
    return dens.t().contiguous() if bin_major else dens


def make_fused_predictor(table: TableData, model, accuracy="elementwise"):
    """Batched predictor ``f(params dict of (B,)) -> (ngal, xi (B,
    *tpcf_shape))`` for one table and any model.  float32: the densities
    (on the card the occupation kernel's where it evaluates the model,
    else :func:`occupation_density` in tensor ops), then the contraction
    kernel.  bfloat16: tabcorr_tpu's route (``tabcorr_tpu/ops/fused.py:
    make_fused_predictor``), the parameters rounded to bfloat16, the
    densities in tensor ops (its XLA occupation) rounded to bfloat16, then
    the bfloat16 contraction kernel; ngal and xi bfloat16."""
    check_accuracy([accuracy], 1)
    device = table.n_h.device
    if table.tpcf_dense.dtype == torch.bfloat16:
        contract_bf16 = make_fused_contraction(table, accuracy)

        def contract(params):
            return contract_bf16(bf16_densities(table, model, params))
    elif device.type == "cuda":
        half = slab_tc_table_constants(table, 1)
        hod = KernelModel(code=DENSITY_IN, family=OccupationFamily.of(model))
        if hod.family is not None:
            half.occupation_plan     # built once, here

        def contract(params):
            return contraction_launch(half, kernel_densities(
                half, table, model, hod, params, bin_major=False))
    else:
        dense = bundle_table_constants(table)

        def contract(params):
            return contraction_plain(dense,
                                     occupation_density(table, model, params))

    def predict_batch(params):
        total, xi = contract(params)
        return refuse_gradient(
            (total, xi.reshape((xi.shape[0],) + tuple(table.tpcf_shape))),
            params)

    return predict_batch


# ----------------------------------------------------------------------
# Contraction (B3) on bfloat16 tables: constants, plain version, kernel
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Bf16Table:
    """The matrix of one bfloat16 table (or a stacked grid) for the
    bfloat16 contraction kernel and its plain version.

    ``bt`` (n_cols, kp) bfloat16 holds one row of K = bins per column of
    the product t = n F: auto ``bt[k * ni + i, j] = F[k, i, j]`` with
    ``ni = kp``; cross ``bt[k, j] = F[k, j]``, the statistics rounded up
    to 8.  Bins are padded to ``kp`` with zeros: a multiple of 32 up to
    160 bins (the registers kernel), else of 64 (the streamed kernel).
    ``image`` (n_tiles, cols * kp) is what the kernel copies: column tiles
    of ``cols`` columns (:func:`bf16_geometry`), each tile's bins K-major
    in the swizzle its wgmma descriptors read (:func:`bf16_tile_offsets`).
    The registers kernel's tiles are consecutive columns of ``bt``; the
    streamed kernel's start with a column of ones (sum_j n_j), then the
    statistics (cross) or, from column 64, ``bt`` (auto).  The values are
    the table's bfloat16 values, rearranged.
    """

    auto: bool
    n_bins: int
    n_xi: int
    ni: int
    kp: int
    bt: torch.Tensor
    cols: int
    n_tiles: int
    image: torch.Tensor

    @property
    def streamed(self):
        return self.kp > _BF16_REG_BINS


def bf16_geometry(auto, n_bins, n_xi):
    """(kp, cols, n_tiles) of the bfloat16 contraction on a table: padded
    bins, columns of a tile (the wgmma N) and column tiles.  Registers
    kernel (n_bins <= 160): auto tiles of 128 / kp statistics up to 64
    bins, one at 96, half a statistic at 128 and 160; cross tiles of 64
    statistics.  Streamed kernel: cross tiles of 64 or 128 columns (the
    ones column and the statistics), auto tiles of 64 (one for the ones
    column, kp / 64 a statistic)."""
    if n_bins <= _BF16_REG_BINS:
        kp = _round_up(n_bins, 32)
        if not auto:
            return kp, 64, -(-n_xi // 64)
        if kp >= 128:
            return kp, kp // 2, 2 * n_xi
        per = max(1, 128 // kp)
        return kp, per * kp, -(-n_xi // per)
    kp = _round_up(n_bins, 64)
    if auto:
        return kp, 64, 1 + n_xi * (kp // 64)
    cols = 64 if n_xi + 1 <= 64 else 128
    return kp, cols, -(-(n_xi + 1) // cols)


def bf16_tile_offsets(cols, kp):
    """(cols, kp) int64: the element offset of (column n, bin j) in a
    column tile's image, as the kernel's wgmma descriptors read it
    (csrc/hopper.cuh:desc_kmajor): 64-bin chunks, chunk c at cols * 64 c
    elements, each column 128 bytes of K in the 128-byte swizzle (the
    16-byte units of a byte address XORed with bits 7-9); a last 32-bin
    chunk in the 64-byte swizzle (64 bytes a column, bits 7-8)."""
    n = np.arange(cols)[:, None]
    j = np.arange(kp)[None, :]
    start = (j // 64) * 64
    row_bytes = 2 * np.minimum(64, kp - start)
    byte = n * row_bytes + 2 * (j - start)
    byte = byte ^ (((byte >> 7) & (row_bytes // 16 - 1)) << 4)
    return (cols * start + byte // 2).astype(np.int64)


def bf16_table_constants(table: TableData) -> Bf16Table:
    """The :class:`Bf16Table` of a bfloat16 table, on its device."""
    dense = table.tpcf_dense
    if dense.dtype != torch.bfloat16:
        raise ValueError("the bfloat16 contraction takes bfloat16 tables.")
    auto = table.mode == AUTO
    n_xi, nb = dense.shape[0], table.n_bins
    kp, cols, n_tiles = bf16_geometry(auto, nb, n_xi)
    if auto:
        ni = kp
        bt = dense.new_zeros((n_xi, ni, kp))
        bt[:, :nb, :nb] = dense
        bt = bt.reshape(n_xi * ni, kp)
    else:
        ni = 0
        bt = dense.new_zeros((_round_up(n_xi, 8), kp))
        bt[:n_xi, :nb] = dense
    columns = bt.new_zeros((n_tiles * cols, kp))
    if kp <= _BF16_REG_BINS:
        used = min(bt.shape[0], columns.shape[0])
        columns[:used] = bt[:used]
    else:
        columns[0, :nb] = 1
        first, used = (64, n_xi * ni) if auto else (1, n_xi)
        columns[first:first + used] = bt[:used]
    offsets = torch.as_tensor(bf16_tile_offsets(cols, kp).ravel(),
                              device=bt.device)
    image = bt.new_zeros((n_tiles, cols * kp))
    image[:, offsets] = columns.reshape(n_tiles, cols * kp)
    return Bf16Table(auto=auto, n_bins=nb, n_xi=n_xi, ni=ni, kp=kp,
                     bt=bt.contiguous(), cols=cols, n_tiles=n_tiles,
                     image=image)


def bf16_launch_config(c: Bf16Table):
    """(ring slots, statistics a staging window, dynamic shared memory
    bytes) of a launch of the bfloat16 contraction on ``c``
    (csrc/bf16.cu:smem_bytes).  A slot holds a column tile (registers
    kernel) or a 64-bin chunk of 128 density rows and of a tile
    (streamed); each consumer warpgroup stages its 128 (64) rows' results
    in two windows.  A streamed block takes at most half an SM's shared
    memory where that leaves 3 slots."""
    rows = 64 if c.streamed else 128
    if c.streamed:
        slot = 128 * 128 + c.cols * 128
        win = (c.n_xi if c.n_tiles == 1 else c.cols) if not c.auto else \
            min(c.n_xi, _BF16_WIN)
    else:
        slot = _round_up(c.cols * c.kp * 2, 1024)
        win = min(c.n_xi, _BF16_WIN)
    staging = 2 * _BF16_CONSUMERS * rows * win * 2

    def slots(budget):
        return min(_BF16_MAX_STAGES, (budget - 1024 - staging) // (slot + 16))
    stages = slots(_SMEM_LIMIT)
    if c.streamed and slots(_BF16_HALF_SM) >= 3:
        stages = slots(_BF16_HALF_SM)
    return stages, win, 1024 + stages * (slot + 16) + staging


def contraction_bf16_takes(n_bins, n_xi) -> bool:
    """Whether the bfloat16 contraction kernel takes a table of this
    shape."""
    return (n_bins <= _BF16_MAX_BINS and
            n_xi * _round_up(n_bins, 64) < 2 ** 31)


def contraction_bf16_plain(c: Bf16Table, ngal):
    """The bfloat16 contraction kernel's plain version: ngal (B, n_bins)
    bfloat16 -> (total (B,), xi (B, n_xi)) bfloat16, the same inputs
    widened to float64, contracted, and rounded to bfloat16 at the end;
    chunks of rows keep the float64 product under ``_BF16_PLAIN_BYTES``."""
    f = c.bt.double()
    rows = max(1, _BF16_PLAIN_BYTES // (8 * f.shape[0]))
    totals, xis = [], []
    for lo in range(0, ngal.shape[0], rows):
        n = torch.nn.functional.pad(ngal[lo:lo + rows].double(),
                                    (0, c.kp - c.n_bins))
        total = n.sum(dim=-1)
        t = n @ f.T
        if c.auto:
            q = torch.sum(t.reshape(-1, c.n_xi, c.ni) *
                          n[:, None, :c.ni], dim=-1)
            xi = q / (total * total)[:, None]
        else:
            xi = t[:, :c.n_xi] / total[:, None]
        totals.append(total.to(torch.bfloat16))
        xis.append(xi.to(torch.bfloat16))
    return torch.cat(totals), torch.cat(xis)


@functools.cache
def _bf16_lib():
    """Build (first call only) and bind the entry point of bf16.cu."""
    lib = load_library("bf16", KERNEL_SOURCES["bf16"])
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tabcorr_contraction_bf16.argtypes = ([vp] + [i] * 3 + [vp] +
                                             [i] * 6 + [vp, vp, i, vp])
    lib.tabcorr_contraction_bf16.restype = i
    lib.tabcorr_cuda_error_string.argtypes = [i]
    lib.tabcorr_cuda_error_string.restype = ctypes.c_char_p
    return lib


@profiling.spanned("fused.contraction_bf16_launch")
def contraction_bf16_launch(c: Bf16Table, ngal):
    """Launch the bfloat16 contraction kernel (BF16 ``wgmma`` fed by TMA,
    ``csrc/bf16.cu``) on ngal (B, n_bins) bfloat16 on the CUDA device of
    ``c``.  Returns (total (B,), xi (B, n_xi)) bfloat16; raises on any
    input the kernel does not take and on any launch error.  The streamed
    kernel reads the densities through a TMA tensor map, whose rows must
    be 16-byte aligned: a table whose bins are not a multiple of 8 has
    its densities padded with zero bins first."""
    global CONTRACTION_BF16_LAUNCHES
    if not isinstance(c, Bf16Table):
        raise ValueError("the bfloat16 contraction reads a Bf16Table "
                         "(bf16_table_constants).")
    if c.image.shape != (c.n_tiles, c.cols * c.kp) or (
            c.kp, c.cols, c.n_tiles) != bf16_geometry(c.auto, c.n_bins,
                                                      c.n_xi):
        raise ValueError("bfloat16 constants not in the kernel's layout "
                         "(bf16_table_constants).")
    if not ngal.is_cuda:
        raise ValueError("contraction_bf16_launch needs CUDA tensors.")
    _check_tensor(c.image, ngal.device, torch.bfloat16, "bfloat16 constants")
    if ngal.dim() != 2 or ngal.shape[1] != c.n_bins:
        raise ValueError(f"ngal must be (B, {c.n_bins}), got "
                         f"{tuple(ngal.shape)}.")
    _check_tensor(ngal, ngal.device, torch.bfloat16, "ngal")
    if not contraction_bf16_takes(c.n_bins, c.n_xi):
        raise ValueError("table too large for the bfloat16 contraction "
                         f"kernel (at most {_BF16_MAX_BINS} bins).")
    batch = ngal.shape[0]
    if batch >= 2 ** 31:
        raise ValueError("batch too large.")
    device = ngal.device
    total = torch.empty(batch, device=device, dtype=torch.bfloat16)
    xi = torch.empty((batch, c.n_xi), device=device, dtype=torch.bfloat16)
    if c.streamed and c.n_bins % 8:
        ngal = torch.nn.functional.pad(ngal, (0, _round_up(c.n_bins, 8) -
                                              c.n_bins))
    elif ngal.data_ptr() % 16:
        ngal = ngal.clone()
    stages, win, _ = bf16_launch_config(c)
    lib = _bf16_lib()
    code = lib.tabcorr_contraction_bf16(
        ngal.data_ptr(), batch, ngal.shape[1], c.kp, c.image.data_ptr(),
        c.n_xi, int(c.auto), c.cols, c.n_tiles, stages, win,
        total.data_ptr(), xi.data_ptr(), *_stream_args(device))
    _raise_on_error(code, "bfloat16 contraction",
                    lib.tabcorr_cuda_error_string)
    CONTRACTION_BF16_LAUNCHES += 1
    return total, xi


# ----------------------------------------------------------------------
# Grid (B2): constants, plain version, kernel
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GridTable:
    """Host-built constants of a stacked Interpolator grid (one halo
    binning), as tensors on one device.

    ``logm``, ``logm_res``, ``sec`` and ``weight`` are the quadrature as in
    :class:`BundleTable`.  ``pair_i``/``pair_j`` (int32, auto mode) list
    the packed pairs i <= j in ``np.triu_indices`` order; cross mode
    contracts the densities themselves (``npair == n_bins``).  ``fp`` is
    the packed matrix (k_pad, c_pad), zero-padded, with node-major
    columns: ``fp[p, node * nxp + k] = (2 - delta_ij) F_node[k, i_p, j_p]``
    (auto) or ``F_node[k, p]`` (cross), ``nxp`` the statistic count
    rounded up to 4 so each thread's 4 columns share one node.
    """

    auto: bool
    n_bins: int
    n_centrals: int
    n_nodes: int
    n_xi: int
    nxp: int
    npair: int
    logm: torch.Tensor
    logm_res: torch.Tensor
    sec: torch.Tensor
    weight: torch.Tensor
    pair_i: torch.Tensor
    pair_j: torch.Tensor
    fp: torch.Tensor

    @property
    def n_gauss(self):
        return self.logm.shape[1]

    @property
    def k_pad(self):
        return self.fp.shape[0]

    @property
    def c_pad(self):
        return self.fp.shape[1]

    @functools.cached_property
    def occupation_plan(self):
        """The occupation kernel's node plan of this table
        (:func:`occupation_plan`), built at its first use."""
        return occupation_plan([self])


def grid_layout_for(table: TableData):
    """The layout tabcorr_tpu's 'auto' picks for ``table``: 'packed'
    where the packed pair row fits 8192 lanes (every published table),
    else 'slab'."""
    return _grid_layout(table.n_bins, table.mode)


def _grid_layout(n_bins, mode):
    npair_pad = _round_up(n_bins * (n_bins + 1) // 2, 128)
    return "packed" if mode != AUTO or npair_pad <= 8192 else "slab"


def grid_fits(n_bins, mode, n_xi) -> bool:
    """Whether the grid kernel takes a grid of this shape (the packed
    layout, and one block's densities in shared memory)."""
    return (_grid_layout(n_bins, mode) == "packed" and
            grid_block_rows(n_bins, n_xi) is not None)


def grid_table_constants(table: TableData, n_nodes) -> GridTable:
    """Constants of the stacked grid ``table`` (every node's rows stacked
    on the statistic axis, node-major)."""
    nb = table.n_bins
    auto = table.mode == AUTO
    dense = table.tpcf_dense.cpu().numpy().astype(np.float32)
    if dense.shape[0] % n_nodes:
        raise ValueError("Stacked row count must be divisible by n_nodes.")
    n_xi = dense.shape[0] // n_nodes
    dense = dense.reshape((n_nodes, n_xi) + dense.shape[1:])
    if auto:
        idx_i, idx_j = np.triu_indices(nb)
        prefac = np.where(idx_i == idx_j, 1.0, 2.0).astype(np.float32)
        packed = dense[:, :, idx_i, idx_j] * prefac      # (nodes, n_xi, np)
    else:
        idx_i = idx_j = np.zeros(0, np.int64)
        packed = dense                                    # (nodes, n_xi, nb)
    npair = packed.shape[2]
    nxp = _round_up(n_xi, 4)
    blocks = np.zeros((npair, n_nodes, nxp), np.float32)
    blocks[:, :, :n_xi] = packed.transpose(2, 0, 1)
    fp = np.zeros((_round_up(npair, _KT), _round_up(n_nodes * nxp, _CT)),
                  np.float32)
    fp[:npair, :n_nodes * nxp] = blocks.reshape(npair, -1)
    device = table.n_h.device
    return GridTable(auto=auto, n_bins=nb, n_centrals=table.n_centrals,
                     n_nodes=n_nodes, n_xi=n_xi, nxp=nxp, npair=npair,
                     pair_i=_tensor(idx_i, device, np.int32),
                     pair_j=_tensor(idx_j, device, np.int32),
                     fp=_tensor(fp, device), **_quadrature_arrays(table))


def grid_predict_plain(g: GridTable, params, node_weights, occupation_cen,
                       occupation_sat):
    """The grid kernel's plain version, ``_PLAIN_CHUNK`` batch rows at a
    time (bounding the (chunk, npair) pair weights and the (chunk,
    n_nodes, n_xi) per-node statistics).

    The densities and pair weights are float32, as in the kernel; the
    contraction over the pairs and the node fold run in float64 and round
    to float32 at the end.  A float32 matrix product sums the 1830 pairs
    of the 64-node grid in long float32 runs and lands up to ~3e-6
    (scaled) from the float64 result; the grid kernel sums in float64
    (csrc/grid.cu).

    Returns (total (B,), xi): with ``node_weights`` (B, n_nodes) the
    folded (B, n_xi), else the per-node (B, n_nodes, n_xi).
    """
    batch = next(iter(params.values())).shape[0]
    fp = g.fp[:g.npair, :g.n_nodes * g.nxp].double()
    outs = []
    for lo in range(0, batch, _PLAIN_CHUNK):
        p = {k: v[lo:lo + _PLAIN_CHUNK, None, None] for k, v in params.items()}
        ngal = _plain_ngal(g, p, occupation_cen, occupation_sat)
        outs.append(_grid_chunk(g, fp, ngal, None if node_weights is None
                                else node_weights[lo:lo + _PLAIN_CHUNK]))
    return torch.cat([t for t, _ in outs]), torch.cat([x for _, x in outs])


def grid_contract_plain(g: GridTable, ngal, node_weights=None):
    """The plain version of a densities-in grid launch: the contraction of
    :func:`grid_predict_plain` on given float32 densities ngal (B,
    n_bins), ``_PLAIN_CHUNK`` rows at a time."""
    fp = g.fp[:g.npair, :g.n_nodes * g.nxp].double()
    outs = [_grid_chunk(g, fp, ngal[lo:lo + _PLAIN_CHUNK],
                        None if node_weights is None else
                        node_weights[lo:lo + _PLAIN_CHUNK])
            for lo in range(0, ngal.shape[0], _PLAIN_CHUNK)]
    return torch.cat([t for t, _ in outs]), torch.cat([x for _, x in outs])


def _grid_chunk(g: GridTable, fp, ngal, node_weights):
    """(total, xi) of one chunk of float32 densities: float32 pair weights,
    the contraction with ``fp`` (the packed matrix in float64) and the
    fold in float64, rounded to float32 at the end."""
    total = _total(ngal)
    if g.auto:
        w = ngal[:, g.pair_i.long()] * ngal[:, g.pair_j.long()]
    else:
        w = ngal
    t = (w.double() @ fp).reshape(-1, g.n_nodes, g.nxp)[:, :, :g.n_xi]
    den = total * total if g.auto else total
    if node_weights is None:
        return total, t.float() / den[:, None, None]
    # Elementwise, so a NaN weight reaches every xi of its row.
    nw = node_weights.double()
    return total, torch.sum(nw[:, :, None] * t, dim=1).float() / den[:, None]


@functools.cache
def _grid_lib():
    """Build (first call only) and bind the entry point of grid.cu."""
    lib = load_library("grid", KERNEL_SOURCES["grid"])
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tabcorr_grid.argtypes = ([vp, vp, i, i, i, ctypes.c_double, vp,
                                  vp, vp, vp, i, i, i, vp, vp, i, vp] +
                                 [i] * 7 + [vp, vp, i, vp])
    lib.tabcorr_grid.restype = i
    lib.tabcorr_cuda_error_string.argtypes = [i]
    lib.tabcorr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _grid_smem_bytes(tb, n_bins, nxp) -> int:
    """Dynamic shared memory of one block of csrc/grid.cu's grid kernel
    with ``tb`` rows (the layout ``smem_bytes`` carves): the double-buffered
    float64 pair weights and the float64 fold sums, then the float32 ring
    of Fp tiles, densities and row terms."""
    return (8 * (2 * _KT * tb + tb * nxp) +
            4 * (_GRID_STAGES[tb] * _KT * _TC_BS + _round_up(n_bins, _KT) * tb +
                 _ROW_TERMS * tb))


def grid_block_rows(n_bins, n_xi):
    """Batch rows per block of the grid kernel for a table of this shape:
    64, or 32 or 16 where more rows' densities do not fit in shared
    memory; None where none fits."""
    nxp = _round_up(n_xi, 4)
    for tb in _GRID_BLOCK_ROWS:
        if _grid_smem_bytes(tb, n_bins, nxp) <= _SMEM_LIMIT:
            return tb
    return None


@profiling.spanned("fused.grid_launch")
def grid_launch(g: GridTable, pmat, node_weights=None, hod=KernelModel()):
    """Launch the CUDA grid kernel once.

    ``pmat`` is the float32 parameter matrix of the model ``hod`` (zheng07
    by default; see :func:`bundle_launch`) on the grid's CUDA device, or
    for densities in (``hod.code`` 2) the (n_bins, B) float32 densities
    (:func:`kernel_densities`); ``node_weights`` (B, n_nodes) float32
    folds the nodes (returns xi (B, n_xi)), None returns the per-node xi
    (B, n_nodes, n_xi).  Raises on any input the kernel does not take and
    on any launch error.
    """
    global GRID_LAUNCHES
    total, xi = _check_grid_launch(g, pmat, node_weights, hod)
    tb = grid_block_rows(g.n_bins, g.n_xi)
    if tb is None:
        raise ValueError(f"{g.n_bins} bins are too many for the grid "
                         "kernel's shared memory.")
    lib = _grid_lib()
    code = lib.tabcorr_grid(*_grid_entry_args(g, pmat, node_weights, hod,
                                              tb, total, xi))
    _raise_on_error(code, "grid", lib.tabcorr_cuda_error_string)
    GRID_LAUNCHES += 1
    return total, xi


def _check_grid_launch(g: GridTable, pmat, node_weights, hod):
    """Raise on inputs the grid kernel does not take; else the launch's
    outputs (total (B,), xi), allocated."""
    batch = _check_params(pmat, hod, g.n_bins)
    device = pmat.device
    for a in (g.logm, g.logm_res, g.sec, g.weight, g.fp):
        _check_tensor(a, device, torch.float32, "grid constants")
    for a in (g.pair_i, g.pair_j):
        _check_tensor(a, device, torch.int32, "pair indices")
    if node_weights is not None:
        _check_tensor(node_weights, device, torch.float32, "node weights")
        if tuple(node_weights.shape) != (batch, g.n_nodes):
            raise ValueError(f"node weights must be ({batch}, {g.n_nodes}), "
                             f"got {tuple(node_weights.shape)}.")
    total = torch.empty(batch, device=device, dtype=torch.float32)
    shape = ((batch, g.n_xi) if node_weights is not None else
             (batch, g.n_nodes, g.n_xi))
    return total, torch.empty(shape, device=device, dtype=torch.float32)


def _grid_entry_args(g: GridTable, pmat, node_weights, hod, tb, total, xi):
    """The C entry point's arguments, ``tb`` rows per block."""
    device = pmat.device
    return (pmat.data_ptr(),
            None if node_weights is None else node_weights.data_ptr(),
            total.shape[0], *hod.launch_args(), g.logm.data_ptr(),
            g.logm_res.data_ptr(), g.sec.data_ptr(), g.weight.data_ptr(),
            g.n_bins, g.n_centrals, g.n_gauss, g.pair_i.data_ptr(),
            g.pair_j.data_ptr(), g.npair, g.fp.data_ptr(), g.k_pad, g.c_pad,
            g.n_nodes, g.n_xi, g.nxp, int(g.auto), tb,
            total.data_ptr(), xi.data_ptr(), device.index,
            torch.cuda.current_stream(device).cuda_stream)


# ----------------------------------------------------------------------
# Slab (B4): constants, plain version, kernel
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SlabTable:
    """Host-built constants of a stacked Interpolator grid (one halo
    binning) for the slab kernels' plain version, as float32 tensors on
    one device.

    ``logm``, ``logm_res``, ``sec`` and ``weight`` are the quadrature as in
    :class:`BundleTable`; ``f_t`` (n_nodes, k_pad, c_pad) holds every
    node's matrix in :class:`BundleTable`'s layout, one node after
    another.
    """

    auto: bool
    n_bins: int
    n_centrals: int
    n_nodes: int
    n_xi: int
    nbp: int
    logm: torch.Tensor
    logm_res: torch.Tensor
    sec: torch.Tensor
    weight: torch.Tensor
    f_t: torch.Tensor

    @property
    def n_gauss(self):
        return self.logm.shape[1]

    @property
    def k_pad(self):
        return self.f_t.shape[1]

    @property
    def c_pad(self):
        return self.f_t.shape[2]


def slab_table_constants(table: TableData, n_nodes) -> SlabTable:
    """Constants of the stacked grid ``table`` (every node's rows stacked
    on the statistic axis, node-major)."""
    dense = table.tpcf_dense.cpu().numpy().astype(np.float32)
    if dense.shape[0] % n_nodes:
        raise ValueError("Stacked row count must be divisible by n_nodes.")
    n_xi = dense.shape[0] // n_nodes
    f_t, nbp = _contraction_matrices(
        dense.reshape((n_nodes, n_xi) + dense.shape[1:]), table.mode == AUTO)
    return SlabTable(auto=table.mode == AUTO, n_bins=table.n_bins,
                     n_centrals=table.n_centrals, n_nodes=n_nodes, n_xi=n_xi,
                     nbp=nbp, f_t=_tensor(f_t, table.n_h.device),
                     **_quadrature_arrays(table))


def slab_predict_plain(s: SlabTable, params, occupation_cen, occupation_sat):
    """The slab kernel's plain version: (total (B,), xi (B, n_nodes,
    n_xi)), ``_PLAIN_CHUNK`` batch rows and one node at a time (one
    4096-row chunk against all 64 nodes of the wide grid would be a 7 GB
    intermediate).

    The densities are float32, as in the kernel; each node's contraction
    runs in float64 and rounds to float32 before the division, so that
    the plain version is the more accurate side of the comparison.
    """
    batch = next(iter(params.values())).shape[0]
    outs = []
    for lo in range(0, batch, _PLAIN_CHUNK):
        p = {k: v[lo:lo + _PLAIN_CHUNK, None, None] for k, v in params.items()}
        outs.append(_slab_chunk(
            s, _plain_ngal(s, p, occupation_cen, occupation_sat)))
    return torch.cat([t for t, _ in outs]), torch.cat([x for _, x in outs])


def slab_contract_plain(s: SlabTable, ngal):
    """The plain version of a densities-in slab launch: the contraction of
    :func:`slab_predict_plain` on given float32 densities ngal (B,
    n_bins), ``_PLAIN_CHUNK`` rows at a time."""
    outs = [_slab_chunk(s, ngal[lo:lo + _PLAIN_CHUNK])
            for lo in range(0, ngal.shape[0], _PLAIN_CHUNK)]
    return torch.cat([t for t, _ in outs]), torch.cat([x for _, x in outs])


def _slab_chunk(s: SlabTable, ngal):
    """(total, xi (chunk, n_nodes, n_xi)) of one chunk of densities, each
    node's contraction in float64."""
    nb, nbp, n_xi = s.n_bins, s.nbp, s.n_xi
    total = _total(ngal)
    n = torch.nn.functional.pad(ngal, (0, s.k_pad - nb)).double()
    nodes = []
    for node in range(s.n_nodes):
        t = n @ s.f_t[node].double()
        if s.auto:
            t = t[:, :n_xi * nbp].reshape(-1, n_xi, nbp)
            nodes.append(torch.sum(t * n[:, None, :nbp], dim=-1))
        else:
            nodes.append(t[:, :n_xi])
    den = total * total if s.auto else total
    return total, torch.stack(nodes, dim=1).float() / den[:, None, None]


@functools.cache
def _slab_lib():
    """Build (first call only) and bind the entry points of slab.cu."""
    lib = load_library("slab", KERNEL_SOURCES["slab"])
    vp, i = ctypes.c_void_p, ctypes.c_int
    quad = [vp, i, i, i, ctypes.c_double, vp, vp, vp, vp, i, i, i, vp]
    lib.tabcorr_slab.argtypes = (quad + [ctypes.c_longlong] + [vp] * 5 +
                                 [i] * 5 + [vp, vp, i, vp])
    lib.tabcorr_slab_tc.argtypes = (quad + [i] + [vp] * 4 + [i] * 6 +
                                    [vp, vp, i, vp])
    lib.tabcorr_slab.restype = lib.tabcorr_slab_tc.restype = i
    lib.tabcorr_cuda_error_string.argtypes = [i]
    lib.tabcorr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _slab_entry_args(s: SlabTcTable, pmat, hod, block, what):
    """The arguments of slab.cu's tabcorr_slab (``block``: its ring stage)
    and the allocated outputs (total (B,), xi (B, n_nodes, n_xi))."""
    batch = _check_params(pmat, hod, s.n_bins)
    device = pmat.device
    _check_half(s, device, what)
    total = torch.empty(batch, device=device, dtype=torch.float32)
    xi = torch.empty((batch, s.n_nodes, s.n_xi), device=device,
                     dtype=torch.float32)
    args = (pmat.data_ptr(), batch, *hod.launch_args(),
            s.logm.data_ptr(),
            s.logm_res.data_ptr(), s.sec.data_ptr(), s.weight.data_ptr(),
            s.n_bins, s.n_centrals, s.n_gauss, s.b.data_ptr(), s.node_stride,
            *(a.data_ptr() for a in _half_arrays(s)[1:]), s.n_ct, s.n_nodes,
            s.n_xi, int(s.auto), *map(int, block), total.data_ptr(),
            xi.data_ptr(), *_stream_args(device))
    return args, (total, xi)


@profiling.spanned("fused.slab_launch")
def slab_launch(s: SlabTcTable, pmat, hod=KernelModel()):
    """Launch the CUDA slab kernel (FP32) once, over the block-triangular
    half of each node matrix (:func:`slab_tc_table_constants`).

    ``pmat`` is the float32 parameter matrix of the model ``hod`` (zheng07
    by default; see :func:`bundle_launch`) on the grid's CUDA device, or
    for densities in the (n_bins, B) float32 densities.  Returns (total
    (B,), xi (B, n_nodes, n_xi)).  Raises on any input the
    kernel does not take and on any launch error.
    """
    global SLAB_LAUNCHES
    stage_steps = _check_smem(fp32_stage_steps(s.n_bins, s.n_xi), "slab")
    args, outs = _slab_entry_args(s, pmat, hod, (stage_steps,), "slab")
    lib = _slab_lib()
    code = lib.tabcorr_slab(*args)
    _raise_on_error(code, "slab", lib.tabcorr_cuda_error_string)
    SLAB_LAUNCHES += 1
    return outs


# ----------------------------------------------------------------------
# The block-triangular half layout of contract.cuh
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SlabTcTable:
    """Host-built constants of a stacked Interpolator grid for the FP32
    slab kernel (csrc/slab.cu), and of one table (``n_nodes`` = 1) for
    the bundle and contraction kernels (csrc/bundle.cu), as tensors on one
    device; :class:`SlabSplitTable` holds the same columns for slab_tc.

    ``logm``, ``logm_res``, ``sec`` and ``weight`` are the quadrature as in
    :class:`BundleTable` (the contraction kernel reads none of them).  ``b`` (n_nodes, node_stride) float32 holds each
    node's GEMM operand as column tiles of 128 columns, tile ``ct`` a
    row-major (8 * ct_steps[ct], 128) block at ``ct_off[ct]`` covering the
    rows j from ``8 * ct_step0[ct]`` (see :func:`slab_tc_table_constants`
    for the columns).  ``col_k`` and ``col_i0`` (auto) give each n8 column
    tile's statistic (-1: padding) and first bin.
    """

    auto: bool
    n_bins: int
    n_centrals: int
    n_nodes: int
    n_xi: int
    width: int
    logm: torch.Tensor
    logm_res: torch.Tensor
    sec: torch.Tensor
    weight: torch.Tensor
    b: torch.Tensor
    ct_step0: torch.Tensor
    ct_steps: torch.Tensor
    ct_off: torch.Tensor
    col_k: torch.Tensor
    col_i0: torch.Tensor

    @property
    def n_gauss(self):
        return self.logm.shape[1]

    @property
    def n_ct(self):
        return self.ct_step0.shape[0]

    @property
    def node_stride(self):
        return self.b.shape[1]

    @functools.cached_property
    def occupation_plan(self):
        """The occupation kernel's node plan of this table
        (:func:`occupation_plan`), built at its first use."""
        return occupation_plan([self])


def _slab_tc_columns(nb, n_xi, auto, width):
    """Per column (padded to 128 per tile): statistic k (-1: padding), bin
    i and the first row j of its bin tile (auto); per tile its first K
    step."""
    nb8 = _round_up(nb, 8)
    slots = _CT // 8
    if auto:
        # n8 tiles in column order; a column tile is closed early where a
        # statistic would appear in it twice outside one aligned pair of
        # n8 tiles (contract.cuh's FP32 epilogue adds each tile's sums
        # without a barrier).
        k, i0, start = [], [], []
        for tile0 in range(0, nb, width):
            for kk in range(n_xi):
                for h in range(tile0, min(tile0 + width, nb), 8):
                    pos = len(k) % slots
                    ct_k = k[len(k) - pos:]
                    if any(c == kk and j // _PAIR_SLOTS !=
                           pos // _PAIR_SLOTS
                           for j, c in enumerate(ct_k)):
                        pad_n = slots - pos
                        k += [-1] * pad_n
                        i0 += [0] * pad_n
                        start += [nb8] * pad_n
                    k.append(kk)
                    i0.append(h)
                    start.append(tile0)
        n_ct = _round_up(len(k), slots) // slots
        pad = n_ct * slots - len(k)
        k8 = np.array(k + [-1] * pad, np.int32)
        i08 = np.array(i0 + [0] * pad, np.int32)
        start8 = np.array(start + [nb8] * pad, np.int64)
        step0 = start8.reshape(n_ct, -1).min(axis=1) // 8
        cols_k = np.repeat(k8, 8)
        cols_i = np.repeat(i08, 8) + np.tile(np.arange(8), len(k8))
        cols_start = np.repeat(start8, 8)
        return (cols_k, cols_i, cols_start, step0.astype(np.int32), k8, i08)
    n_ct = _round_up(n_xi, _CT) // _CT
    cols_k = np.arange(n_ct * _CT)
    cols_k = np.where(cols_k < n_xi, cols_k, -1).astype(np.int32)
    zeros = np.zeros(n_ct * _CT, np.int64)
    n8 = n_ct * (_CT // 8)
    return (cols_k, zeros, zeros, np.zeros(n_ct, np.int32),
            np.full(n8, -1, np.int32), np.zeros(n8, np.int32))


def _half_columns(table: TableData, n_nodes, width):
    """The block-triangular half's columns of a stacked grid (see
    :func:`slab_tc_table_constants`): the shape and column tables, and a
    function of the node giving its (n_ct * 128, nb8) float32 columns
    (column c's value at row j), zero above each tile's first row."""
    if width % 8 or width < 8:
        raise ValueError("the bin-tile width must be a positive multiple "
                         "of 8.")
    nb = table.n_bins
    nb8 = _round_up(nb, 8)
    auto = table.mode == AUTO
    dense = table.tpcf_dense.cpu().numpy().astype(np.float32)
    if dense.shape[0] % n_nodes:
        raise ValueError("Stacked row count must be divisible by n_nodes.")
    n_xi = dense.shape[0] // n_nodes
    dense = dense.reshape((n_nodes, n_xi) + dense.shape[1:])
    cols_k, cols_i, cols_start, step0, col_k, col_i0 = _slab_tc_columns(
        nb, n_xi, auto, width)
    j = np.arange(nb8)
    valid = (cols_k >= 0) & (cols_i < nb)
    if auto:
        start = cols_start[:, None]
        mult = np.where(j < start, 0.0, np.where(j < start + width, 1.0,
                                                 2.0)).astype(np.float32)
    else:
        mult = np.ones((cols_k.shape[0], nb8), np.float32)
    mult *= (valid[:, None] & (j < nb)[None, :])
    kc = np.maximum(cols_k, 0)
    ic = np.minimum(cols_i, nb - 1)

    def node_columns(m):
        fpad = np.zeros(dense.shape[1:-1] + (nb8,), np.float32)
        fpad[..., :nb] = dense[m]                 # [k, (i,) j]
        return (fpad[kc, ic] if auto else fpad[kc]) * mult   # [col, j]

    shape = dict(auto=auto, n_bins=nb, n_centrals=table.n_centrals,
                 n_nodes=n_nodes, n_xi=n_xi, width=width)
    steps = nb8 // 8 - step0
    return shape, step0, steps, col_k, col_i0, node_columns


def slab_tc_table_constants(table: TableData, n_nodes,
                            width=SLAB_TC_WIDTH) -> SlabTcTable:
    """Constants of the stacked grid ``table`` for the FP32 kernels built
    on csrc/contract.cuh (slab, bundle, contraction).

    Auto mode, the block-triangular half: the bins are cut into tiles of
    ``width`` (a multiple of 8); the columns are grouped by bin tile I as
    (I, k, i in I), and column (k, i) holds, at row j, F[k, i, j] for j in
    i's own tile, 2 F[k, i, j] for j in a later tile and 0 for an earlier
    one (F symmetric, as every auto table's dense matrix is), so that
    sum_i n_i (n B)[(k, i)] = n^T F_k n.  Cross mode: column k holds F[k,
    j].  Only the rows from each column tile's first nonzero row are
    stored; bins and rows past the table are zero.
    """
    shape, step0, steps, col_k, col_i0, node_columns = _half_columns(
        table, n_nodes, width)
    n_ct = step0.shape[0]
    off = np.concatenate([[0], np.cumsum(8 * steps * _CT)[:-1]])
    node_stride = int(np.sum(8 * steps * _CT))
    b = np.zeros((n_nodes, node_stride), np.float32)
    for m in range(n_nodes):
        cols = node_columns(m)
        for ct in range(n_ct):
            blk = cols[ct * _CT:(ct + 1) * _CT, 8 * step0[ct]:].T
            b[m, off[ct]:off[ct] + blk.size] = blk.ravel()
    device = table.n_h.device
    return SlabTcTable(
        **shape, b=_tensor(b, device),
        ct_step0=_tensor(step0, device, np.int32),
        ct_steps=_tensor(steps, device, np.int32),
        ct_off=_tensor(off, device, np.int32),
        col_k=_tensor(col_k, device, np.int32),
        col_i0=_tensor(col_i0, device, np.int32),
        **_quadrature_arrays(table))


# ----------------------------------------------------------------------
# slab_tc: B4 on the tensor cores ('scaled' tier), 3xTF32 on wgmma
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SlabSplitTable:
    """Host-built constants of a stacked Interpolator grid for the slab_tc
    kernel (csrc/slab.cu), as tensors on one device: the columns of
    :class:`SlabTcTable` split once into TF32 halves and cut into the
    kernel's stages (:func:`slab_split_table_constants`).

    ``b`` (n_nodes, node_steps * 2048) float32 holds each node's stages in
    the order the kernel consumes them: column tile ``ct`` (128 columns)
    from K step ``ct_step0[ct]`` for ``ct_steps[ct]`` K steps of 8 rows,
    tile after tile; a stage is the step's TF32 hi (1024 floats), then its
    lo, each K-major in the 32-byte swizzle (:func:`split_stage_offsets`).
    ``col_k``, ``col_i0`` and the quadrature are :class:`SlabTcTable`'s.
    """

    auto: bool
    n_bins: int
    n_centrals: int
    n_nodes: int
    n_xi: int
    width: int
    logm: torch.Tensor
    logm_res: torch.Tensor
    sec: torch.Tensor
    weight: torch.Tensor
    b: torch.Tensor
    ct_step0: torch.Tensor
    ct_steps: torch.Tensor
    col_k: torch.Tensor
    col_i0: torch.Tensor

    @property
    def n_gauss(self):
        return self.logm.shape[1]

    @property
    def n_ct(self):
        return self.ct_step0.shape[0]

    @property
    def node_steps(self):
        return self.b.shape[1] // _SPLIT_STEP_FLOATS

    @functools.cached_property
    def occupation_plan(self):
        """The occupation kernel's node plan of this table
        (:func:`occupation_plan`), built at its first use."""
        return occupation_plan([self])


def split_tf32(x):
    """float32 ``x`` split into TF32 halves ``(hi, lo)`` as
    csrc/tf32x3.cuh's split_tf32 does: ``hi`` rounded to 10 explicit
    mantissa bits, to nearest with ties away from zero (cvt.rna.tf32.f32,
    for finite values), ``lo`` = ``x - hi`` (exact in float32) rounded the
    same way; ``|x - hi - lo| <= 2**-22 |x|`` for normal ``x``."""
    def rna(v):
        bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32)
    hi = rna(x)
    return hi, rna(np.asarray(x, np.float32) - hi)


def split_stage_offsets():
    """(128, 8) int: the float offset of element (column n, K row k) in a
    stage half, K-major in the 32-byte swizzle that the kernel's wgmma
    descriptors read (csrc/hopper.cuh:desc_kmajor_sw32): 32 bytes a
    column, 8-column groups 256 bytes apart, the 16-byte halves of a
    column swapped where bit 2 of its index is set."""
    n = np.arange(_CT)[:, None]
    k = np.arange(8)[None, :]
    return ((n >> 3) * 64 + (n & 7) * 8 + ((k >> 2) ^ ((n >> 2) & 1)) * 4 +
            (k & 3))


def slab_split_table_constants(table: TableData, n_nodes,
                               width=SLAB_TC_WIDTH) -> SlabSplitTable:
    """Constants of the stacked grid ``table`` for the slab_tc kernel: the
    block-triangular half of :func:`slab_tc_table_constants` (the same
    columns, tiles and rows), every element split into TF32 hi and lo
    (:func:`split_tf32`) and stored as the kernel's stages
    (:class:`SlabSplitTable`), twice the bytes of the FP32 layout."""
    shape, step0, steps, col_k, col_i0, node_columns = _half_columns(
        table, n_nodes, width)
    tile = np.repeat(np.arange(step0.shape[0]), steps)
    kstep = np.concatenate([np.arange(s, s + n)
                            for s, n in zip(step0, steps)])
    cols = (tile[:, None] * _CT + np.arange(_CT))[:, :, None]
    rows = (8 * kstep[:, None] + np.arange(8))[:, None, :]
    pos = split_stage_offsets().ravel()
    b = np.zeros((n_nodes, tile.shape[0], 2, _SPLIT_STEP_FLOATS // 2),
                 np.float32)
    for m in range(n_nodes):
        hi, lo = split_tf32(node_columns(m)[cols, rows])   # (steps, 128, 8)
        b[m][:, 0, pos] = hi.reshape(tile.shape[0], -1)
        b[m][:, 1, pos] = lo.reshape(tile.shape[0], -1)
    device = table.n_h.device
    return SlabSplitTable(
        **shape, b=_tensor(b.reshape(n_nodes, -1), device),
        ct_step0=_tensor(step0, device, np.int32),
        ct_steps=_tensor(steps, device, np.int32),
        col_k=_tensor(col_k, device, np.int32),
        col_i0=_tensor(col_i0, device, np.int32),
        **_quadrature_arrays(table))


def _slab_tc_smem_bytes(wgs, stages, n_bins, n_xi) -> int:
    """Dynamic shared memory of one block of slab_tc with ``wgs`` consumer
    warpgroups and ``stages`` ring slots (csrc/slab.cu stc::smem_bytes):
    the ring and its barriers, then sN, sXi and sPar of 64 wgs rows."""
    tb = 64 * wgs
    return (stages * _SLAB_TC_SLOT_BYTES +
            4 * tb * (_round_up(n_bins, 8) + n_xi + _ROW_TERMS - 1))


def slab_tc_config(n_bins, n_xi):
    """(consumer warpgroups, ring slots) of the slab_tc kernel: two
    warpgroups (128-row blocks) where at least 3 slots fit in shared
    memory beside them, else one (64 rows) with at least 2; 4 slots where
    they fit.  None where nothing fits, which is never where the FP32 slab
    kernel's block fits (its 64 rows carry a 16 KB ring and 64 row totals
    more)."""
    for wgs in (2, 1):
        free = _SMEM_LIMIT - _slab_tc_smem_bytes(wgs, 0, n_bins, n_xi)
        stages = min(_SLAB_TC_STAGES, free // _SLAB_TC_SLOT_BYTES)
        if stages >= _SLAB_TC_MIN_STAGES[wgs]:
            return wgs, stages
    return None


def _check_split(s, device):
    if not isinstance(s, SlabSplitTable):
        raise ValueError("the slab_tc kernel reads the split layout "
                         "(slab_split_table_constants).")
    for a in (s.logm, s.logm_res, s.sec, s.weight, s.b):
        _check_tensor(a, device, torch.float32, "slab_tc constants")
    for a in (s.ct_step0, s.ct_steps, s.col_k, s.col_i0):
        _check_tensor(a, device, torch.int32, "slab_tc column tables")


@profiling.spanned("fused.slab_tc_launch")
def slab_tc_launch(s: SlabSplitTable, pmat, hod=KernelModel()):
    """Launch the slab_tc kernel once: :func:`slab_launch`'s function, in
    3xTF32 on wgmma (the 'scaled' tier), from the split constants
    (:func:`slab_split_table_constants`), in :func:`slab_tc_config`'s
    block.  Returns (total (B,), xi (B, n_nodes, n_xi)).  Raises on any
    input the kernel does not take and on any launch error."""
    global SLAB_TC_LAUNCHES
    config = _check_smem(slab_tc_config(s.n_bins, s.n_xi), "slab_tc")
    batch = _check_params(pmat, hod, s.n_bins)
    device = pmat.device
    _check_split(s, device)
    total = torch.empty(batch, device=device, dtype=torch.float32)
    xi = torch.empty((batch, s.n_nodes, s.n_xi), device=device,
                     dtype=torch.float32)
    lib = _slab_lib()
    code = lib.tabcorr_slab_tc(
        pmat.data_ptr(), batch, *hod.launch_args(), s.logm.data_ptr(),
        s.logm_res.data_ptr(), s.sec.data_ptr(), s.weight.data_ptr(),
        s.n_bins, s.n_centrals, s.n_gauss, s.b.data_ptr(), s.node_steps,
        *(a.data_ptr() for a in (s.ct_step0, s.ct_steps, s.col_k, s.col_i0)),
        s.n_ct, s.n_nodes, s.n_xi, int(s.auto), *map(int, config),
        total.data_ptr(), xi.data_ptr(), *_stream_args(device))
    _raise_on_error(code, "slab_tc", lib.tabcorr_cuda_error_string)
    SLAB_TC_LAUNCHES += 1
    return total, xi


def grid_kernel_takes(n_bins, mode, n_xi) -> bool:
    """Whether the kernel of the layout 'auto' picks takes a grid of this
    shape: the grid kernel for 'packed', the slab kernel for 'slab' (it
    runs the contraction kernel's blocks, so it takes one node's shape
    where that kernel does).  The grid kernel serves both contracts, and
    the 'scaled' tier's slab_tc takes every shape the FP32 slab kernel
    takes (slab_tc_config), so the answer holds for both tiers."""
    if _grid_layout(n_bins, mode) == "packed":
        return grid_fits(n_bins, mode, n_xi)
    return contraction_fits(n_bins, n_xi)


# ----------------------------------------------------------------------
# The grid predictor: B2 (packed) or B4 (slab), by tier
# ----------------------------------------------------------------------
def grid_kernel_for(layout, accuracy):
    """The kernel :func:`make_fused_grid_predictor` launches on CUDA.  The
    packed layout runs B2's one kernel, the grid kernel (FP64 tensor
    cores), under both contracts.  The slab layout picks by the contract,
    the counterpart of tabcorr_tpu's MXU pass classes: 'scaled' runs
    slab_tc (3xTF32 on wgmma), 'elementwise' the FP32 slab kernel."""
    if layout == "packed":
        return "grid"
    return "slab_tc" if accuracy == "scaled" else "slab"


def grid_constants(table: TableData, n_nodes, layout, accuracy,
                   device_type):
    """The constants :func:`make_fused_grid_predictor` builds: for the
    packed layout the :class:`GridTable` (every route); for the slab
    layout on CUDA the split :class:`SlabSplitTable` under 'scaled'
    (slab_tc) and the :class:`SlabTcTable` under 'elementwise' (slab),
    else the dense :class:`SlabTable` (the plain version); one set."""
    check_accuracy([accuracy], 1)
    if layout == "packed":
        return grid_table_constants(table, n_nodes)
    if device_type == "cuda":
        if grid_kernel_for(layout, accuracy) == "slab_tc":
            return slab_split_table_constants(table, n_nodes)
        return slab_tc_table_constants(table, n_nodes)
    return slab_table_constants(table, n_nodes)


def make_fused_grid_predictor(table: TableData, n_nodes, model,
                              accuracy="elementwise", layout="auto",
                              fold_spline=False, mesh=None,
                              batch_axis="dp"):
    """Predictor over a stacked Interpolator grid of one halo binning.

    Parameters
    ----------
    table : TableData
        float32; every node's statistic rows stacked node-major on the
        statistic axis ((n_nodes * n_xi, ...)), sharing one quadrature.
    n_nodes : int
    model : HodModel
        Any model whose ``supports_fused_engine`` is true
        (:func:`kernel_model`; densities in for all but zheng07 and its
        decoration).
    accuracy : str
        'elementwise' or 'scaled' (within 1e-6 of each row's largest
        statistic): the grid kernel under both, the FP32 or the 3xTF32
        slab kernel; see :func:`grid_kernel_for`.  On the CPU both run
        the plain versions.
    layout : str
        'packed' (the grid kernel, B2), 'slab' (the slab kernels, B4), or
        'auto': tabcorr_tpu's rule (:func:`grid_layout_for`), the slab
        for auto tables of more than 127 bins.
    fold_spline : bool
        True (packed only): the callable takes ``(params, node_weights (B,
        n_nodes))`` and returns ``(ngal (B,), xi (B, n_xi))``, the nodes
        reduced by the weights inside the kernel.  False: ``f(params) ->
        (ngal, xi (B, n_nodes, n_xi))``.
    mesh : DeviceMesh, optional
        Split the batch over ``batch_axis`` (:func:`rank_rows`): ``f``
        takes the global batch (and node weights) and returns this rank's
        rows, one launch a call and no collective.
    """
    check_accuracy([accuracy], 1)
    if layout == "auto":
        layout = grid_layout_for(table)
    if layout not in ("packed", "slab"):
        raise ValueError(f"Unknown layout: {layout!r}")
    if layout == "slab" and fold_spline:
        raise ValueError("fold_spline requires the 'packed' layout "
                         "(check grid_layout_for(table) first).")
    device = table.n_h.device
    hod = KernelModel.of(model)
    occ_cen, occ_sat = occupation_functions(model)
    consts = grid_constants(table, n_nodes, layout, accuracy, device.type)
    if device.type == "cuda" and hod.family is not None:
        consts.occupation_plan       # built once, here
    launch = {"grid": grid_launch, "slab": slab_launch,
              "slab_tc": slab_tc_launch}[grid_kernel_for(layout, accuracy)]

    def inputs(params):
        """The launch's parameter matrix, or its densities."""
        if hod.density_in:
            return kernel_densities(consts, table, model, hod, params)
        return _param_matrix(params, hod)

    if layout == "slab":
        def slab_outputs(params):
            _check_params_device(params, device)
            if device.type == "cuda":
                return launch(consts, inputs(params), hod)
            if hod.density_in:
                return slab_contract_plain(
                    consts, occupation_density(table, model, params))
            return slab_predict_plain(consts, params, occ_cen, occ_sat)

        return rank_rows(
            lambda params: refuse_gradient(slab_outputs(params), params),
            mesh, batch_axis)

    def outputs(params, node_weights):
        _check_params_device(params, device)
        if device.type == "cuda":
            return launch(consts, inputs(params), node_weights, hod)
        if hod.density_in:
            return grid_contract_plain(
                consts, occupation_density(table, model, params),
                node_weights)
        return grid_predict_plain(consts, params, node_weights, occ_cen,
                                  occ_sat)

    def run(params, node_weights):
        return refuse_gradient(outputs(params, node_weights), params,
                               node_weights)

    if fold_spline:
        return rank_rows(run, mesh, batch_axis)
    return rank_rows(lambda params: run(params, None), mesh, batch_axis)
