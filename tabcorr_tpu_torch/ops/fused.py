"""Bundle predictor: occupation quadrature and every table's contraction.

Port of ``tabcorr_tpu/ops/fused.py:make_fused_bundle_predictor``.  For a
batch of parameter vectors and a list of tabulations it computes, per
table, the per-bin galaxy density

    n[b, i] = sum_g occ(params_b, node_ig) * quad_weight[i, g] * n_h[i]

(occupation at the float64 Gauss-Legendre nodes, residual absorbed), and

    auto:  xi[b, k] = n_b^T F_k n_b / (sum_i n_bi)^2
    cross: xi[b, k] = (F n_b)_k / sum_i n_bi

Two implementations share one set of host constants (:class:`BundleTable`):

* :func:`bundle_launch` -- the hand-written CUDA kernel
  (``csrc/bundle.cu``), one launch for all tables.  It evaluates zheng07.
* :func:`bundle_predict_plain` -- the same computation in tensor ops,
  batch-chunked; any occupation model.  The CPU path and the tests run it.

:func:`make_fused_bundle_predictor` returns a predictor that launches the
kernel for CUDA parameter tensors and runs the plain version for CPU
ones.  Every output is full float32: the TPU build's bf16 pass emulation
and its 'scaled' pass classes have no counterpart here, so both accuracy
contracts ('elementwise', 'scaled') run at the same precision.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..models.protocol import occupation_functions
from ..models.zheng07 import Zheng07Model
from ..utils.build import load_library
from .predict import AUTO, TableData, occupation_with_residual

# Launches of the CUDA bundle kernel in this process (see bundle_launch).
BUNDLE_LAUNCHES = 0

ACCURACY_CONTRACTS = ("elementwise", "scaled")

# Tile geometry of csrc/bundle.cu: the contraction stages F in chunks of
# _KT rows and _CT columns, and each thread owns 4 consecutive columns.
_TB = 64
_KT = 32
_CT = 128
_MAX_TABLES = 4
_SMEM_LIMIT = 232448          # bytes a block may use on sm_90
_PLAIN_CHUNK = 4096


def _round_up(n, m):
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class BundleTable:
    """Host-built constants of one table, as float32 tensors on one device.

    ``logm``, ``logm_res``, ``sec`` and ``weight`` hold the quadrature
    nodes per bin (n_bins, n_gauss): float32 node, its float64 residual,
    secondary percentile, and quad_weight * n_h.  ``f_t`` is the matrix in
    the kernel's layout (k_pad, c_pad), zero-padded:

    * auto:  ``f_t[j, k * nbp + i] = F[k, i, j]``, with ``nbp`` the bin
      count rounded up to 4, so each thread's 4 columns share one k;
    * cross: ``f_t[j, k] = F[k, j]``.
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


def bundle_table_constants(table: TableData) -> BundleTable:
    """Per-table constants (port of ``_quad_segment_constants`` and the
    table part of ``_bundle_table_constants``)."""
    device = table.n_h.device
    nb = table.n_bins
    auto = table.mode == AUTO
    dense = table.tpcf_dense.cpu().numpy().astype(np.float32)
    n_xi = dense.shape[0]
    nbp = _round_up(nb, 4)
    k_pad = _round_up(nb, _KT)
    if auto:
        f_t = np.zeros((k_pad, _round_up(n_xi * nbp, _CT)), np.float32)
        blocks = np.zeros((nb, n_xi, nbp), np.float32)
        blocks[:, :, :nb] = dense.transpose(2, 0, 1)      # [j, k, i]
        f_t[:nb, :n_xi * nbp] = blocks.reshape(nb, n_xi * nbp)
    else:
        f_t = np.zeros((k_pad, _round_up(n_xi, _CT)), np.float32)
        f_t[:nb, :n_xi] = dense.T
    n_gauss = table.log_prim_quad.shape[1]
    logm = table.log_prim_quad.cpu().numpy().astype(np.float32)
    res = (np.zeros_like(logm) if table.log_prim_quad_lo is None else
           table.log_prim_quad_lo.cpu().numpy().astype(np.float32))
    weight = (table.quad_weight.cpu().numpy().astype(np.float64) *
              table.n_h.cpu().numpy().astype(np.float64)[:, None])
    sec = np.repeat(table.sec_perc.cpu().numpy().astype(np.float32)[:, None],
                    n_gauss, axis=1)

    def tensor(a):
        return torch.tensor(np.ascontiguousarray(a, dtype=np.float32),
                            device=device)

    return BundleTable(auto=auto, n_bins=nb, n_centrals=table.n_centrals,
                       n_xi=n_xi, nbp=nbp,
                       tpcf_shape=tuple(table.tpcf_shape),
                       logm=tensor(logm), logm_res=tensor(res),
                       sec=tensor(sec), weight=tensor(weight),
                       f_t=tensor(f_t))


# ----------------------------------------------------------------------
# Plain version
# ----------------------------------------------------------------------
def bundle_predict_plain(consts, params, occupation_cen, occupation_sat):
    """The bundle in float32 tensor ops, ``_PLAIN_CHUNK`` batch rows at a
    time (bounding the (chunk, n_xi * nbp) contraction intermediate).

    Returns ``[(total (B,), xi (B, n_xi)), ...]`` per table.
    """
    batch = next(iter(params.values())).shape[0]
    chunk = _PLAIN_CHUNK
    outs = [([], []) for _ in consts]
    for lo in range(0, batch, chunk):
        p = {k: v[lo:lo + chunk, None, None] for k, v in params.items()}
        for c, (totals, xis) in zip(consts, outs):
            total, xi = _plain_chunk(c, p, occupation_cen, occupation_sat)
            totals.append(total)
            xis.append(xi)
    return [(torch.cat(t), torch.cat(x)) for t, x in outs]


def _plain_chunk(c: BundleTable, p, occupation_cen, occupation_sat):
    nc = c.n_centrals
    occ_c = occupation_with_residual(occupation_cen, p, c.logm[:nc],
                                     c.logm_res[:nc], c.sec[:nc])
    occ_s = occupation_with_residual(occupation_sat, p, c.logm[nc:],
                                     c.logm_res[nc:], c.sec[nc:])
    ngal = torch.cat([torch.sum(occ_c * c.weight[:nc], dim=-1),
                      torch.sum(occ_s * c.weight[nc:], dim=-1)], dim=-1)
    # Summed in float64 like the kernel: xi scales as 1/total^2, and a
    # float32 sum over ~100 bins can carry ~5e-7 relative error.
    total = torch.sum(ngal, dim=-1, dtype=torch.float64).to(ngal.dtype)
    ngal = torch.nn.functional.pad(ngal, (0, c.k_pad - c.n_bins))
    t = ngal @ c.f_t
    if not c.auto:
        return total, t[:, :c.n_xi] / total[:, None]
    t = t[:, :c.n_xi * c.nbp].reshape(-1, c.n_xi, c.nbp)
    q = torch.sum(t * ngal[:, None, :c.nbp], dim=-1)
    return total, q / (total * total)[:, None]


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------
@functools.cache
def _bundle_fn():
    """Build (first call only) and bind the kernel's C entry point."""
    lib = load_library("bundle", ("bundle.cu",))
    fn = lib.tabcorr_bundle
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tabcorr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tabcorr_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.tabcorr_cuda_error_string


def load_bundle_kernel():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _bundle_fn()


def _smem_bytes(consts) -> int:
    """Dynamic shared memory of one block of the kernel for these tables
    (the layout ``tabcorr_bundle`` in csrc/bundle.cu carves)."""
    k_pad = max(c.k_pad for c in consts)
    n_xi = max(c.n_xi for c in consts)
    return 4 * (k_pad * _TB + _KT * _CT + _TB * (_CT // 4) + _TB * n_xi +
                7 * _TB)


def bundle_launch(consts, pmat, modulate_with_cenocc=False):
    """Launch the CUDA bundle kernel once for every table in ``consts``.

    ``pmat`` is the (B, 5) float32 zheng07 parameter matrix (columns in
    ``Zheng07Model.param_names`` order) on the tables' CUDA device.
    Returns ``[(total (B,), xi (B, n_xi)), ...]``.  Raises on any input
    the kernel does not take and on any launch error.
    """
    global BUNDLE_LAUNCHES
    if not pmat.is_cuda:
        raise ValueError("bundle_launch needs CUDA tensors.")
    if pmat.dtype != torch.float32 or pmat.dim() != 2 or \
            pmat.shape[1] != len(Zheng07Model.param_names):
        raise ValueError(f"params must be (B, 5) float32, got "
                         f"{tuple(pmat.shape)} {pmat.dtype}.")
    if not pmat.is_contiguous():
        raise ValueError("params must be contiguous.")
    if not 1 <= len(consts) <= _MAX_TABLES:
        raise ValueError(f"the kernel takes 1 to {_MAX_TABLES} tables.")
    smem = _smem_bytes(consts)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"tables too large for the kernel's shared memory "
                         f"({smem} > {_SMEM_LIMIT} bytes).")
    batch = pmat.shape[0]
    if batch >= 2 ** 31:
        raise ValueError("batch too large.")
    device = pmat.device
    ptrs, dims, outs = [], [], []
    for c in consts:
        arrays = (c.logm, c.logm_res, c.weight, c.f_t)
        for a in arrays:
            if a.device != device or a.dtype != torch.float32 or \
                    not a.is_contiguous():
                raise ValueError("table constants must be contiguous "
                                 "float32 on the parameters' device.")
        total = torch.empty(batch, device=device, dtype=torch.float32)
        xi = torch.empty((batch, c.n_xi), device=device, dtype=torch.float32)
        outs.append((total, xi))
        ptrs += [a.data_ptr() for a in arrays] + [total.data_ptr(),
                                                  xi.data_ptr()]
        dims += [c.n_bins, c.n_centrals, c.n_gauss, c.n_xi, c.nbp, c.k_pad,
                 c.c_pad, int(c.auto)]
    fn, err_str = _bundle_fn()
    stream = torch.cuda.current_stream(device).cuda_stream
    code = fn(pmat.data_ptr(), batch, int(bool(modulate_with_cenocc)),
              len(consts), (ctypes.c_void_p * len(ptrs))(*ptrs),
              (ctypes.c_int * len(dims))(*dims), device.index, stream)
    if code != 0:
        raise RuntimeError(f"bundle kernel launch failed: CUDA error {code} "
                           f"({err_str(code).decode()})")
    BUNDLE_LAUNCHES += 1
    return outs


# ----------------------------------------------------------------------
# Predictor
# ----------------------------------------------------------------------
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


def shaped(consts, results):
    """Reshape each table's flat xi to (B, *tpcf_shape)."""
    return [(total, xi.reshape((xi.shape[0],) + c.tpcf_shape))
            for c, (total, xi) in zip(consts, results)]


def make_fused_bundle_predictor(tables, model, accuracy=None):
    """One-kernel multi-statistic predictor.

    Parameters
    ----------
    tables : sequence of TableData
        float32 tabulations (auto or cross mode) on one device, sharing the
        model's parameters (their halo binnings may differ).
    model : HodModel
        On a CUDA device it must be a :class:`Zheng07Model`, the occupation
        the kernel evaluates; on the CPU any model runs (plain version).
    accuracy : sequence of str, optional
        One contract per table, 'elementwise' (default) or 'scaled'.  Both
        run at full float32 precision.

    Returns
    -------
    callable
        ``f(params dict of (B,) float32 tensors) -> [(ngal (B,), xi (B,
        *tpcf_shape)), ...]``: the kernel for CUDA tensors, the plain
        version for CPU tensors.
    """
    check_accuracy(accuracy, len(tables))
    consts = [bundle_table_constants(t) for t in tables]
    device = consts[0].logm.device
    if any(c.logm.device != device for c in consts):
        raise ValueError("all tables must be on one device.")
    if device.type == "cuda" and not isinstance(model, Zheng07Model):
        raise ValueError("the CUDA bundle kernel evaluates Zheng07Model "
                         f"occupations only, not {type(model).__name__}.")
    occ_cen, occ_sat = occupation_functions(model)

    def predict_batch(params):
        p_device = next(iter(params.values())).device
        if p_device != device:
            raise ValueError(f"parameters on {p_device}, tables on {device}.")
        if device.type == "cpu":
            results = bundle_predict_plain(consts, params, occ_cen, occ_sat)
        else:
            pmat = torch.stack([params[k] for k in Zheng07Model.param_names],
                               dim=1)
            results = bundle_launch(consts, pmat, model.modulate_with_cenocc)
        return shaped(consts, results)

    return predict_batch
