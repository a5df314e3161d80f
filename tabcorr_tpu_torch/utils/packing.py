"""Symmetric-matrix packing utilities (numpy only).

The reference stores auto-correlation tabulations as the row-wise lower
triangle of a symmetric (n_bins, n_bins) matrix (reference:
tabcorr/tabcorr.py:770-806).  Element ``p = i*(i+1)/2 + j`` of the packed
array corresponds to matrix entry ``(i, j)`` with ``j <= i``.  The port
unpacks to the dense symmetric matrix at load time, so the contraction
``sum_p M_p (2 - delta_ij) n_i n_j`` becomes the quadratic form ``n^T F n``.
"""

from __future__ import annotations

import numpy as np


def packed_size(n: int) -> int:
    """Number of entries in the packed lower triangle of an (n, n) matrix."""
    return (n * n + n) // 2


def packed_index_arrays(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Row/column indices (i, j) with j <= i for each packed entry."""
    i, j = np.tril_indices(n)
    order = np.argsort(i * (i + 1) // 2 + j, kind="stable")
    return i[order].astype(np.int32), j[order].astype(np.int32)


def symmetric_matrix_to_array(matrix: np.ndarray,
                              check_symmetry: bool = True) -> np.ndarray:
    """Pack a symmetric (n, n) matrix into its row-wise lower triangle, in
    the reference's packing order (tabcorr/tabcorr.py:770-806)."""
    if check_symmetry:
        if matrix.ndim != 2 or matrix.shape[0] != matrix.shape[1]:
            raise ValueError("The matrix you provided is not symmetric.")
        if not np.all(matrix == np.swapaxes(matrix, -1, -2)):
            raise ValueError("The matrix you provided is not symmetric.")
    idx_i, idx_j = packed_index_arrays(matrix.shape[0])
    return matrix[idx_i, idx_j]


def array_to_symmetric_matrix(packed: np.ndarray) -> np.ndarray:
    """Unpack a row-wise lower-triangle array to a dense symmetric matrix.

    Accepts leading batch dimensions: ``packed`` of shape (..., n_pairs)
    yields (..., n, n).
    """
    n_pairs = packed.shape[-1]
    n = int((np.sqrt(8 * n_pairs + 1) - 1) / 2 + 0.5)
    if packed_size(n) != n_pairs:
        raise ValueError(f"{n_pairs} is not a triangular number.")
    idx_i, idx_j = packed_index_arrays(n)
    out = np.zeros(packed.shape[:-1] + (n, n), dtype=packed.dtype)
    out[..., idx_i, idx_j] = packed
    out[..., idx_j, idx_i] = packed
    return out


def packed_prefactor(n: int) -> np.ndarray:
    """Multiplicity (2 - delta_ij) of each packed entry (diagonal 1,
    off-diagonal 2)."""
    idx_i, idx_j = packed_index_arrays(n)
    return np.where(idx_i == idx_j, 1.0, 2.0)
