"""The bfloat16 contraction kernel (``csrc/bf16.cu``) against its plain
version on the card: ragged batches, auto tables of 60, 121, 160 and 400
bins (the 64-node and the wide grid's stacked rows among them) and cross
tables of 60, 1104 and 1792, 1 to 2688 statistics.  Each element within one
bfloat16 ulp of the plain one; rows whose statistics cross zero within
2^-8 of the row's largest |element|.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bf16_kernel.py
"""

import numpy as np
import pytest
import torch

from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.ops.predict import TableData

pytestmark = pytest.mark.gpu

BATCHES = (1, 63, 64, 65, 4097)
# (n_bins, n_xi, mode, signed matrix)
SHAPES = ((60, 19, "auto", False), (121, 42, "auto", True),
          (160, 1, "auto", False), (60, 2688, "auto", False),
          (160, 2688, "auto", False), (400, 3, "auto", True),
          (60, 19, "cross", False), (1104, 52, "cross", False),
          (1790, 130, "cross", True))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _table(n_bins, n_xi, mode, signed, device, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n_xi, n_bins, n_bins) if mode == "auto" else (n_xi, n_bins)
    f = rng.normal(size=shape) if signed else rng.uniform(0.1, 1.0, shape)
    if mode == "auto":
        f = 0.5 * (f + f.transpose(0, 2, 1))
    zeros = np.zeros(n_bins)
    return TableData.from_numpy(
        dict(tpcf_dense=f, n_h=zeros + 1.0, log_prim_quad=zeros[:, None],
             quad_weight=zeros[:, None] + 1.0, sec_perc=zeros),
        mode=mode, tpcf_shape=(n_xi,), n_centrals=n_bins // 2,
        device=device, dtype=torch.bfloat16)


def _assert_close(have, want, signed):
    have, want = have.double().cpu().numpy(), want.double().cpu().numpy()
    big = np.maximum(np.abs(have), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
    tol = ulp
    if signed:
        rowmax = np.max(np.abs(want), axis=-1, keepdims=True)
        tol = np.maximum(tol, 2.0 ** -8 * rowmax)
    assert np.all(np.abs(have - want) <= tol)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}"
                         f"-{s[2]}")
def test_bf16_kernel_matches_plain(cuda, shape, batch):
    n_bins, n_xi, mode, signed = shape
    c = fused.bf16_table_constants(_table(*shape, cuda))
    rng = np.random.default_rng(batch)
    ngal = torch.tensor(rng.uniform(0.0, 1.0, (batch, n_bins)),
                        device=cuda).to(torch.bfloat16)
    before = fused.CONTRACTION_BF16_LAUNCHES
    total, xi = fused.contraction_bf16_launch(c, ngal)
    torch.cuda.synchronize()
    assert fused.CONTRACTION_BF16_LAUNCHES == before + 1
    assert total.dtype == xi.dtype == torch.bfloat16
    assert xi.shape == (batch, n_xi)
    want_total, want_xi = fused.contraction_bf16_plain(c, ngal)
    _assert_close(total, want_total, False)
    _assert_close(xi, want_xi, signed)


def test_bf16_kernel_refuses_what_it_does_not_take(cuda):
    c = fused.bf16_table_constants(_table(60, 19, "auto", False, cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fused.contraction_bf16_launch(c, torch.zeros((4, 60), device=cuda))
    with pytest.raises(ValueError, match=r"\(B, 60\)"):
        fused.contraction_bf16_launch(
            c, torch.zeros((4, 61), device=cuda, dtype=torch.bfloat16))
    wide = fused.bf16_table_constants(_table(4000, 1, "cross", False, cuda))
    with pytest.raises(ValueError, match="too large"):
        fused.contraction_bf16_launch(
            wide, torch.zeros((4, 4000), device=cuda, dtype=torch.bfloat16))
