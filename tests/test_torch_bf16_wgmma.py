"""The bfloat16 contraction's wgmma kernels (``csrc/bf16.cu``) on the CPU.

* ``bf16_table_constants`` puts every element of the matrix where the
  kernel's swizzled wgmma descriptors read it: a numpy emulation of
  ``b_desc`` / the streamed kernel's chunk descriptors and of the K-major
  128- and 64-byte swizzles, independent of ``bf16_tile_offsets``.
* ``emulate`` is the kernel's arithmetic in torch: bfloat16 operands,
  float32 sums of t = n F k-step by k-step (16 bins), the auto fold's
  chains (even and odd n8 tiles of each lane, fused multiply-adds, half
  a statistic at a time at 128 and 160 bins), the quad sums, sum_j n_j
  from the A fragments (registers kernel) or the column of ones
  (streamed), the reciprocal of the divisor, one rounding to nearest.  It
  is held within one bfloat16 ulp of ``contraction_bf16_plain`` on path
  12's six table shapes (the grids' 2688 statistics cut to 130: every
  statistic runs the same arithmetic) at ragged batches, and, patched in
  as the fused route's contraction, against tabcorr_tpu's bfloat16 XLA
  route at test_torch_bf16_routes.py's bar.  Keep it in step with the
  kernel.
* ``contraction_bf16_takes`` takes every shape the mma.sync kernel before
  it took, and every taken shape has a launch configuration that fits in
  shared memory; the wrapper refuses CPU tensors and constants not in the
  kernel's layout.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.ops.predict import TableData

from test_torch_bf16_models import objects  # noqa: F401
from test_torch_bf16_routes import BATCH, _fused_case

# (n_bins, n_xi, mode, signed) of chip_smoke's path 12: wp, xi_ell, Delta
# Sigma, the 64-node grid, ds 'efficient' and the wide grid.
PATH12 = ((60, 19, "auto", False), (120, 42, "auto", True),
          (60, 19, "cross", False), (60, 130, "auto", False),
          (1104, 52, "cross", False), (160, 130, "auto", False))
BATCHES = (1, 63, 65, 257)


def _table(n_bins, n_xi, mode, signed, seed=0):
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
        device="cpu", dtype=torch.bfloat16)


def _columns(c, dense):
    """(n_tiles * cols, kp) float64: the product's columns as the kernel
    takes them, built from the table's (n_xi, [n_bins,] n_bins) matrix."""
    f = dense.double().numpy()
    nb, kp = c.n_bins, c.kp
    out = np.zeros((c.n_tiles * c.cols, kp))
    first = 0
    if c.streamed:
        out[0, :nb] = 1.0
        first = 64 if c.auto else 1
    if c.auto:
        block = np.zeros((c.n_xi, kp, kp))
        block[:, :nb, :nb] = f
        out[first:first + c.n_xi * kp] = block.reshape(-1, kp)
    else:
        out[first:first + c.n_xi, :nb] = f
    return out


def _descriptor_addresses(cols, kp):
    """{k-step: (cols, 16) byte addresses} at which the kernel's wgmma
    reads B[n, 16 ks + k] of a tile: the descriptor's start (chunk base +
    32 bytes a k-step), 8-row groups a stride byte offset (8 row bytes)
    apart, rows of 128 bytes (64-bin chunks) or 64 (a last 32-bin chunk),
    then the swizzle of the absolute address (Swizzle<3 or 2, 4, 3>)."""
    full = kp // 64
    n = np.arange(cols)[:, None]
    k = np.arange(16)[None, :]
    out = {}
    for ks in range(kp // 16):
        if ks < 4 * full:
            start, row = (ks // 4) * cols * 128 + (ks % 4) * 32, 128
        else:
            start, row = full * cols * 128 + (ks - 4 * full) * 32, 64
        addr = start + (n // 8) * (8 * row) + (n % 8) * row + 2 * k
        out[ks] = addr ^ (((addr >> 7) & (row // 16 - 1)) << 4)
    return out


@pytest.mark.parametrize("shape", [
    (60, 19, "auto"), (120, 42, "auto"), (60, 19, "cross"), (33, 5, "auto"),
    (90, 7, "auto"), (160, 3, "auto"), (150, 70, "cross"),
    (1104, 52, "cross"), (200, 3, "auto"), (300, 140, "cross")],
    ids=lambda s: f"{s[0]}x{s[1]}-{s[2]}")
def test_tile_image_is_what_the_descriptors_read(shape):
    n_bins, n_xi, mode = shape
    table = _table(n_bins, n_xi, mode, True)
    c = fused.bf16_table_constants(table)
    assert (c.kp, c.cols, c.n_tiles) == fused.bf16_geometry(
        mode == "auto", n_bins, n_xi)
    assert c.kp % (64 if c.streamed else 32) == 0 and c.cols % 8 == 0
    image = c.image.double().numpy()
    want = _columns(c, table.tpcf_dense)
    read = np.zeros((c.cols, c.kp), np.int64)    # element read for (n, j)
    for ks, addr in _descriptor_addresses(c.cols, c.kp).items():
        read[:, 16 * ks:16 * ks + 16] = addr // 2
    assert np.all(np.sort(read.ravel()) == np.arange(c.cols * c.kp))
    np.testing.assert_array_equal(fused.bf16_tile_offsets(c.cols, c.kp),
                                  read)
    for tile in range(c.n_tiles):
        np.testing.assert_array_equal(
            image[tile][read], want[tile * c.cols:(tile + 1) * c.cols])


def _fl(x):
    return x.to(torch.float32).double()


def _fma(a, b, c):
    """float32 fused multiply-add of float64-held float32 values (the
    product is exact in float64, one rounding of the sum)."""
    return _fl(a * b + c)


def _quad(v):
    """(v0 + v1) + (v2 + v3) over the last axis of 4 lanes, in float32."""
    return _fl(_fl(v[..., 0] + v[..., 1]) + _fl(v[..., 2] + v[..., 3]))


def emulate(c, ngal):
    """The bfloat16 contraction kernel's arithmetic on ngal (B, n_bins)
    bfloat16: (total (B,), xi (B, n_xi)) bfloat16."""
    batch = ngal.shape[0]
    n = torch.nn.functional.pad(ngal.double(), (0, c.kp - c.n_bins))
    # The product's columns: the streamed kernel's column of ones first.
    cols = c.bt.double()
    if c.streamed:
        ones = torch.zeros(1, c.kp, dtype=torch.float64)
        ones[0, :c.n_bins] = 1.0
        cols = torch.cat([ones, cols])
    t = torch.zeros(batch, cols.shape[0], dtype=torch.float64)
    for ks in range(c.kp // 16):
        k = slice(16 * ks, 16 * ks + 16)
        t = _fl(t + _fl(n[:, k] @ cols[:, k].T))
    # Lane (quad position) l holds bins 8 j + 2 l + e of n8 tile j.
    lanes = n.reshape(batch, c.kp // 16, 2, 4, 2)       # (ks, half, l, e)
    if c.streamed:
        total = t[:, 0]
    else:
        part = _fl(lanes[..., 0] + lanes[..., 1])       # (B, ks, half, l)
        s = torch.zeros(batch, 4, dtype=torch.float64)
        for ks in range(c.kp // 16):
            s = _fl(s + _fl(part[:, ks, 0] + part[:, ks, 1]))
        total = _quad(s)
    first = 1 if c.streamed else 0
    if not c.auto:
        inv = _fl(1.0 / total)
        xi = _fl(t[:, first:first + c.n_xi] * inv[:, None])
    else:
        tk = t[:, first:first + c.n_xi * c.kp].reshape(batch, c.n_xi,
                                                      c.kp // 8, 4, 2)
        nk = n.reshape(batch, 1, c.kp // 8, 4, 2)
        if c.streamed:
            # One chain a lane over the statistic's tiles, then a division.
            p = torch.zeros(batch, c.n_xi, 4, dtype=torch.float64)
            for j in range(c.kp // 8):
                for e in range(2):
                    p = _fma(tk[:, :, j, :, e], nk[:, :, j, :, e], p)
            xi = _fl(_quad(p) / _fl(total * total)[:, None])
        else:
            halves = 2 if c.kp >= 128 else 1
            per = c.kp // 8 // halves
            v = torch.zeros(batch, c.n_xi, 4, dtype=torch.float64)
            for h in range(halves):
                chains = torch.zeros(2, batch, c.n_xi, 4,
                                     dtype=torch.float64)
                for jj in range(per):
                    j = h * per + jj
                    chains[jj & 1] = _fma(
                        tk[:, :, j, :, 1], nk[:, :, j, :, 1],
                        _fma(tk[:, :, j, :, 0], nk[:, :, j, :, 0],
                             chains[jj & 1]))
                p = _fl(chains[0] + chains[1])
                v = p if h == 0 else _fl(p + v)
            inv = _fl(1.0 / _fl(total * total))
            xi = _fl(_quad(v) * inv[:, None])
    return total.to(torch.bfloat16), xi.to(torch.bfloat16)


def _within_one_ulp(have, want, signed):
    have, want = have.double().numpy(), want.double().numpy()
    big = np.maximum(np.abs(have), np.abs(want))
    tol = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
    if signed:
        cross = (want > 0).any(-1, keepdims=True) & \
            (want < 0).any(-1, keepdims=True)
        rowmax = np.max(np.abs(want), axis=-1, keepdims=True)
        tol = np.where(cross, np.maximum(tol, 2.0 ** -8 * rowmax), tol)
    return np.abs(have - want) <= tol


@pytest.mark.parametrize("shape", PATH12,
                         ids=lambda s: f"{s[0]}x{s[1]}-{s[2]}")
def test_emulated_kernel_within_one_ulp_of_plain(shape):
    n_bins, n_xi, mode, signed = shape
    c = fused.bf16_table_constants(_table(n_bins, n_xi, mode, signed))
    rng = np.random.default_rng(n_bins + n_xi)
    for batch in BATCHES:
        ngal = torch.tensor(rng.uniform(0.0, 1.0, (batch, n_bins)) *
                            np.exp(-np.arange(n_bins) / 40.0)).to(
                                torch.bfloat16)
        total, xi = emulate(c, ngal)
        want_total, want_xi = fused.contraction_bf16_plain(c, ngal)
        assert xi.shape == want_xi.shape == (batch, n_xi)
        assert _within_one_ulp(total[:, None], want_total[:, None],
                               False).all()
        assert _within_one_ulp(xi, want_xi, signed).all()


@pytest.mark.parametrize("table", ["wp", "ds"])
def test_emulated_kernel_on_the_fused_route_against_jax(
        objects, table, monkeypatch):  # noqa: F811
    jax_tab, tab = objects[table]
    calls = []

    def kernel(c, ngal):
        calls.append(ngal.shape)
        return emulate(c, ngal)

    monkeypatch.setattr(fused, "contraction_bf16_plain", kernel)
    jax_model = tt.Zheng07Model(threshold=-18)
    rng = np.random.default_rng(6)
    p = {k: v + 0.01 * abs(v) * rng.normal(size=BATCH)
         for k, v in jax_model.param_dict.items()}
    _fused_case(jax_tab, tab, jax_model, ttt.Zheng07Model(threshold=-18), p,
                roundings=1)
    assert calls == [(BATCH, tab.n_bins)]


def _mma_sync_kernel_took(n_bins, n_xi):
    """The shapes the mma.sync kernel before this one took: its density
    tile (128 rows up to 160 padded bins, else 64) in shared memory."""
    kp = -(-n_bins // 16) * 16
    rows = 128 if kp <= 160 else 64
    return (rows * (2 * (kp + 8) + 4) <= 232448 and
            n_xi * (-(-n_bins // 8) * 8) < 2 ** 31)


@pytest.mark.parametrize("n_xi", [1, 19, 52, 64, 65, 130, 2688])
def test_takes_every_shape_the_mma_sync_kernel_took(n_xi):
    for n_bins in range(1, 2001):
        if not _mma_sync_kernel_took(n_bins, n_xi):
            assert not fused.contraction_bf16_takes(n_bins, n_xi)
            continue
        assert fused.contraction_bf16_takes(n_bins, n_xi), n_bins
        for auto in (True, False):
            kp, cols, n_tiles = fused.bf16_geometry(auto, n_bins, n_xi)
            c = fused.Bf16Table(auto=auto, n_bins=n_bins, n_xi=n_xi,
                                ni=kp if auto else 0, kp=kp,
                                bt=torch.empty(0), cols=cols,
                                n_tiles=n_tiles, image=torch.empty(0))
            stages, win, smem = fused.bf16_launch_config(c)
            assert 2 <= stages <= 8 and 1 <= win <= n_xi
            assert smem <= 232448, (n_bins, n_xi, auto)
            assert cols <= (128 if c.streamed else 160) and cols % 8 == 0
    for n_bins, n_xi in ((1104, 52), (60, 2688), (160, 2688), (120, 42)):
        assert fused.contraction_bf16_takes(n_bins, n_xi)


def test_wrapper_refuses_cpu_tensors_and_wrong_constants():
    c = fused.bf16_table_constants(_table(60, 19, "auto", False))
    ngal = torch.zeros((4, 60), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.contraction_bf16_launch(c, ngal)
    with pytest.raises(ValueError, match="reads a Bf16Table"):
        fused.contraction_bf16_launch(c.bt, ngal)
    for wrong in (dataclasses.replace(c, cols=2 * c.cols),
                  dataclasses.replace(c, image=c.image[:, :-8]),
                  dataclasses.replace(c, kp=96)):
        with pytest.raises(ValueError, match="kernel's layout"):
            fused.contraction_bf16_launch(wrong, ngal)
