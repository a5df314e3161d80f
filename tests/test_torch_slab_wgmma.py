"""slab_tc's split constants and its wgmma kernel's arithmetic on the CPU.

The 'scaled' slab kernel (csrc/slab.cu, slab_tc) reads the node matrices
already split into TF32 halves (``fused.slab_split_table_constants``):
every k-step (8 K rows) of every 128-column tile of the block-triangular
half, hi then lo, each K-major in the 32-byte swizzle its wgmma
descriptors read, in the order the kernel consumes them.  These tests
hold that layout against the half of ``slab_tc_table_constants`` and the
dense matrices, emulate the kernel by walking the stages in its order (the
split of test_torch_tf32x3.py, three products per k-step into two fresh
accumulators per chunk of <= 4 k-steps, each MMA rounding toward zero,
the float32 running sum, the epilogue's quad reduction), and hold the
emulation to the 'scaled' contract (1e-6 of each row's largest statistic)
against float64 over the wide parameter box, to the old kernel's
emulation bit for bit, and to tabcorr_tpu's slab kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu.ops.fused as jax_fused
import tabcorr_tpu.predictor as jax_pred
import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch.ops import fused

from test_grid_stream import _stack
from test_torch_grid import _both, _port_stack
from test_torch_models import _wide_box
from test_torch_tf32x3 import (SCALED, _builder_tabs, _check_scaled,
                               _chunk, _columns_dense, _densities, _exact,
                               _quad_sum, _table,
                               emulate_slab_tc, split_tf32)

STEP = 2 * 128 * 8          # floats of one stage: hi, then lo


def _stages(s, node):
    """Node ``node``'s stages as (hi, lo) float32 arrays (steps, 128, 8):
    element (column n, K row k) of each stage half."""
    pos = fused.split_stage_offsets()
    b = s.b[node].numpy().reshape(s.node_steps, 2, STEP // 2)
    return b[:, 0][:, pos], b[:, 1][:, pos]


def _split_dense(s, node):
    """The stages put back at their (K row, column) places: (hi, lo) of
    (nb8, n_ct * 128), zero above each tile's first row."""
    nb8 = -(-s.n_bins // 8) * 8
    hi_st, lo_st = _stages(s, node)
    hi = np.zeros((nb8, s.n_ct * 128), np.float32)
    lo = np.zeros_like(hi)
    st = 0
    for ct, (s0, n) in enumerate(zip(s.ct_step0.tolist(),
                                     s.ct_steps.tolist())):
        for q in range(n):
            rows = slice(8 * (s0 + q), 8 * (s0 + q) + 8)
            cols = slice(128 * ct, 128 * ct + 128)
            hi[rows, cols] = hi_st[st].T
            lo[rows, cols] = lo_st[st].T
            st += 1
    assert st == s.node_steps
    return hi, lo


def _fma32(a, b, c):
    """fmaf on float32 arrays: a * b + c rounded once (from float64, exact
    for the product of two float32 values)."""
    return (a.astype(np.float64) * b + c.astype(np.float64)).astype(
        np.float32)


def emulate_split(s, n):
    """slab_tc's (total, xi (rows, n_nodes, n_xi)) float32 from float32
    densities n (rows, n_bins), walking the stages of ``s`` in the
    kernel's order: node, column tile, chunk of <= 4 k-steps, k-step.  Each
    chunk's two accumulators are added (float32) and, in auto mode, folded
    straight into each lane's share of the epilogue's sum over its two bins
    of every n8 tile (vp = fmaf(n_{i+1}, c_{i+1}, fmaf(n_i, c_i, vp)));
    the four lanes' shares are added as the quad's shuffles add them at the
    tile's end, (v0 + v1) + (v2 + v3), and two n8 tiles of one statistic
    (an aligned pair) are added together before they join the statistic.
    Cross mode adds the chunks to a float32 running sum."""
    rows, nb = n.shape
    nb8 = -(-nb // 8) * 8
    n_pad = np.zeros((rows, nb8), np.float32)
    n_pad[:, :nb] = n
    a_hi, a_lo = split_tf32(n_pad)
    tot = np.sum(n.astype(np.float64), axis=1).astype(np.float32)
    out = np.zeros((rows, s.n_nodes, s.n_xi), np.float32)
    col_k, col_i0 = s.col_k.numpy(), s.col_i0.numpy()
    for node in range(s.n_nodes):
        b_hi, b_lo = _stages(s, node)
        st = 0
        xi = np.zeros((rows, s.n_xi), np.float32)
        for ct, (s0, steps) in enumerate(zip(s.ct_step0.tolist(),
                                             s.ct_steps.tolist())):
            run = np.zeros((rows, 128), np.float32)
            vp = np.zeros((rows, 16, 4), np.float32)   # [row, n8 tile, t]
            i = col_i0[16 * ct:16 * ct + 16, None] + 2 * np.arange(4)
            for q in range(0, steps, 4):
                m = min(4, steps - q)
                k = slice(8 * (s0 + q), 8 * (s0 + q + m))
                bh = np.concatenate([b_hi[st + j].T for j in range(m)])
                bl = np.concatenate([b_lo[st + j].T for j in range(m)])
                st += m
                c = _chunk(a_hi[:, k], a_lo[:, k], bh, bl)
                if not s.auto:
                    run = run + c
                    continue
                c = c.reshape(rows, 16, 4, 2)
                vp = _fma32(n_pad[:, i + 1], c[..., 1],
                            _fma32(n_pad[:, i], c[..., 0], vp))
            if not s.auto:
                w = min(128, s.n_xi - 128 * ct)
                out[:, node, 128 * ct:128 * ct + w] = (run[:, :w] /
                                                       tot[:, None])
                continue
            for j in range(0, 16, 2):
                k0, k1 = col_k[16 * ct + j], col_k[16 * ct + j + 1]
                q0, q1 = _quad_sum(vp[:, j].T), _quad_sum(vp[:, j + 1].T)
                if k0 == k1:
                    if k0 >= 0:
                        xi[:, k0] = xi[:, k0] + (q0 + q1)
                    continue
                for kk, q in ((k0, q0), (k1, q1)):
                    if kk >= 0:
                        xi[:, kk] = xi[:, kk] + q
        assert st == s.node_steps
        if s.auto:
            out[:, node] = xi / (tot * tot)[:, None]
    return tot, out


# ----------------------------------------------------------------------
# The split constants
# ----------------------------------------------------------------------
def test_split_stage_offsets_are_the_32_byte_swizzle():
    pos = fused.split_stage_offsets()
    assert sorted(pos.ravel().tolist()) == list(range(1024))
    # Byte address of (n, k) before the swizzle: 32 bytes a column; the
    # swizzle flips bit 4 with bit 7 (Swizzle<1, 4, 3>).
    n, k = np.meshgrid(np.arange(128), np.arange(8), indexing="ij")
    plain = 32 * n + 4 * k
    swizzled = plain ^ (((plain >> 7) & 1) << 4)
    np.testing.assert_array_equal(4 * pos, swizzled)


@pytest.mark.parametrize("mode,n_bins,width", [
    ("auto", 160, 8), ("auto", 37, 8), ("auto", 60, 16), ("cross", 37, 8),
    ("cross", 160, 8)])
def test_split_constants_hold_every_node_matrix(mode, n_bins, width):
    n_nodes, n_xi = 2, 5
    table = _table(mode, n_bins, n_nodes, n_xi, seed=n_bins + width)
    half = fused.slab_tc_table_constants(table, n_nodes, width=width)
    s = fused.slab_split_table_constants(table, n_nodes, width=width)
    assert s.b.dtype == torch.float32 and s.b.shape == (
        n_nodes, 2 * int(half.b.shape[1]))
    for name in ("ct_step0", "ct_steps", "col_k", "col_i0"):
        assert torch.equal(getattr(s, name), getattr(half, name)), name
    dense = table.tpcf_dense.double().numpy().reshape(
        (n_nodes, n_xi) + tuple(table.tpcf_dense.shape[1:]))
    n = 10.0 ** np.random.default_rng(1).uniform(-6, -2, (5, n_bins))
    for node in range(n_nodes):
        hi, lo = _split_dense(s, node)
        want = _columns_dense(half, node)
        # Both halves are TF32 values, split by the device's rule bit for
        # bit; re-folded they are the half layout's float32 to 2^-22.
        want_hi, want_lo = split_tf32(want)
        np.testing.assert_array_equal(hi, want_hi)
        np.testing.assert_array_equal(lo, want_lo)
        assert not np.any(hi.view(np.uint32) & 0x1FFF)
        assert not np.any(lo.view(np.uint32) & 0x1FFF)
        refold = hi.astype(np.float64) + lo.astype(np.float64)
        assert np.all(np.abs(refold - want) <= 2.0 ** -22 * np.abs(want))
        # ... and contracted as the kernel contracts them, the dense
        # matrices (the refold's 2^-22 is the only difference).
        got = _contraction(s, refold, n)
        exact = (np.einsum("bi,kij,bj->bk", n, dense[node], n)
                 if mode == "auto" else n @ dense[node].T)
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=0)


def _contraction(s, cols, n):
    """xi of one node in float64 from its columns ``cols`` (nb8, n_ct *
    128): t = n B, then the epilogue's sum over each n8 column tile's bins
    (auto), or t (cross), unnormalised."""
    n_pad = np.zeros((n.shape[0], cols.shape[0]))
    n_pad[:, :s.n_bins] = n
    t = n_pad @ cols
    if not s.auto:
        return t[:, :s.n_xi]
    xi = np.zeros((n.shape[0], s.n_xi))
    for c, (k, i0) in enumerate(zip(s.col_k.tolist(), s.col_i0.tolist())):
        if k >= 0:
            xi[:, k] += np.sum(n_pad[:, i0:i0 + 8] * t[:, 8 * c:8 * c + 8],
                               axis=1)
    return xi


# ----------------------------------------------------------------------
# The kernel's arithmetic, emulated
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def wide():
    """The first 4 nodes of the wide grid (160 bins, 42 rows), both
    layouts."""
    stacked = _port_stack(_builder_tabs(40, 2))
    return (stacked, fused.slab_tc_table_constants(stacked, 4),
            fused.slab_split_table_constants(stacked, 4))


def _wide_box_densities(stacked, batch, seed):
    """float32 zheng07 densities (batch, 160) over the wide parameter box
    of test_torch_models.py (logMmin 10.5-13.5, sigma_logM 0.1-1.0, logM0
    and logM1 +-1 dex, alpha 0.5-1.5)."""
    model = ttt.Zheng07Model(threshold=-20, redshift=0.0)
    p = {k: torch.tensor(v) for k, v in _wide_box(batch, seed).items()}
    c = fused.slab_table_constants(stacked, 1)
    return fused._plain_ngal(c, {k: v[:, None, None] for k, v in p.items()},
                             *ttt.occupation_functions(model)).numpy()


def test_split_emulation_meets_the_scaled_contract_over_the_wide_box(wide):
    stacked, _, s = wide
    n = _wide_box_densities(stacked, 64, 11)
    assert np.all(np.isfinite(n)) and np.all(n.sum(axis=1) > 0)
    tot, xi = emulate_split(s, n)
    dense = stacked.tpcf_dense.numpy().astype(np.float64).reshape(
        4, 42, 160, 160)
    want = _exact(dense, n, True) / (np.sum(n.astype(np.float64), 1) ** 2)[
        :, None, None]
    err = _check_scaled(xi, want, "slab_tc (split) emulation vs float64, "
                        "wide box")
    print(f"slab_tc emulation vs float64 over the wide box: {err:.3e} "
          f"scaled (margin {SCALED / err:.1f}x)")
    np.testing.assert_allclose(tot, np.sum(n.astype(np.float64), 1),
                               rtol=1e-7)


@pytest.mark.parametrize("box", ["fiducial", "wide"])
def test_split_emulation_agrees_with_the_mma_sync_emulation(wide, box):
    """The wgmma kernel takes the old mma.sync kernel's products (the same
    split, chunks and accumulators) and folds each chunk into the
    epilogue's sums instead of a running sum: the two orders differ by a
    few float32 roundings of the statistics, under 3e-7 of each row's
    largest, under a third of the contract."""
    stacked, half, s = wide
    n = (_densities(stacked, 16, 4)[0] if box == "fiducial" else
         _wide_box_densities(stacked, 16, 12))
    tot_a, xi_a = emulate_split(s, n)
    tot_b, xi_b = emulate_slab_tc(half, n)
    np.testing.assert_array_equal(tot_a, tot_b)
    err = _check_scaled(xi_a, xi_b.astype(np.float64), "split vs mma.sync "
                        "emulation")
    print(f"split vs mma.sync emulation ({box}): {err:.3e} scaled")
    assert err <= 3e-7


def test_split_emulation_matches_the_jax_slab_kernel(wide):
    """8 rows through tabcorr_tpu's slab Pallas kernel (interpret mode, as
    tests/test_torch_slab.py runs it) and through the emulation fed the
    port's float32 densities of the same rows."""
    stacked, _, s = wide
    tabs = _builder_tabs(40, 2)
    jax_model = tt.Zheng07Model(threshold=-20, redshift=0.0)
    jax_f = jax_fused.make_fused_grid_predictor(
        _stack(tabs), 4, *jax_pred.occupation_functions(jax_model),
        tuple(jax_model.param_dict), batch_tile=8, interpret=True,
        layout="slab")
    n, p = _densities(stacked, 8, 9)
    ng_j, xi_j = (np.asarray(a, np.float64) for a in jax_f(
        {k: np.asarray(v) for k, v in p.items()}))
    tot, xi = emulate_split(s, n)
    np.testing.assert_allclose(tot, ng_j, rtol=1e-6)
    err = _check_scaled(xi, xi_j, "slab_tc (split) emulation vs tabcorr_tpu")
    print(f"slab_tc emulation vs tabcorr_tpu's slab kernel: {err:.3e} "
          "scaled")


@pytest.mark.parametrize("mode,width", [("auto", 8), ("auto", 16),
                                        ("cross", 8)])
def test_split_emulation_in_cross_mode_and_at_ragged_bins(mode, width):
    """Cross mode, and auto grids of 37 bins (not a multiple of 8) at 8-
    and 16-bin tiles (the latter puts one statistic in aligned pairs of n8
    tiles), against float64: the emulation walks every stage."""
    table = _table(mode, 37, 3, 5, seed=31)
    s = fused.slab_split_table_constants(table, 3, width=width)
    if width == 16:
        k = s.col_k.numpy().reshape(-1, 2)
        assert np.any((k[:, 0] == k[:, 1]) & (k[:, 0] >= 0))
    n = 10.0 ** np.random.default_rng(2).uniform(-6, -2, (16, 37))
    n = n.astype(np.float32)
    _, xi = emulate_split(s, n)
    dense = table.tpcf_dense.double().numpy().reshape(
        (3, 5) + tuple(table.tpcf_dense.shape[1:]))
    tot = np.sum(n.astype(np.float64), 1)
    want = _exact(dense, n, mode == "auto") / (
        (tot * tot) if mode == "auto" else tot)[:, None, None]
    _check_scaled(xi, want, f"slab_tc emulation, {mode}, 37 bins, "
                  f"width {width}")


# ----------------------------------------------------------------------
# The wrapper and the kernel's block
# ----------------------------------------------------------------------
def test_slab_tc_wrapper_needs_cuda_and_its_constants():
    table = _table("auto", 24, 2, 3, seed=7)
    s = fused.slab_split_table_constants(table, 2)
    half = fused.slab_tc_table_constants(table, 2)
    before = fused.SLAB_TC_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        fused.slab_tc_launch(s, torch.ones((4, 5)))
    with pytest.raises(ValueError, match="CUDA"):
        fused.slab_tc_launch(s, torch.ones((24, 4)),
                             fused.KernelModel(code=fused.DENSITY_IN))
    # A shape no block takes: 2000 bins.
    wide = _table("cross", 2000, 1, 3, seed=8)
    with pytest.raises(ValueError, match="shared"):
        fused.slab_tc_launch(fused.slab_split_table_constants(wide, 1),
                             torch.ones((4, 5)))
    assert fused.SLAB_TC_LAUNCHES == before
    # The FP32 layout is not the split one (checked before any launch;
    # on the CPU the tensors' device is refused first).
    with pytest.raises(ValueError, match="split"):
        fused._check_split(half, torch.device("cpu"))
    fused._check_split(s, torch.device("cpu"))


def test_slab_tc_config_of_the_wide_grid_and_its_limits():
    # The wide grid: two consumer warpgroups (128-row blocks), 4 ring slots
    # of 8 KB beside 80 KB of densities.
    assert fused.slab_tc_config(160, 42) == (2, 4)
    assert fused._slab_tc_smem_bytes(2, 15, 160, 42) <= fused._SMEM_LIMIT
    assert fused._slab_tc_smem_bytes(2, 16, 160, 42) > fused._SMEM_LIMIT
    # 400 bins: one warpgroup of 64 rows.
    assert fused.slab_tc_config(400, 42) == (1, 4)
    # The FP32 slab kernel's largest shapes: one warpgroup, 2-3 slots.
    assert fused.contraction_fits(736, 42)
    assert fused.slab_tc_config(736, 42) == (1, 3)
    assert fused.slab_tc_config(1000, 5) is None


@pytest.mark.parametrize("n_xi", [1, 4, 13, 42, 100, 300, 700])
def test_slab_tc_takes_every_shape_the_fp32_slab_takes(n_xi):
    """Wherever the FP32 slab kernel's block fits in shared memory, slab_tc's
    does: the 'scaled' tier refuses no shape the 'elementwise' tier
    takes."""
    taken = 0
    for n_bins in range(1, 1700, 7):
        if fused.contraction_fits(n_bins, n_xi):
            taken += 1
            wgs, stages = fused.slab_tc_config(n_bins, n_xi)
            assert stages >= fused._SLAB_TC_MIN_STAGES[wgs]
            assert fused._slab_tc_smem_bytes(wgs, stages, n_bins, n_xi) <= \
                fused._SMEM_LIMIT
    assert taken > (10 if n_xi == 700 else 50)
