"""The 'scaled' tier of the slab kernels on the CPU: the TF32 split
(csrc/tf32x3.cuh), the slab_tc kernel's block-triangular layout, and a
numpy emulation of the 3xTF32 contraction that slab_tc runs on the
tensor cores.

The emulation follows the kernel's arithmetic: the density side and the
constant matrix split into TF32 hi/lo by :func:`split_tf32` (the device's
cvt.rna.tf32.f32, bit for bit on finite values), three products per
k-step of 8 (lo*hi, hi*lo, hi*hi) added to two fresh float32 chunk
accumulators of at most 32 K rows, one for the hi*hi products and one for
the small ones, then the chunk added to a running sum in float32, and the
kernel's epilogue.  The tensor cores' own accumulation is modelled
pessimistically: every MMA rounds its sum toward zero.  It runs on the
wide grid's synthetic draws (160 bins), 4 nodes and 64 rows, against a
float64 contraction and against tabcorr_tpu's slab Pallas kernel in
interpret mode, under the 'scaled' contract: 1e-6 of each row's largest
statistic.
"""

import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu.ops.fused as jax_fused
import tabcorr_tpu.predictor as jax_pred
import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch import predictor
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.ops.predict import TableData, quadrature_grid

from test_bundle_shapes import synthetic_tabcorr
from test_grid_stream import _stack
from test_torch_slab import _wide_interpolators
from test_torch_grid import _both, _params, _port_stack, _scaled

SCALED = 1e-6


# ----------------------------------------------------------------------
# The split
# ----------------------------------------------------------------------
def _tf32_rna(x):
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits) to
    nearest, ties away from zero: csrc/tf32x3.cuh's to_tf32, as
    cvt.rna.tf32.f32 rounds.  Infinities and NaNs pass unchanged; a finite
    value at or past the largest TF32 value's rounding boundary becomes an
    infinity."""
    x = np.ascontiguousarray(x, np.float32)
    bits = x.view(np.uint32)
    out = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)
    return np.where(np.isfinite(x), out, x)


def split_tf32(x):
    """Split float32 ``x`` into TF32 values ``(hi, lo)`` as the wgmma
    kernels split their densities on the device: ``hi`` = x rounded to TF32,
    ``lo`` = ``x - hi`` (exact in float32) rounded the same way; ``|x - hi
    - lo| <= 2**-22 |x|`` for normal ``x``."""
    x = np.asarray(x, np.float32)
    hi = _tf32_rna(x)
    with np.errstate(invalid="ignore"):
        lo = _tf32_rna(np.where(np.isfinite(x), x - hi, 0).astype(
            np.float32))
    return hi, lo


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_split_tf32_rounds_ties_away_from_zero(sign):
    base = 0x3F800000                        # 1.0
    x = sign * _f32([base + 0x1000,          # exactly half a TF32 ulp
                     base + 0x0FFF,          # just below half
                     base + 0x3000,          # 1.5 ulp: a tie, away
                     base + 0x1FFF, base])
    hi, lo = split_tf32(x)
    want = sign * _f32([base + 0x2000, base, base + 0x4000, base + 0x2000,
                        base])
    np.testing.assert_array_equal(hi, want)
    assert np.all(_bits(hi) & 0x1FFF == 0)
    assert np.all(_bits(lo) & 0x1FFF == 0)
    np.testing.assert_array_equal(np.abs(hi), np.abs(split_tf32(
        -x)[0]))


@pytest.mark.parametrize("decades", [(-30, 30), (-3, 3)])
def test_split_tf32_keeps_22_bits(decades):
    rng = np.random.default_rng(3)
    x = (rng.choice([-1.0, 1.0], 20000) *
         10.0 ** rng.uniform(*decades, 20000)).astype(np.float32)
    hi, lo = split_tf32(x)
    assert np.all(_bits(hi) & 0x1FFF == 0) and np.all(_bits(lo) & 0x1FFF == 0)
    x64 = x.astype(np.float64)
    # hi is x to 11 significant bits, lo the rest to 11 more.
    assert np.all(np.abs(x64 - hi) <= 2.0 ** -11 * np.abs(x64))
    resid = np.abs(x64 - hi.astype(np.float64) - lo.astype(np.float64))
    assert np.all(resid <= 2.0 ** -22 * np.abs(x64))


def test_split_tf32_special_values():
    tiny = np.float32(np.finfo(np.float32).tiny)
    x = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, tiny, tiny / 8,
                  -tiny / 1024, np.finfo(np.float32).max], np.float32)
    hi, lo = split_tf32(x)
    assert hi[0] == 0 and lo[0] == 0 and np.signbit(hi[1])
    assert hi[2] == np.inf and hi[3] == -np.inf and lo[2] == lo[3] == 0
    assert np.isnan(hi[4])
    # Subnormals: both halves TF32 values, and hi + lo within the float32
    # subnormal spacing times 2^-11.
    for v, h, l in zip(x[5:8], hi[5:8], lo[5:8]):
        assert _bits(h) & 0x1FFF == 0 and _bits(l) & 0x1FFF == 0
        assert abs(float(v) - float(h) - float(l)) <= 2.0 ** -149
    # The largest float32 rounds past the largest TF32 value: infinity,
    # as cvt.rna gives.
    assert hi[8] == np.inf


# ----------------------------------------------------------------------
# slab_tc's block-triangular layout
# ----------------------------------------------------------------------
def _table(mode, n_bins, n_nodes, n_xi, seed):
    """A stacked grid table of n_nodes symmetric (auto) matrices."""
    rng = np.random.default_rng(seed)
    log_min = np.linspace(10.8, 14.6, n_bins)
    log_quad, weight = quadrature_grid(log_min, log_min + 0.2,
                                       rng.uniform(-1.9, -1.5, n_bins), 10)
    if mode == "auto":
        a = rng.uniform(0.2, 1.0, (n_nodes * n_xi, n_bins, n_bins))
        dense = 0.5 * (a + np.swapaxes(a, 1, 2))
    else:
        dense = rng.uniform(0.2, 1.0, (n_nodes * n_xi, n_bins))
    return TableData.from_numpy(
        dict(tpcf_dense=dense, n_h=10.0 ** rng.uniform(-6, -2, n_bins),
             log_prim_quad=log_quad, quad_weight=weight,
             sec_perc=np.full(n_bins, 0.5)),
        mode=mode, tpcf_shape=(n_nodes * n_xi,), n_centrals=n_bins // 2,
        device="cpu", dtype=torch.float32)


def _columns_dense(s, node):
    """Node ``node``'s slab_tc operand as one (nb8, n_ct * 128) float32
    matrix: the column tiles of ``s.b`` at their rows, zero above them."""
    nb8 = -(-s.n_bins // 8) * 8
    b = s.b[node].numpy()
    out = np.zeros((nb8, s.n_ct * 128), np.float32)
    for ct, (s0, n, off) in enumerate(zip(s.ct_step0.tolist(),
                                          s.ct_steps.tolist(),
                                          s.ct_off.tolist())):
        out[8 * s0:8 * (s0 + n), ct * 128:(ct + 1) * 128] = b[
            off:off + 8 * n * 128].reshape(8 * n, 128)
    return out


def _layout_contraction(s, node, n):
    """xi of one node from the layout in float64: t = n B, then the
    epilogue's sum over each n8 column tile's bins (auto), or t (cross),
    unnormalised."""
    b = _columns_dense(s, node).astype(np.float64)
    n_pad = np.zeros((n.shape[0], b.shape[0]))
    n_pad[:, :s.n_bins] = n
    t = n_pad @ b
    if not s.auto:
        return t[:, :s.n_xi]
    xi = np.zeros((n.shape[0], s.n_xi))
    for c, (k, i0) in enumerate(zip(s.col_k.tolist(), s.col_i0.tolist())):
        if k >= 0:
            xi[:, k] += np.sum(n_pad[:, i0:i0 + 8] * t[:, 8 * c:8 * c + 8],
                               axis=1)
    return xi


@pytest.mark.parametrize("mode", ["auto", "cross"])
@pytest.mark.parametrize("n_bins", [160, 120, 60, 37])
@pytest.mark.parametrize("width", [8, 16])
def test_slab_tc_layout_equals_the_dense_contraction(mode, n_bins, width):
    n_nodes, n_xi = 2, 5
    table = _table(mode, n_bins, n_nodes, n_xi, seed=n_bins + width)
    s = fused.slab_tc_table_constants(table, n_nodes, width=width)
    dense = table.tpcf_dense.double().numpy().reshape(
        (n_nodes, n_xi) + tuple(table.tpcf_dense.shape[1:]))
    n = 10.0 ** np.random.default_rng(1).uniform(-6, -2, (5, n_bins))
    for node in range(n_nodes):
        got = _layout_contraction(s, node, n)
        want = (np.einsum("bi,kij,bj->bk", n, dense[node], n)
                if mode == "auto" else n @ dense[node].T)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # A statistic appears in a column tile at most once, or twice within
    # one aligned pair of n8 tiles (contract.cuh's FP32 epilogue relies on
    # it).
    for tile in s.col_k.numpy().reshape(-1, 16):
        for c, k in enumerate(tile):
            same = np.flatnonzero(tile == k)
            assert k < 0 or np.all(same // 2 == c // 2), tile
    # Every tile runs from its first nonzero row to the last bin.
    nb8 = -(-n_bins // 8) * 8
    assert s.b.shape == (n_nodes, int(8 * 128 * s.ct_steps.sum()))
    assert bool((s.ct_step0 + s.ct_steps == nb8 // 8).all())


# ----------------------------------------------------------------------
# The 3xTF32 emulation
# ----------------------------------------------------------------------
def _rz32(x):
    """float64 -> float32, rounding toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _chunk(a_hi, a_lo, b_hi, b_lo):
    """Fresh accumulators over one chunk of k-steps of 8: per k-step the
    three MMAs lo*hi, hi*lo, hi*hi, each product exact and each MMA's sum
    rounded toward zero to float32; the hi*hi products chain through one
    accumulator and the two small ones through another, added at the end
    of the chunk."""
    zero = np.zeros((a_hi.shape[0], b_hi.shape[1]), np.float32)
    big, small = zero, zero
    for k in range(0, a_hi.shape[1], 8):
        for a, b, into_big in ((a_lo, b_hi, False), (a_hi, b_lo, False),
                               (a_hi, b_hi, True)):
            acc = _rz32((big if into_big else small).astype(np.float64) +
                        a[:, k:k + 8].astype(np.float64) @
                        b[k:k + 8].astype(np.float64))
            if into_big:
                big = acc
            else:
                small = acc
    return big + small


def _quad_sum(v):
    """The epilogue's quad shuffle over t = 0..3 (float32): lane 0 ends
    with (v0 + v1) + (v2 + v3)."""
    return (v[0] + v[1]) + (v[2] + v[3])


def emulate_slab_tc(s, n):
    """slab_tc's statistics (rows, n_nodes, n_xi) float32 from the float32
    densities n (rows, n_bins)."""
    rows, nb = n.shape
    nb8 = -(-nb // 8) * 8
    n_pad = np.zeros((rows, nb8), np.float32)
    n_pad[:, :nb] = n
    a_hi, a_lo = split_tf32(n_pad)
    tot = np.sum(n.astype(np.float64), axis=1).astype(np.float32)
    out = np.zeros((rows, s.n_nodes, s.n_xi), np.float32)
    col_k, col_i0 = s.col_k.numpy(), s.col_i0.numpy()
    for node in range(s.n_nodes):
        b_hi, b_lo = split_tf32(_columns_dense(s, node))
        xi = np.zeros((rows, s.n_xi), np.float32)
        for ct, (s0, steps) in enumerate(zip(s.ct_step0.tolist(),
                                             s.ct_steps.tolist())):
            cols = slice(128 * ct, 128 * ct + 128)
            run = np.zeros((rows, 128), np.float32)
            for q in range(0, steps, 4):
                k = slice(8 * (s0 + q), 8 * (s0 + min(q + 4, steps)))
                run = run + _chunk(a_hi[:, k], a_lo[:, k], b_hi[k, cols],
                                   b_lo[k, cols])
            if not s.auto:
                m = min(128, s.n_xi - 128 * ct)
                out[:, node, 128 * ct:128 * ct + m] = run[:, :m] / tot[:, None]
                continue
            for c in range(16):
                kk, i0 = col_k[16 * ct + c], col_i0[16 * ct + c]
                v = [np.float32(0)] * 4
                for t in range(4):
                    i = i0 + 2 * t
                    # fmaf(n1, r1, n0 * r0): one rounding after the exact
                    # product-sum, with n0 * r0 rounded first.
                    v[t] = (n_pad[:, i + 1].astype(np.float64) *
                            run[:, 8 * c + 2 * t + 1] +
                            (n_pad[:, i] * run[:, 8 * c + 2 * t]).astype(
                                np.float64)).astype(np.float32)
                if kk >= 0:
                    xi[:, kk] = xi[:, kk] + _quad_sum(v)
        if s.auto:
            out[:, node] = xi / (tot * tot)[:, None]
    return tot, out


def _builder_tabs(n_prim, n_sec, n_nodes=4, n_xi=42):
    """The first n_nodes nodes of utils/synthetic's 64-node wide grid
    (n_sec=2), as tabcorr_tpu TabCorrs
    (the same draws; test_torch_grid/test_torch_slab check the builders
    against them)."""
    tabs = []
    for j in range(n_nodes):
        t = synthetic_tabcorr(np.random.default_rng(42), n_prim, n_sec, n_xi,
                              "auto")
        t.tpcf_matrix = t.tpcf_matrix * (1.0 + 0.1 * np.random.default_rng(
            1000 + j).normal(size=t.tpcf_matrix.shape))
        tabs.append(t)
    return tabs


def _densities(stacked, batch, seed):
    model = ttt.Zheng07Model(threshold=-20, redshift=0.0)
    occ = ttt.occupation_functions(model)
    p = _both(_params(batch, seed))[1]
    c = fused.grid_table_constants(stacked, 1) if stacked.mode != "auto" \
        else fused.slab_table_constants(stacked, 1)
    n = fused._plain_ngal(c, {k: v[:, None, None] for k, v in p.items()},
                          *occ)
    return n.numpy(), p


def _exact(dense, n, auto):
    """float64 statistics per node (rows, n_nodes, n_xi), unnormalised."""
    n = n.astype(np.float64)
    if auto:
        return np.einsum("bi,mkij,bj->bmk", n, dense, n)
    return np.einsum("bj,mkj->bmk", n, dense)


def _check_scaled(got, want, what):
    err = _scaled(got.reshape(-1, got.shape[-1]), want.reshape(
        -1, want.shape[-1]))
    assert err <= SCALED, (f"{what}: {err:.3e} scaled > {SCALED:g} "
                           f"(margin {SCALED / err:.2f}x)")
    return err


@pytest.fixture(scope="module")
def wide():
    tabs = _builder_tabs(40, 2)
    stacked = _port_stack(tabs)
    return tabs, stacked, fused.slab_tc_table_constants(stacked, 4)


def test_slab_tc_emulation_meets_the_scaled_contract(wide):
    _, stacked, s = wide
    assert s.n_bins == 160 and s.n_xi == 42 and s.auto
    # The block-triangular half: ~52.5% of the dense multiply-adds at
    # w = 8, plus the rows a column tile spanning two bin tiles repeats.
    share = float(s.ct_steps.sum()) * 8 * 128 / (160 * 160 * 42)
    assert 0.525 <= share < 0.56, share
    n, _ = _densities(stacked, 64, 5)
    tot, xi = emulate_slab_tc(s, n)
    dense = stacked.tpcf_dense.numpy().astype(np.float64).reshape(
        4, 42, 160, 160)
    want = _exact(dense, n, True) / (np.sum(n.astype(np.float64), 1) ** 2)[
        :, None, None]
    err = _check_scaled(xi, want, "slab_tc emulation vs float64")
    print(f"slab_tc emulation vs float64: {err:.3e} scaled "
          f"(margin {SCALED / err:.1f}x)")
    np.testing.assert_allclose(tot, np.sum(n.astype(np.float64), 1),
                               rtol=1e-7)


@pytest.mark.parametrize("kind", ["slab"])
def test_tc_emulation_matches_the_jax_kernels(wide, kind):
    """8 rows through tabcorr_tpu's Pallas kernel (interpret mode) and
    through the emulation fed the port's float32 densities."""
    tabs, stacked, consts = wide
    jax_model = tt.Zheng07Model(threshold=-20, redshift=0.0)
    jax_f = jax_fused.make_fused_grid_predictor(
        _stack(tabs), 4, *jax_pred.occupation_functions(jax_model),
        tuple(jax_model.param_dict), batch_tile=8, interpret=True,
        layout=kind)
    n, p = _densities(stacked, 8, 9)
    p_jax = {k: np.asarray(v) for k, v in p.items()}
    ng_j, xi_j = (np.asarray(a, np.float64) for a in jax_f(p_jax))
    tot, xi = emulate_slab_tc(consts, n)
    np.testing.assert_allclose(tot, ng_j, rtol=1e-6)
    err = _check_scaled(xi, xi_j, f"{kind} emulation vs tabcorr_tpu")
    print(f"{kind} tc emulation vs tabcorr_tpu: {err:.3e} scaled")


def test_emulated_slab_tc_agrees_with_the_plain_version(wide):
    _, stacked, s = wide
    model = ttt.Zheng07Model(threshold=-20, redshift=0.0)
    n, p = _densities(stacked, 16, 4)
    plain = fused.slab_table_constants(stacked, 4)
    tot_p, xi_p = fused.slab_predict_plain(
        plain, p, *ttt.occupation_functions(model))
    tot, xi = emulate_slab_tc(s, n)
    np.testing.assert_allclose(tot, tot_p.numpy(), rtol=1e-6)
    _check_scaled(xi, xi_p.numpy(), "slab_tc emulation vs plain")


# ----------------------------------------------------------------------
# Routing: the contract picks the kernel and its constants
# ----------------------------------------------------------------------
@pytest.mark.parametrize("layout,accuracy,device_type,kind", [
    ("slab", "scaled", "cuda", fused.SlabSplitTable),
    ("slab", "elementwise", "cuda", fused.SlabTcTable),
    ("slab", "scaled", "cpu", fused.SlabTable),
    ("slab", "elementwise", "cpu", fused.SlabTable),
    ("packed", "scaled", "cuda", fused.GridTable),
    ("packed", "elementwise", "cpu", fused.GridTable)])
def test_grid_constants_of_the_tier(layout, accuracy, device_type, kind):
    table = _table("auto", 24, 2, 3, seed=5)
    consts = fused.grid_constants(table, 2, layout, accuracy, device_type)
    assert type(consts) is kind
    want = {("slab", "scaled"): "slab_tc", ("slab", "elementwise"): "slab",
            ("packed", "scaled"): "grid",
            ("packed", "elementwise"): "grid"}[layout, accuracy]
    assert fused.grid_kernel_for(layout, accuracy) == want


@pytest.mark.parametrize("accuracy", ["scaled", "elementwise"])
def test_predictor_builds_only_its_tiers_constants(monkeypatch, accuracy):
    table = _table("auto", 24, 2, 3, seed=6)
    built = []
    for name in ("slab_table_constants", "slab_tc_table_constants",
                 "slab_split_table_constants", "grid_table_constants"):
        real = getattr(fused, name)
        monkeypatch.setattr(fused, name, lambda *a, _n=name, _r=real, **k:
                            built.append(_n) or _r(*a, **k))
    model = ttt.Zheng07Model(threshold=-20)
    f = fused.make_fused_grid_predictor(table, 2, model, accuracy=accuracy,
                                        layout="slab")
    p = _both(_params(3, 1))[1]
    before = (fused.SLAB_LAUNCHES, fused.SLAB_TC_LAUNCHES)
    assert f(p)[1].shape == (3, 2, 3)
    assert (fused.SLAB_LAUNCHES, fused.SLAB_TC_LAUNCHES) == before
    # On the CPU both tiers run the plain version, from the dense slabs.
    assert built == ["slab_table_constants"]


def test_tc_wrappers_need_cuda_and_report_their_shapes():
    table = _table("auto", 24, 2, 3, seed=7)
    s = fused.slab_split_table_constants(table, 2)
    with pytest.raises(ValueError, match="CUDA"):
        fused.slab_tc_launch(s, torch.ones((4, 5)))
    # slab_tc: 128-row blocks (two consumer warpgroups) at the wide grid;
    # 64-row blocks (one) where the densities of 128 rows leave no room
    # for 3 ring slots (400 bins), as far as the slab kernel goes.
    assert fused.slab_tc_config(160, 42) == (2, 4)
    assert fused.slab_tc_config(400, 42) == (1, 4)
    assert fused.contraction_fits(736, 42) and fused.slab_tc_config(736, 42)
    assert not fused.contraction_fits(800, 42)
    assert fused.grid_kernel_takes(400, "auto", 42)


@pytest.mark.parametrize("kernel", ["slab_tc"])
def test_tc_kernels_take_every_shape_their_fp32_twins_take(kernel):
    """Wherever the FP32 slab kernel's block fits in shared memory,
    slab_tc's does: the 'scaled' tier never refuses a shape the
    'elementwise' tier takes."""
    taken = 0
    for n_xi in (1, 4, 13, 42, 100, 300, 700):
        for n_bins in range(1, 1700, 7):
            if fused.contraction_fits(n_bins, n_xi):
                taken += 1
                assert fused.slab_tc_config(n_bins, n_xi), (n_bins, n_xi)
    assert taken > 500
