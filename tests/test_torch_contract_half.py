"""The contraction of csrc/contract.cuh on the CPU: the block-triangular
half layout that the bundle, contraction and slab kernels read, a float32
emulation of the FP32 tier in the kernel's summation order, held against
the JAX bundle kernel under the headline contracts too, the constants each
route of make_multi_predictor builds, and the blocks' shared-memory fit.

The FP32 emulation follows contract_fp32: per column of a column tile one
fmaf chain over the K rows of each ring stage in ascending order (cross
mode: over all of the tile's rows), after each stage an fmaf chain over
the 8 bins of an n8 tile that runs on through the column tile's stages,
the pair rule (two n8 tiles of one aligned pair that hold the same
statistic are summed before they are added), the statistics accumulated
in column-tile order, sum_i n_i in double, and the float32 division at
the end.  A fused multiply-add is
taken as the float64 product (exact) added to the float32 accumulator in
float64 and rounded to float32 once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.ops.fused import make_fused_bundle_predictor
from tabcorr_tpu.predictor import occupation_functions
from tabcorr_tpu_torch.ops import fused

from test_torch_bundle import NAMES, _error, _params, tabs  # noqa: F401
from test_torch_tf32x3 import _columns_dense, _layout_contraction, _table


def _fma(a, b, c):
    """fmaf(a, b, c) on float32 arrays."""
    return (a.astype(np.float64) * b.astype(np.float64) +
            c.astype(np.float64)).astype(np.float32)


def emulate_fp32(s, n, stage_rows=32):
    """contract_fp32's (totals, statistics (rows, n_nodes, n_xi)) float32
    from the float32 densities n (rows, n_bins) and the half layout s, with
    ring stages of ``stage_rows`` K rows (None: one stage per column tile,
    the order of one fmaf chain over all of a column's rows)."""
    rows, nb = n.shape
    nb8 = -(-nb // 8) * 8
    n_pad = np.zeros((rows, nb8), np.float32)
    n_pad[:, :nb] = n
    tot = np.sum(n.astype(np.float64), axis=1).astype(np.float32)
    out = np.zeros((rows, s.n_nodes, s.n_xi), np.float32)
    col_k, col_i0 = s.col_k.numpy(), s.col_i0.numpy()
    for node in range(s.n_nodes):
        b = _columns_dense(s, node)
        xi = np.zeros((rows, s.n_xi), np.float32)
        for ct, (s0, steps) in enumerate(zip(s.ct_step0.tolist(),
                                             s.ct_steps.tolist())):
            cols = slice(128 * ct, 128 * ct + 128)
            first, last = 8 * s0, 8 * (s0 + steps)
            if not s.auto:
                acc = np.zeros((rows, 128), np.float32)
                for j in range(first, last):
                    acc = _fma(n_pad[:, j, None], b[None, j, cols], acc)
                m = min(128, s.n_xi - 128 * ct)
                out[:, node, 128 * ct:128 * ct + m] = acc[:, :m] / tot[:, None]
                continue
            ks = col_k[16 * ct:16 * ct + 16]
            v = np.zeros((rows, 16), np.float32)
            for lo in range(first, last, stage_rows or last - first):
                acc = np.zeros((rows, 128), np.float32)
                for j in range(lo, min(lo + (stage_rows or last), last)):
                    acc = _fma(n_pad[:, j, None], b[None, j, cols], acc)
                for c in range(16):
                    i0 = col_i0[16 * ct + c]
                    for e in range(8):
                        v[:, c] = _fma(n_pad[:, i0 + e], acc[:, 8 * c + e],
                                       v[:, c])
            for c in range(16):
                k = ks[c]
                paired = k >= 0 and k == ks[c ^ 1]
                if k < 0 or (paired and c & 1):
                    continue
                xi[:, k] = xi[:, k] + (v[:, c] + v[:, c + 1] if paired
                                       else v[:, c])
        if s.auto:
            out[:, node] = xi / (tot * tot)[:, None]
    return tot, out


def _densities(table, model, params):
    """The port's float32 densities n[b, i] on the CPU."""
    c = fused.bundle_table_constants(table)
    p = {k: torch.tensor(v)[:, None, None] for k, v in params.items()}
    return fused._plain_ngal(c, p, *ttt.occupation_functions(model)).numpy()


def _host(tab, redshift, params, i):
    model = ttt.Zheng07Model(threshold=-18, redshift=redshift)
    for k in NAMES:
        model.param_dict[k] = float(params[k][i])
    return tab.predict(model, check_consistency=False)


# ----------------------------------------------------------------------
# (a) the half layout of the bundle tables
# ----------------------------------------------------------------------
@pytest.mark.parametrize("stat", ["wp", "xi", "ds"])
def test_half_layout_of_the_bundle_tables_equals_the_dense_contraction(
        tabs, stat):
    table = tabs[stat][1].table_data(device="cpu")
    h = fused.slab_tc_table_constants(table, 1)
    c = fused.bundle_table_constants(table)
    assert h.n_nodes == 1 and h.auto == c.auto == (stat != "ds")
    assert (h.n_bins, h.n_centrals, h.n_xi) == (c.n_bins, c.n_centrals,
                                                c.n_xi)
    for name in ("logm", "logm_res", "sec", "weight"):
        assert torch.equal(getattr(h, name), getattr(c, name)), name
    dense = table.tpcf_dense.double().numpy()
    n = 10.0 ** np.random.default_rng(2).uniform(-6, -2, (7, h.n_bins))
    want = (np.einsum("bi,kij,bj->bk", n, dense, n) if h.auto
            else n @ dense.T)
    np.testing.assert_allclose(_layout_contraction(h, 0, n), want,
                               rtol=1e-12, atol=0)
    if h.auto:
        # About half of the dense multiply-adds; the padding of the last
        # bin tile and column tile weighs more at 60 bins than at 120.
        share = float(h.ct_steps.sum()) * 8 * 128 / (h.n_xi * h.n_bins ** 2)
        assert 0.5 < share < (0.72 if h.n_bins < 100 else 0.6), share


def test_dense_layout_stays_the_plain_versions():
    table = _table("auto", 37, 1, 5, seed=3)
    dense = fused.bundle_table_constants(table)
    assert dense.f_t.shape == (64, 256)
    half = fused.slab_tc_table_constants(table, 1)
    n = torch.tensor(10.0 ** np.random.default_rng(1).uniform(
        -6, -2, (5, 37)), dtype=torch.float32)
    # The plain version on the dense layout equals the float64 contraction
    # of the half layout.
    n64 = n.double().numpy()
    want = _layout_contraction(half, 0, n64) / (n64.sum(1) ** 2)[:, None]
    _, xi = fused.contraction_plain(dense, n)
    np.testing.assert_allclose(xi.double().numpy(), want, rtol=2e-6)


# ----------------------------------------------------------------------
# (b) the FP32 tier in the kernel's summation order
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["auto", "cross"])
@pytest.mark.parametrize("n_bins,width", [(37, 8), (160, 8), (40, 16)])
def test_fp32_emulation_equals_the_float64_contraction(mode, n_bins, width):
    n_nodes, n_xi = 2, 5
    table = _table(mode, n_bins, n_nodes, n_xi, seed=n_bins)
    s = fused.slab_tc_table_constants(table, n_nodes, width=width)
    n = (10.0 ** np.random.default_rng(4).uniform(-6, -2, (6, n_bins))
         ).astype(np.float32)
    tot, xi = emulate_fp32(s, n)
    n64 = n.astype(np.float64)
    den = n64.sum(1) ** 2 if mode == "auto" else n64.sum(1)
    for node in range(n_nodes):
        want = _layout_contraction(s, node, n64) / den[:, None]
        # Positive terms only: per element, a few float32 roundings.
        np.testing.assert_allclose(xi[:, node], want, rtol=1e-6)
    np.testing.assert_allclose(tot, n64.sum(1), rtol=1e-7)


def test_fp32_emulation_sums_a_paired_statistic_once():
    """n_xi = 1 puts the same statistic in both n8 tiles of every aligned
    pair: the even one adds the sum of both."""
    table = _table("auto", 40, 1, 1, seed=8)
    s = fused.slab_tc_table_constants(table, 1)
    pairs = s.col_k.numpy().reshape(-1, 2)
    assert np.any((pairs[:, 0] == 0) & (pairs[:, 1] == 0))
    n = (10.0 ** np.random.default_rng(5).uniform(-6, -2, (4, 40))
         ).astype(np.float32)
    _, xi = emulate_fp32(s, n)
    n64 = n.astype(np.float64)
    want = _layout_contraction(s, 0, n64) / (n64.sum(1) ** 2)[:, None]
    np.testing.assert_allclose(xi[:, 0], want, rtol=1e-6)


@pytest.mark.parametrize("box,batch", [("bench", 13), ("wide", 16)])
def test_fp32_emulation_meets_the_per_element_contract_on_wp(tabs, box,
                                                             batch):
    tab = tabs["wp"][1]
    redshift = float(tab.attrs["redshift"])
    model = ttt.Zheng07Model(threshold=-18, redshift=redshift)
    params = _params(box, batch)
    table = tab.table_data(device="cpu")
    s = fused.slab_tc_table_constants(table, 1)
    tot, xi = emulate_fp32(s, _densities(table, model, params))
    worst = 0.0
    for i in range(batch):
        ng64, xi64 = _host(tab, redshift, params, i)
        worst = max(worst, _error("wp", xi[i, 0].astype(np.float64), xi64))
        assert abs(float(tot[i]) / ng64 - 1) <= 1e-6, i
    print(f"FP32 emulation vs float64 host, wp, {box}: {worst:.3e} per "
          "element")
    assert worst <= 1e-6


def test_fp32_emulation_per_stage_chains_are_closer_on_xi_ell(tabs):
    """Folding every 32-row stage into the carried sums (what the kernel
    does; 16 rows where shared memory is short) against one fmaf chain
    over all of a column's rows: all within the scaled contract of the
    float64 contraction of the same densities, the 32-row chains closer
    than the whole-column ones."""
    tab = tabs["xi"][1]
    model = ttt.Zheng07Model(threshold=-18,
                             redshift=float(tab.attrs["redshift"]))
    table = tab.table_data(device="cpu")
    s = fused.slab_tc_table_constants(table, 1)
    n = _densities(table, model, _params("bench", 256, seed=3))
    n64 = n.astype(np.float64)
    want = _layout_contraction(s, 0, n64) / (n64.sum(1) ** 2)[:, None]
    worst = {}
    for stage_rows in (32, 16, None):
        _, xi = emulate_fp32(s, n, stage_rows)
        worst[stage_rows] = max(_error("xi", xi[i, 0].astype(np.float64),
                                       want[i]) for i in range(len(n)))
    print(f"FP32 emulation vs float64 of the same densities, xi_ell, scaled: "
          f"{worst}")
    assert max(worst.values()) <= 1e-6
    assert worst[32] < worst[None]


# ----------------------------------------------------------------------
# (c) the FP32 route under the headline contracts, both tables (on the
# card xi_ell 'scaled' takes the tensor-core route:
# test_torch_bundle_tc.py)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("box,batch", [("bench", 13), ("wide", 16)])
def test_bundle_emulation_meets_the_contracts_and_the_jax_bundle(
        tabs, box, batch):
    accuracy = ("elementwise", "scaled")
    redshift = float(tabs["wp"][0].attrs["redshift"])
    params = _params(box, batch)
    jax_model = tt.Zheng07Model(threshold=-18, redshift=redshift)
    jax_fn = make_fused_bundle_predictor(
        [tabs[s][0].table_data(n_gauss=10, dtype=jnp.float32)
         for s in ("wp", "xi")],
        *occupation_functions(jax_model), NAMES, batch_tile=8,
        interpret=True, accuracy=accuracy)
    jax_out = jax_fn({k: jnp.asarray(v) for k, v in params.items()})
    model = ttt.Zheng07Model(threshold=-18, redshift=redshift)
    for stat, (ng_j, xi_j) in zip(("wp", "xi"), jax_out):
        tab = tabs[stat][1]
        table = tab.table_data(device="cpu")
        s = fused.slab_tc_table_constants(table, 1)
        tot, xi = emulate_fp32(s, _densities(table, model, params))
        worst = worst_jax = 0.0
        for i in range(batch):
            ng64, xi64 = _host(tab, redshift, params, i)
            got = xi[i, 0].astype(np.float64)
            worst = max(worst, _error(stat, got, xi64))
            worst_jax = max(worst_jax, _error(
                stat, got, np.asarray(xi_j[i], np.float64)))
            assert abs(float(tot[i]) / ng64 - 1) <= 1e-6, (stat, i)
            assert abs(float(tot[i]) / float(ng_j[i]) - 1) <= 1e-6, (stat, i)
        print(f"bundle emulation, {stat}, {box}: {worst:.3e} vs float64, "
              f"{worst_jax:.3e} vs the JAX bundle")
        # Each within its contract of the float64 host path (wp per
        # element, xi_ell scaled), though the JAX kernel drops MXU passes
        # for xi_ell; the two kernels within the same figure of each other.
        assert worst <= 1e-6, stat
        assert worst_jax <= 1e-6, stat


# ----------------------------------------------------------------------
# (d) routing: the device picks the layout, no contract another kernel
# ----------------------------------------------------------------------
def test_bundle_predictor_checks_the_contracts_it_is_given(tabs):
    tables = [tabs[s][1].table_data(device="cpu") for s in ("wp", "xi")]
    model = ttt.Zheng07Model(threshold=-18,
                             redshift=tabs["wp"][1].attrs["redshift"])
    with pytest.raises(ValueError, match="Unknown accuracy"):
        fused.make_fused_bundle_predictor(tables, model,
                                          ("elementwise", "tensor"))
    with pytest.raises(ValueError, match="one contract per table"):
        fused.make_fused_bundle_predictor(tables, model, ("scaled",))
    # On the CPU both contracts run the plain version: the same bits.
    params = {k: torch.tensor(v) for k, v in _params("bench", 5).items()}
    outs = [fused.make_fused_bundle_predictor(tables, model, a)(params)
            for a in (None, ("elementwise", "scaled"), ("scaled", "scaled"))]
    for out in outs[1:]:
        for (ng, xi), (ng0, xi0) in zip(out, outs[0]):
            assert torch.equal(ng, ng0) and torch.equal(xi, xi0)


@pytest.mark.parametrize("accuracy", [None, ("elementwise", "scaled"),
                                      ("scaled", "scaled")])
def test_bundle_predictor_builds_only_its_routes_constants(tabs, monkeypatch,
                                                           accuracy):
    built = []
    for name in ("slab_tc_table_constants", "_contraction_matrices"):
        real = getattr(fused, name)
        monkeypatch.setattr(fused, name, lambda *a, _n=name, _r=real, **k:
                            built.append(_n) or _r(*a, **k))
    model = ttt.Zheng07Model(threshold=-18,
                             redshift=tabs["wp"][1].attrs["redshift"])
    predict = ttt.make_multi_predictor([tabs["wp"][1], tabs["xi"][1]], model,
                                       device="cpu", accuracy=accuracy)
    # On the CPU every contract runs the plain version, from the dense
    # matrices: the half layout is never built, and nothing is launched.
    assert built == ["_contraction_matrices"] * 2
    params = {k: torch.tensor(v) for k, v in _params("bench", 5).items()}
    before = fused.BUNDLE_LAUNCHES
    (_, wp), (_, xi) = predict(params)
    assert fused.BUNDLE_LAUNCHES == before
    assert wp.shape == (5, 19) and xi.shape == (5, 3, 14)


def test_contraction_predictor_builds_only_its_routes_constants(tabs,
                                                                monkeypatch):
    built = []
    real = fused.slab_tc_table_constants
    monkeypatch.setattr(fused, "slab_tc_table_constants",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    tab = tabs["wp"][1]
    model = ttt.Zheng07Model(threshold=-18, redshift=tab.attrs["redshift"])
    predict = ttt.make_predictor(tab, model, engine="fused", device="cpu")
    before = fused.CONTRACTION_LAUNCHES
    params = {k: torch.tensor(v) for k, v in _params("bench", 5).items()}
    assert predict(params)[1].shape == (5, 19)
    assert fused.CONTRACTION_LAUNCHES == before and not built


@pytest.mark.parametrize("kernel", ["bundle", "contraction"])
@pytest.mark.parametrize("layout", ["half", "dense", "two nodes"])
def test_cuda_wrappers_refuse_cpu_tensors_whatever_the_layout(tabs, kernel,
                                                              layout):
    table = tabs["wp"][1].table_data(device="cpu")
    consts = {"half": lambda: fused.slab_tc_table_constants(table, 1),
              "dense": lambda: fused.bundle_table_constants(table),
              "two nodes": lambda: fused.slab_tc_table_constants(
                  _table("auto", 60, 2, 19, seed=1), 2)}[layout]()
    before = (fused.BUNDLE_LAUNCHES, fused.CONTRACTION_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "bundle":
            fused.bundle_launch([consts], torch.ones((4, 5)))
        else:
            fused.contraction_launch(consts, torch.ones((4, 60)))
    assert (fused.BUNDLE_LAUNCHES, fused.CONTRACTION_LAUNCHES) == before


# ----------------------------------------------------------------------
# (e) the blocks fit wherever the former ones did
# ----------------------------------------------------------------------
def _former_fp32_bytes(n_bins, n_xi):
    """Shared memory of the former FP32 contraction block: 64 rows'
    densities over the bins rounded up to 32, a 32 x 128 staged tile, a
    64 x 32 partial-sum tile, the statistics and the row terms."""
    k_pad = -(-n_bins // 32) * 32
    return 4 * (k_pad * 64 + 32 * 128 + 64 * 32 + 64 * n_xi + 9 * 64)


N_XI = (1, 4, 13, 19, 42, 100, 300, 700)


def test_fp32_blocks_fit_wherever_the_former_block_did():
    taken = small_ring = 0
    for n_xi in N_XI:
        for n_bins in range(1, 1000, 5):
            if _former_fp32_bytes(n_bins, n_xi) <= fused._SMEM_LIMIT:
                taken += 1
                stage_steps = fused.fp32_stage_steps(n_bins, n_xi)
                assert stage_steps in (4, 2), (n_bins, n_xi)
                small_ring += stage_steps == 2
                assert fused.contraction_fits(n_bins, n_xi)
                assert fused.grid_kernel_takes(max(n_bins, 128), "auto",
                                               n_xi) or n_bins < 128
    assert taken > 500 and small_ring > 0
    assert fused.fp32_stage_steps(160, 42) == 4
    assert fused.fp32_stage_steps(768, 5) == 2
    assert fused.fp32_stage_steps(1000, 5) is None


def test_slab_tc_takes_every_shape_the_fp32_blocks_take():
    taken = two = 0
    for n_xi in N_XI:
        for n_bins in range(1, 1000, 5):
            if fused.fp32_stage_steps(n_bins, n_xi) is None:
                continue
            taken += 1
            block = fused.slab_tc_config(n_bins, n_xi)
            assert block is not None, (n_bins, n_xi)
            two += block[0] == 2
    assert taken > 500 and 0 < two < taken
    # The wide grid: 128-row blocks of two consumer warpgroups.  slab_tc's
    # 64-row block needs less shared memory than the FP32 kernels' (a
    # smaller ring at the limit, no row totals), and no more bins: past the
    # FP32 block's 1000 bins neither fits.
    assert fused.slab_tc_config(160, 42)[0] == 2
    assert fused.slab_tc_config(1000, 5) is None
    assert fused.slab_tc_config(1600, 5) is None
