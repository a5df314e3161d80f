"""The bundle kernel's tensor-core route on the CPU: which tables take it,
the split constants it reads, its arithmetic emulated, its counter and the
wrapper's refusals.

On the card the bundle kernel (csrc/bundle.cu) contracts every 'scaled'
auto table in 3xTF32 on wgmma from the table's split constants
(``fused.slab_split_table_constants(table, 1)``), walking the stages in
slab_tc's order for one node: chunks of <= 4 k-steps into two fresh
accumulators, each chunk folded into the epilogue's per-lane sums, the
quad reduction at each column tile's end (``emulate_split`` of
test_torch_slab_wgmma.py emulates exactly that walk).  These tests hold
the emulation at xi_ell's shape (synthetic_xi_ell.npz: 120 bins, 3 x 14
statistics) to the 'scaled' contract against float64 over the parameter
box of the zheng07_wp_xiell benchmark configuration, and to the FP32
route's plain version; every other table keeps the FP32 route.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.utils import profiling

from test_torch_slab_wgmma import _stages, emulate_split
from test_torch_tf32x3 import SCALED, _check_scaled, _exact, _table

ROOT = Path(__file__).absolute().parents[1]
DATA = ROOT / "tabcorr_tpu_torch" / "data"
CONFIG = ROOT / "benchmark" / "configs" / "zheng07_wp_xiell.json"
NAMES = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")


@pytest.fixture(scope="module")
def tabs():
    return [ttt.TabCorr.read(DATA / f"{f}.npz")
            for f in ("bolplanck_wp", "synthetic_xi_ell")]


@pytest.fixture(scope="module")
def xi_ell(tabs):
    """xi_ell's table, its split constants and its plain constants."""
    table = tabs[1].table_data(device="cpu")
    return (table, fused.slab_split_table_constants(table, 1),
            fused.bundle_table_constants(table))


def _box_params(batch, seed):
    """float32 zheng07 parameters uniform over the configuration's flat
    priors, the first rows (up to 32) on the box's 32 corners."""
    bounds = json.loads(CONFIG.read_text())["bounds"]
    rng = np.random.default_rng(seed)
    p = {k: rng.uniform(*bounds[k], batch) for k in NAMES}
    for row in range(min(batch, 2 ** len(NAMES))):
        for j, k in enumerate(NAMES):
            p[k][row] = bounds[k][(row >> j) & 1]
    return {k: torch.tensor(v.astype(np.float32)) for k, v in p.items()}


def _densities(c, model, params):
    p = {k: v[:, None, None] for k, v in params.items()}
    return fused._plain_ngal(c, p, *ttt.occupation_functions(model)).numpy()


def _model(tabs):
    return ttt.Zheng07Model(threshold=-18, redshift=tabs[0].attrs["redshift"])


# ----------------------------------------------------------------------
# The route
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["auto", "cross"])
@pytest.mark.parametrize("accuracy", ["elementwise", "scaled"])
def test_bundle_route_by_contract_and_mode(mode, accuracy):
    table = _table(mode, 24, 1, 3, seed=5)
    routes = fused.bundle_routes([table, table], (accuracy, "elementwise"))
    assert routes == [("tc" if (mode, accuracy) == ("auto", "scaled")
                       else "fp32"), "fp32"]
    assert fused.bundle_routes([table]) == ["fp32"]


@pytest.mark.parametrize("accuracy,tc", [
    (None, 0), (("elementwise", "elementwise"), 0),
    (("elementwise", "scaled"), 1), (("scaled", "elementwise"), 1),
    (("scaled", "scaled"), 2)])
def test_bundle_constants_follow_the_route(tabs, accuracy, tc):
    """The constants the predictor builds on the card, by route: split
    for each 'scaled' auto table, the FP32 half layout for the others; the
    launch counts the split ones as its tensor-core tables."""
    tables = [t.table_data(device="cpu") for t in tabs]
    consts = fused.bundle_constants(tables, accuracy)
    kinds = [type(c) for c in consts]
    assert kinds.count(fused.SlabSplitTable) == tc
    assert fused.bundle_tc_tables(consts) == tc
    for c, a in zip(consts, fused.check_accuracy(accuracy, 2)):
        assert isinstance(c, fused.SlabSplitTable) == (a == "scaled")
        assert c.n_nodes == 1


def test_cross_tables_stay_fp32_under_scaled():
    tables = [_table("cross", 45, 1, 3, seed=3), _table("auto", 37, 1, 5,
                                                        seed=2)]
    consts = fused.bundle_constants(tables, ("scaled", "scaled"))
    assert isinstance(consts[0], fused.SlabTcTable)
    assert isinstance(consts[1], fused.SlabSplitTable)
    assert fused.bundle_tc_tables(consts) == 1


def test_launch_counts_its_tensor_core_tables_in_its_span(monkeypatch):
    """bundle_launch adds each launch's tensor-core tables to
    BUNDLE_TC_TABLES and records them as the ``tc_tables`` count of its
    ``fused.bundle_launch`` span (the kernel call stubbed: no card)."""
    monkeypatch.setattr(fused, "_bundle_launch",
                        lambda consts, pmat, hod: ([], len(consts) - 1))
    before = (fused.BUNDLE_LAUNCHES, fused.BUNDLE_TC_TABLES)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        start = len(profiling.recorded())
        fused.bundle_launch([None, None], None)
        fused.bundle_launch([None], None)
        spans = profiling.recorded()[start:]
    assert (fused.BUNDLE_LAUNCHES, fused.BUNDLE_TC_TABLES) == (
        before[0] + 2, before[1] + 1)
    counts = [s.counts for s in spans if s.name == "fused.bundle_launch"]
    assert counts == [{"tc_tables": 1}, {"tc_tables": 0}]


# ----------------------------------------------------------------------
# The split constants of xi_ell and the kernel's arithmetic on them
# ----------------------------------------------------------------------
def test_xi_ell_split_constants_are_one_node_of_stages(xi_ell):
    table, s, _ = xi_ell
    half = fused.slab_tc_table_constants(table, 1)
    assert (s.n_bins, s.n_xi, s.n_nodes, s.auto) == (120, 42, 1, True)
    assert s.node_steps == int(s.ct_steps.sum())
    assert s.b.shape == (1, s.node_steps * 2 * 128 * 8)
    for name in ("ct_step0", "ct_steps", "col_k", "col_i0"):
        assert torch.equal(getattr(s, name), getattr(half, name)), name
    # Twice the FP32 layout's bytes: 2.64 MB, streamed once a block.
    assert s.b.numel() == 2 * half.b.numel() == 659456
    hi, lo = _stages(s, 0)
    assert not np.any(hi.view(np.uint32) & 0x1FFF)
    assert not np.any(lo.view(np.uint32) & 0x1FFF)


@pytest.mark.parametrize("seed", [3, 4])
def test_tc_emulation_meets_the_scaled_contract_over_the_config_box(
        tabs, xi_ell, seed):
    table, s, c = xi_ell
    params = _box_params(64, seed)
    n = _densities(c, _model(tabs), params)
    assert np.all(np.isfinite(n)) and np.all(n.sum(axis=1) > 0)
    tot, xi = emulate_split(s, n)
    dense = table.tpcf_dense.double().numpy()[None]
    tot64 = np.sum(n.astype(np.float64), 1)
    want = _exact(dense, n, True) / (tot64 ** 2)[:, None, None]
    err = _check_scaled(xi, want, "bundle tensor-core emulation vs float64, "
                        "xi_ell over the configuration's box")
    print(f"bundle tensor-core route, xi_ell, config box: {err:.3e} scaled "
          f"vs float64 (margin {SCALED / err:.1f}x)")
    np.testing.assert_allclose(tot, tot64, rtol=1e-7)


def test_tc_emulation_agrees_with_the_fp32_routes_plain_version(tabs,
                                                                xi_ell):
    """The FP32 route's plain version (float32 densities, the contraction
    in float64) on the same rows: within the 'scaled' contract."""
    _, s, c = xi_ell
    model = _model(tabs)
    params = _box_params(32, 7)
    (tot_p, xi_p), = fused.bundle_predict_plain(
        [c], params, *ttt.occupation_functions(model))
    tot, xi = emulate_split(s, _densities(c, model, params))
    np.testing.assert_array_equal(tot, tot_p.numpy())
    err = _check_scaled(xi, xi_p.double().numpy()[:, None],
                        "tensor-core emulation vs the FP32 plain version")
    print(f"bundle tensor-core route vs the FP32 plain version: {err:.3e}")


def test_tc_emulation_keeps_nan_rows(tabs, xi_ell):
    """A row whose parameters are NaN has NaN densities, sum and
    statistics on the tensor-core route too; the other rows keep their
    values bit for bit."""
    _, s, c = xi_ell
    model = _model(tabs)
    params = _box_params(16, 9)
    _, clean = emulate_split(s, _densities(c, model, params))
    for k in ("logMmin", "alpha"):
        params[k][[3, 11]] = float("nan")
    tot, xi = emulate_split(s, _densities(c, model, params))
    nan_rows = np.isnan(xi).all(axis=(1, 2))
    assert nan_rows.tolist() == [i in (3, 11) for i in range(16)]
    assert np.isnan(tot[[3, 11]]).all()
    np.testing.assert_array_equal(xi[~nan_rows], clean[~nan_rows])


# ----------------------------------------------------------------------
# The wrapper's refusals and the block's fit
# ----------------------------------------------------------------------
def test_bundle_wrapper_refuses_what_the_tensor_core_route_does_not_take():
    cpu = torch.device("cpu")
    auto = _table("auto", 24, 2, 3, seed=7)
    cross = _table("cross", 24, 1, 3, seed=8)
    two_nodes = fused.slab_split_table_constants(auto, 2)
    with pytest.raises(ValueError, match="1 node"):
        fused._check_bundle_table(two_nodes, cpu)
    with pytest.raises(ValueError, match="auto tables only"):
        fused._check_bundle_table(fused.slab_split_table_constants(cross, 1),
                                  cpu)
    with pytest.raises(ValueError, match="half layout"):
        fused._check_bundle_table(fused.bundle_table_constants(cross), cpu)
    one = fused.slab_split_table_constants(_table("auto", 24, 1, 3, seed=9),
                                           1)
    fused._check_bundle_table(one, cpu)
    fused._check_bundle_table(fused.slab_tc_table_constants(cross, 1), cpu)
    with pytest.raises(ValueError, match="float32"):
        fused._check_bundle_table(one, torch.device("cuda", 0))
    # CPU tensors never launch, whatever the route.
    before = (fused.BUNDLE_LAUNCHES, fused.BUNDLE_TC_TABLES)
    with pytest.raises(ValueError, match="CUDA"):
        fused.bundle_launch([one], torch.ones((4, 5)))
    assert (fused.BUNDLE_LAUNCHES, fused.BUNDLE_TC_TABLES) == before


def test_tensor_core_block_of_the_bench_tables():
    """The tensor-core block: its ring of 4 slots of 8 KB (consumer 0's
    FP32 ring before the producer fills it) and their barriers, consumer
    1's FP32 ring at the FP32-only block's stage (so the 'elementwise'
    tables keep their bits), then 128 rows of every table's densities, the
    statistics, parameter terms and totals; one block an SM."""
    shapes = [(60, 19), (120, 42)]
    assert fused.fp32_stage_steps(120, 42) == 4
    assert fused._bundle_smem_bytes(shapes, tc=False) == \
        fused._fp32_smem_bytes(4, 120, 42) == 76544
    assert fused._bundle_smem_bytes(shapes, tc=True) == (
        4 * 8192 + 16 * 4 + 4 * 8192 + 4 * 128 * (64 + 120 + 42 + 9)) == \
        185920
    assert fused.bundle_takes(shapes)
    assert not fused.bundle_takes(shapes * 3)


def test_scaled_tables_take_the_fp32_route_where_the_block_does_not_fit():
    """Where the tensor-core block would not hold the tables' densities
    (768 bins: 393 KB for 128 rows), every table takes the FP32 route,
    which meets both contracts; the FP32 block fits with its smaller
    ring.  Nothing is refused that the FP32 block takes."""
    wide = _table("auto", 768, 1, 5, seed=6)
    assert fused._bundle_smem_bytes([(768, 5)], tc=True) is None
    assert fused._bundle_smem_bytes([(768, 5)], tc=False) is not None
    assert fused.bundle_routes([wide], ("scaled",)) == ["fp32"]
    small = _table("auto", 120, 1, 42, seed=4)
    assert fused.bundle_routes([small, small], ("scaled", "scaled")) == \
        ["tc", "tc"]
    assert fused.bundle_routes([small, wide], ("scaled", "scaled")) == \
        ["fp32", "fp32"]
    consts = fused.bundle_constants([wide], ("scaled",))
    assert fused.bundle_tc_tables(consts) == 0
