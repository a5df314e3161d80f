"""The sharded pair-count sweep, ``labeled_pair_count(mesh=)``, and
``TabCorr.tabulate(mesh=)`` in a CPU ``gloo`` world of 4 ranks.

One world per module (``world``) runs
``torch_parallel_workers.sweep_rank``: every rank counts the i-tracers
against its block of the j-tracers with the plain version and one
all-reduce sums the histograms.  The parent holds each rank's counts
against tabcorr_tpu's mesh path (``_sweep_block_sharded`` on 8 virtual CPU
devices) and its ``strategy="scatter"`` sweep, as tests/test_parallel.py
holds them, and against the port's unsharded sweep:

* unit counts exactly, in auto mode (the self-pair test across blocks)
  and cross mode.  The port's counts (sharded and not) equal a numpy
  brute force in its float32 geometry, rp^2 = dx*dx + dy*dy rounded after
  each operation as on the card and the TPU; tabcorr_tpu's counts on the
  CPU (mesh path and scatter alike) equal the same brute force with rp^2
  = fma(dx, dx, dy*dy), the contraction XLA's CPU compiler makes.  On
  these tracers one cross pair lies one float32 ulp below an edge and
  moves with it (``cross_unit``: one count in one cell); every other cell
  is equal in all four;
* weighted and 'unit+log_rp' sweeps within 1e-12 of the port's unsharded
  sweep (float64 sums in another order) and within 5e-4 of tabcorr_tpu's
  mesh path, which accumulates each block in float32 (its own test's
  bar);
* ``tabulate(mesh=)`` equal to ``tabulate()``: wp from unit counts bit
  for bit, Delta Sigma from float64 sums within 1e-12.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tabcorr_tpu.ops.paircount as jpc
import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch.ops.paircount import labeled_pair_count
from tabcorr_tpu_torch.parallel.mesh import run_world
from tabcorr_tpu_torch.utils.synthetic import synthetic_halocat

from torch_parallel_workers import sweep_rank

L = 50.0
RP = np.logspace(-0.5, 1.2, 6)
MU = np.linspace(0.0, 1.0, 5)


def _cases():
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, L, (1500, 3))
    labels = rng.integers(-1, 4, 1500).astype(np.int32)
    ptcl = rng.uniform(0, L, (2500, 3))
    weights = rng.uniform(0.5, 2.0, 2500)
    auto = dict(pos1=pos, labels1=labels, n_labels_1=4, period=L)
    cross = dict(auto, pos2=ptcl, kind="proj", r_edges=RP)
    return {
        "auto_rppi": dict(auto, kind="rppi", r_edges=RP, pi_max=10.0),
        "auto_smu": dict(auto, kind="smu", r_edges=RP, mu_edges=MU),
        "cross_unit": cross,
        "cross_weighted": dict(cross, weights2=weights),
        "cross_both": dict(cross, weights2=weights,
                           pair_weight="unit+log_rp"),
    }


# ~9,300 tracers.
TAB_HALOS = dict(n_halos=1000, lbox=80.0, seed=4)
TAB_PTCL = np.random.default_rng(5).uniform(0, 80.0, (2000, 3))
TAB_BASE = dict(prim_haloprop_bins=4, Num_ptcl_requirement=300,
                sats_per_prim_haloprop=3e-13, seed=13)
TAB_CASES = {
    "wp": ("wp", (RP, 20.0), dict(TAB_BASE, mode="auto")),
    "ds": ("mean_delta_sigma", (TAB_PTCL, 5e8, RP),
           dict(TAB_BASE, mode="cross")),
}


@pytest.fixture(scope="module")
def world():
    results = run_world(sweep_rank, 4, "gloo", "cpu", args=(
        _cases(), {"halocat": TAB_HALOS, "cases": TAB_CASES}))
    return results


@pytest.fixture(autouse=True)
def xla_sweep(monkeypatch):
    monkeypatch.setattr(jpc, "_native_eligible", lambda *a: False)


def _jax(case, **kw):
    args = dict(_cases()[case])
    args.update(kw)
    return jpc.labeled_pair_count(
        args.pop("pos1"), args.pop("labels1"), args.pop("n_labels_1"),
        **args)


def _jax_mesh():
    return Mesh(np.array(jax.devices()), ("shard",))


def _f32(x):
    return np.asarray(x, np.float32)


def _brute_force(c, fma):
    """The unit histogram of sweep ``c`` by a numpy loop over i-tracers,
    in float32 geometry; rp^2 (and s^2) rounded after each operation, or
    (``fma``) each last product-add rounded once as XLA contracts it."""
    period = np.float32(c["period"])
    p1, l1 = _f32(c["pos1"]), c["labels1"]
    auto = "pos2" not in c
    p2 = p1 if auto else _f32(c["pos2"])
    l2 = l1 if auto else np.zeros(len(p2), np.int64)
    edges = _f32(np.asarray(c["r_edges"], np.float64) ** 2)
    n_r = len(edges) - 1
    smu = c["kind"] == "smu"
    mu_edges = _f32(c["mu_edges"]) if smu else None
    n_mu = len(mu_edges) - 1 if smu else 1
    hist = np.zeros((4, 4 if auto else 1, n_r * n_mu), np.int64)
    for i in np.flatnonzero(l1 >= 0):
        d = p1[i] - p2
        d = _f32(d - period * np.round(d / period))
        dx, dy, dz = d[:, 0], d[:, 1], np.abs(d[:, 2])
        rp_sq = (_f32(np.float64(_f32(dy * dy)) + np.float64(dx) ** 2)
                 if fma else _f32(_f32(dx * dx) + _f32(dy * dy)))
        ok = l2 >= 0
        if auto:
            ok &= np.arange(len(p2)) != i
        if smu:
            s_sq = (_f32(np.float64(rp_sq) + np.float64(dz) ** 2) if fma
                    else _f32(rp_sq + _f32(dz * dz)))
            s_bin = np.searchsorted(edges, s_sq, "right") - 1
            s = _f32(np.sqrt(np.float64(s_sq)))
            mu = np.where(s > 0, _f32(dz / np.maximum(s, np.float32(1e-30))),
                          np.float32(0))
            mu_bin = np.clip(np.searchsorted(mu_edges, mu, "right") - 1, 0,
                             n_mu - 1)
            ok &= (s_bin >= 0) & (s_bin < n_r) & (s > 0)
            sub = s_bin * n_mu + mu_bin
        else:
            sub = np.searchsorted(edges, rp_sq, "right") - 1
            ok &= (sub >= 0) & (sub < n_r)
            if c["kind"] == "rppi":
                ok &= dz < np.float32(c["pi_max"])
        np.add.at(hist, (l1[i], l2[ok], sub[ok]), 1)
    return hist


@pytest.mark.parametrize("case", ["auto_rppi", "auto_smu", "cross_unit"])
def test_sharded_unit_counts_equal_tabcorr_tpu(world, case):
    scatter = _jax(case, strategy="scatter")
    mesh = _jax(case, mesh=_jax_mesh())
    port = labeled_pair_count(**_cases()[case], device="cpu")
    np.testing.assert_array_equal(mesh, scatter)
    np.testing.assert_array_equal(
        port.reshape(-1), _brute_force(_cases()[case], False).reshape(-1))
    np.testing.assert_array_equal(
        scatter.reshape(-1), _brute_force(_cases()[case], True).reshape(-1))
    moved = np.abs(port - scatter).sum()
    assert moved == (1 if case == "cross_unit" else 0)
    assert scatter.sum() > 0
    for r in world:
        np.testing.assert_array_equal(r["counts"][case], port)


@pytest.mark.parametrize("case", ["cross_weighted", "cross_both"])
def test_sharded_weighted_sweeps(world, case):
    port = labeled_pair_count(**_cases()[case], device="cpu")
    mesh = _jax(case, mesh=_jax_mesh())
    for r in world:
        got = r["counts"][case]
        np.testing.assert_allclose(got, port, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(port)))
        np.testing.assert_allclose(got, mesh, rtol=5e-4)


@pytest.mark.parametrize("case", list(_cases()))
def test_one_all_reduce_per_sweep(world, case):
    for r in world:
        assert r["calls"][case] == ["all_reduce"]


@pytest.mark.parametrize("case", list(TAB_CASES))
def test_sharded_tabulate_equals_tabulate(world, case):
    tpcf, args, kwargs = TAB_CASES[case]
    want = ttt.TabCorr.tabulate(synthetic_halocat(**TAB_HALOS), tpcf,
                                *args, **kwargs, device="cpu").tpcf_matrix
    assert np.any(want != 0)
    for r in world:
        got = r["tabulate"][case]
        if case == "wp":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       atol=1e-12 * np.max(np.abs(want)))


class _Shard:
    """Rank ``rank`` of a first mesh dimension of ``size`` ranks, as
    ``shard_sweep`` reads a mesh."""

    def __init__(self, rank, size):
        self.rank, self.n = rank, size

    def size(self, dim):
        return self.n

    def get_local_rank(self, dim):
        return self.rank


@pytest.mark.parametrize("kind,cross", [("rppi", False), ("smu", False),
                                        ("proj", True)])
def test_shards_of_the_kernel_layout_sum_to_the_sweep(kind, cross):
    # The layout the kernel reads (bucket_layout, walked block by block by
    # test_torch_paircount.py's emulation) over each rank's block of
    # j-tracers: tracer indices stay global, so the auto self-pair test
    # holds across blocks, and the blocks' histograms sum to the sweep's.
    from tabcorr_tpu_torch.ops import paircount as pc
    from test_torch_paircount import _emulate_kernel, _layout_sample, _sweep

    p, labels = _layout_sample(21)
    if cross:
        rng = np.random.default_rng(22)
        p2 = rng.uniform(0, 1, (500, 3)) * np.asarray(p.max(0))
        sweep = _sweep(p, labels, int(labels.max()) + 1, kind, p2=p2,
                       l2=np.zeros(500, np.int32), n_l2=1,
                       w2=rng.uniform(0.5, 1.0, 500),
                       pair_weight="unit+log_rp")
    else:
        sweep = _sweep(p, labels, int(labels.max()) + 1, kind)
    want = pc.paircount_plain(sweep)
    shards = [pc.shard_sweep(sweep, _Shard(r, 3)) for r in range(3)]
    n2 = len(sweep.pos1 if sweep.auto else sweep.pos2)
    assert [s.j_range for s in shards] == [
        (0, -(-n2 // 3)), (-(-n2 // 3), 2 * -(-n2 // 3)),
        (2 * -(-n2 // 3), n2)]
    got = torch.zeros_like(want)
    for s in shards:
        hist = _emulate_kernel(s)[0]
        plain = pc.paircount_plain(s)
        if sweep.unit_counts:
            assert torch.equal(hist, plain)
        else:
            torch.testing.assert_close(hist, plain, rtol=1e-12, atol=1e-12)
        got += hist
    assert int((want != 0).sum()) > 0
    if sweep.unit_counts:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))
