"""The port's labeled pair counter on the CPU (its plain version) against
tabcorr_tpu's sweep and a float64 brute-force oracle, and the CPU side of
the CUDA kernel: its minimum image and its bucketed layout, emulated in
tensor ops.

tabcorr_tpu runs its XLA sweep here (``strategy="scatter"`` and
``"matmul"``); its statistics are held to it with the C++ counter switched
off, so that both packages count in float32 geometry.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tabcorr_tpu.ops.paircount as jpc
from tabcorr_tpu_torch.ops import paircount as pc

L = 40.0
R_EDGES = np.logspace(-0.7, 1.0, 7)
MU_UNIFORM = np.linspace(0.0, 1.0, 6)
MU_SKEWED = np.array([0.0, 0.1, 0.35, 0.5, 0.8, 0.93, 1.0])


@pytest.fixture
def xla_sweep(monkeypatch):
    """tabcorr_tpu's statistics on its XLA sweep, not its C++ counter."""
    monkeypatch.setattr(jpc, "_native_eligible", lambda *a: False)


def _sample(seed, n1=1400, n2=1000, n_l1=4, n_l2=3):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(0, L, (n1, 3))
    l1 = rng.integers(-1, n_l1, n1)          # -1: ignored tracers
    p2 = rng.uniform(0, L, (n2, 3))
    l2 = rng.integers(-1, n_l2, n2)
    w2 = rng.uniform(0.5, 2.0, n2) * 1e10
    return p1, l1, p2, l2, w2


def _kind_args(kind, mu=MU_UNIFORM):
    if kind == "rppi":
        return dict(kind="rppi", r_edges=R_EDGES, pi_max=9.0)
    if kind == "smu":
        return dict(kind="smu", r_edges=R_EDGES, mu_edges=mu)
    return dict(kind="proj", r_edges=np.concatenate([[0.0], R_EDGES]))


def _float32_geometry(p1, p2, period):
    """tabcorr_tpu's float32 minimum image in numpy: (rp^2, |dz|)."""
    p1, p2 = p1.astype(np.float32), p2.astype(np.float32)
    per = np.float32(period)
    d = p1[:, None, :] - p2[None, :, :]
    d = d - per * np.round(d / per)
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1], np.abs(d[..., 2])


def _near_edge_pairs(p1, p2, period, edges, exclude_self):
    """Ordered pairs whose rp^2 lies within 2 float32 ulp of a squared
    edge (float64 separations): the pairs a float32 counter may bin
    differently from a float64 one (tabcorr_tpu's paircount.py:19-22)."""
    d = p1[:, None, :] - p2[None, :, :]
    d -= period * np.round(d / period)
    rp_sq = d[..., 0] ** 2 + d[..., 1] ** 2
    e_sq = edges ** 2
    ulp = np.spacing(e_sq.astype(np.float32)).astype(np.float64)
    near = np.any(np.abs(rp_sq[..., None] - e_sq) <= 2 * ulp, axis=-1)
    if exclude_self:
        np.fill_diagonal(near, False)
    return int(near.sum())


@pytest.mark.parametrize("strategy", ["scatter", "matmul"])
@pytest.mark.parametrize("auto", [True, False], ids=["auto", "cross"])
@pytest.mark.parametrize("kind,mu", [("rppi", None), ("smu", MU_UNIFORM),
                                     ("smu", MU_SKEWED), ("proj", None)],
                         ids=["rppi", "smu", "smu-skewed-mu", "proj"])
def test_unit_counts_equal_tabcorr_tpu(kind, mu, auto, strategy):
    p1, l1, p2, l2, _ = _sample(1)
    args = _kind_args(kind, mu)
    cross = {} if auto else dict(pos2=p2, labels2=l2, n_labels_2=3)
    want = jpc.labeled_pair_count(p1, l1, 4, period=L, strategy=strategy,
                                  **args, **cross)
    for sort in (True, False):      # the z-windows on and off
        got = pc.labeled_pair_count(p1, l1, 4, period=L, sort=sort,
                                    device="cpu", **args, **cross)
        assert got.shape == want.shape
        # Both count in float32 geometry with the same expressions: every
        # count equal.  (Any pair within one float32 ulp of an edge may
        # bin differently between two float32 evaluation orders; none
        # does here.)
        np.testing.assert_array_equal(got, want)
    assert want.sum() > 1000


def test_windows_take_effect_where_the_cut_is_short():
    # Windowed sweep of 2 * pi_max < L visits fewer chunks than all.
    rng = np.random.default_rng(4)
    z1 = np.sort(rng.uniform(0, L, 5000).astype(np.float32))
    windows = pc.chunk_windows(z1, z1, 4.0, L)
    assert len(windows) == 5
    assert all(count < 5 for _, count in windows)
    # A wrapping window: the first chunk sees the last one.
    assert windows[0][0] + windows[0][1] > 5
    assert pc.chunk_windows(z1, z1, 25.0, L) == [(0, 5)] * 5


def _weighted_oracle(p1, l1, n_l1, p2, l2, n_l2, w2, edges, period=L):
    """float64 sums over the pairs binned in float32 geometry: the scaled
    weight and weight * 0.5 * ln(rp^2), rescaled (2, n_l1, n_l2, n_r)."""
    rp_sq, _ = _float32_geometry(p1, p2, period)
    e_sq = (edges ** 2).astype(np.float32)
    b = np.searchsorted(e_sq, rp_sq, side="right") - 1
    ok = ((b >= 0) & (b < len(e_sq) - 1) & (l1[:, None] >= 0) &
          (l2[None, :] >= 0))
    scale = np.abs(w2).max()
    w = np.broadcast_to((w2 / scale).astype(np.float32).astype(np.float64),
                        rp_sq.shape)
    n_r = len(e_sq) - 1
    flat = ((l1[:, None] * n_l2 + l2[None, :]) * n_r + b)[ok]
    size = n_l1 * n_l2 * n_r
    log_w = w * 0.5 * np.log(np.maximum(rp_sq.astype(np.float64), 1e-20))
    return np.stack([np.bincount(flat, w[ok], minlength=size),
                     np.bincount(flat, log_w[ok], minlength=size)]
                    ).reshape(2, n_l1, n_l2, n_r) * scale


@pytest.mark.parametrize("strategy", ["scatter", "matmul"])
@pytest.mark.parametrize("pair_weight", ["unit", "log_rp", "unit+log_rp"])
def test_weighted_channels(pair_weight, strategy):
    p1, l1, p2, l2, w2 = _sample(2, n1=600, n2=800)
    edges = np.concatenate([[0.0], R_EDGES])
    kw = dict(pos2=p2, labels2=l2, n_labels_2=3, weights2=w2, period=L,
              kind="proj", r_edges=edges, pair_weight=pair_weight)
    got = pc.labeled_pair_count(p1, l1, 4, device="cpu", **kw)
    want = jpc.labeled_pair_count(p1, l1, 4, strategy=strategy, **kw)
    oracle = _weighted_oracle(p1, l1, 4, p2, l2, 3, w2, edges)
    oracle = {"unit": oracle[0], "log_rp": oracle[1],
              "unit+log_rp": oracle}[pair_weight]
    assert got.shape == want.shape == oracle.shape
    # The port sums float32 pair weights in float64: against float64 sums
    # of the same pairs only each log term's float32 rounding (and log's
    # 1-ulp differences) remains.
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=0)
    # tabcorr_tpu sums each i-chunk's weights in float32 before its TwoSum
    # fold, ~sqrt(n) 2^-24 relative for n terms a cell and chunk: the port
    # is held within 1e-6 of it beyond tabcorr_tpu's own error against
    # the float64 sums.
    assert np.all(np.abs(got - want) <=
                  1e-6 * np.abs(want) + np.abs(want - oracle))


def test_auto_weights_and_log_channel_without_weights():
    p1, l1, _, _, _ = _sample(3, n1=900)
    w1 = np.random.default_rng(5).uniform(0.1, 1.0, len(p1))
    for weights, pair_weight in ((w1, "unit"), (None, "log_rp")):
        kw = dict(period=L, kind="rppi", r_edges=R_EDGES, pi_max=9.0,
                  weights2=weights, pair_weight=pair_weight)
        got = pc.labeled_pair_count(p1, l1, 4, device="cpu", **kw)
        want = jpc.labeled_pair_count(p1, l1, 4, strategy="scatter", **kw)
        # tabcorr_tpu's float32 sums within an i-chunk (~2e-6 relative
        # here; see test_weighted_channels for the float64 oracle).
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_counts_against_float64_brute_force():
    # Unit counts of one label against float64 separations: they differ
    # only by pairs within one float32 ulp of an edge.
    p1, _, p2, _, _ = _sample(6, n1=1200, n2=900)
    for auto in (True, False):
        b = p1 if auto else p2
        d = p1[:, None, :] - b[None, :, :]
        d -= L * np.round(d / L)
        rp_sq = d[..., 0] ** 2 + d[..., 1] ** 2
        if auto:
            np.fill_diagonal(rp_sq, -1.0)
        want = np.histogram(rp_sq, bins=R_EDGES ** 2)[0]
        got = pc.labeled_pair_count(
            p1, np.zeros(len(p1)), 1, pos2=None if auto else p2,
            period=L, kind="proj", r_edges=R_EDGES, device="cpu")[0, 0]
        allowance = _near_edge_pairs(p1, b, L, R_EDGES, auto)
        assert np.abs(got - want).sum() <= allowance


@pytest.mark.usefixtures("xla_sweep")
def test_statistics_match_tabcorr_tpu_and_brute_force():
    import tabcorr_tpu.corrfunc as jcf
    from tabcorr_tpu_torch import corrfunc as tcf
    rng = np.random.default_rng(5)
    lbox = 60.0
    pos1 = rng.uniform(0, lbox, (700, 3))
    pos2 = rng.uniform(0, lbox, (500, 3))
    r_bins = np.array([1.0, 3.0, 7.0, 14.0])
    mu_bins = np.linspace(0, 1, 5)

    def brute(a, b, exclude_self):
        d = a[:, None, :] - b[None, :, :]
        d -= lbox * np.round(d / lbox)
        r = np.sqrt((d ** 2).sum(axis=-1))
        rp = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
        mu = np.abs(d[..., 2]) / np.maximum(r, 1e-300)
        if exclude_self:
            np.fill_diagonal(r, -1.0)
            np.fill_diagonal(rp, -1.0)
        return d, r, rp, mu

    for sample2, auto in ((None, True), (pos2, False)):
        b = pos1 if auto else pos2
        d, r, rp, mu = brute(pos1, b, auto)
        n_pairs = len(pos1) * len(b)
        kw = dict(sample2=sample2, period=lbox, do_auto=auto,
                  do_cross=not auto)
        # xi(r)
        want = (np.histogram(r, bins=r_bins)[0] /
                (n_pairs / lbox ** 3 * 4 * np.pi / 3 * np.diff(r_bins ** 3))
                - 1)
        got = tcf.tpcf(pos1, r_bins, device="cpu", **kw)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got, jcf.tpcf(pos1, r_bins, **kw),
                                   rtol=1e-12, atol=1e-12)
        # wp
        pi_max = 10.0
        sel = np.abs(d[..., 2]) < pi_max
        dd = np.histogram(rp[sel], bins=r_bins)[0]
        want = (dd / (n_pairs / lbox ** 3 * np.pi * np.diff(r_bins ** 2) *
                      2 * pi_max) - 1) * 2 * pi_max
        got = tcf.wp(pos1, r_bins, pi_max, device="cpu", **kw)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got, jcf.wp(pos1, r_bins, pi_max, **kw),
                                   rtol=1e-12, atol=1e-12)
        # xi(s, mu)
        keep = r >= 0
        dd = np.histogram2d(r[keep], np.minimum(mu[keep], 1.0),
                            bins=[r_bins, mu_bins])[0]
        want = dd / (n_pairs / lbox ** 3 * 4 * np.pi / 3 *
                     np.diff(r_bins ** 3)[:, None] / 4) - 1
        got = tcf.s_mu_tpcf(pos1, r_bins, mu_bins, device="cpu", **kw)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(
            got, jcf.s_mu_tpcf(pos1, r_bins, mu_bins, **kw), rtol=1e-12,
            atol=1e-12)
    with pytest.raises(ValueError):
        tcf.tpcf(pos1, r_bins, period=lbox, do_auto=True, do_cross=True,
                 device="cpu")
    with pytest.raises(ValueError):
        tcf.s_mu_tpcf(pos1, r_bins, MU_SKEWED, period=lbox, device="cpu")


@pytest.mark.usefixtures("xla_sweep")
@pytest.mark.parametrize("estimator", ["annulus_mean", "midpoint"])
def test_mean_delta_sigma(estimator):
    import tabcorr_tpu.corrfunc as jcf
    from tabcorr_tpu_torch import corrfunc as tcf
    rng = np.random.default_rng(8)
    lbox = 50.0
    gal = rng.uniform(0, lbox, (300, 3))
    ptcl = rng.uniform(0, lbox, (2000, 3))
    rp_bins = np.logspace(-0.5, 1.0, 6)
    mass = 1e9
    got = tcf.mean_delta_sigma(gal, ptcl, mass, rp_bins, period=lbox,
                               estimator=estimator, device="cpu")
    want = jcf.mean_delta_sigma(gal, ptcl, mass, rp_bins, period=lbox,
                                estimator=estimator)
    # Oracle: the estimator from float64 sums over the pairs binned in
    # float32 geometry (a float64 counter may bin a pair within one
    # float32 ulp of an edge otherwise).
    labels, ptcl_labels = np.zeros(len(gal), int), np.zeros(len(ptcl), int)
    weights = np.full(len(ptcl), mass)
    if estimator == "annulus_mean":
        edges = np.concatenate([[0.0], rp_bins])
        m, lm = _weighted_oracle(gal, labels, 1, ptcl, ptcl_labels, 1,
                                 weights, edges, period=lbox)[:, 0, 0]
        oracle = pc.delta_sigma_from_mass_profiles(
            rp_bins, np.cumsum(m)[:-1], m[1:], lm[1:], len(gal))
    else:
        mids = np.sqrt(rp_bins[:-1] * rp_bins[1:])
        edges = np.unique(np.concatenate([[0.0], rp_bins, mids]))
        m = _weighted_oracle(gal, labels, 1, ptcl, ptcl_labels, 1, weights,
                             edges, period=lbox)[0, 0, 0]
        cum = np.concatenate([[0.0], np.cumsum(m)])

        def m_in(r):
            return cum[np.searchsorted(edges, r)]

        oracle = (m_in(mids) / (np.pi * mids ** 2 * len(gal)) -
                  (m_in(rp_bins[1:]) - m_in(rp_bins[:-1])) /
                  (np.pi * np.diff(rp_bins ** 2) * len(gal)))
    scale = np.abs(oracle).max()
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-6 * scale)
    # Equal particle masses: the mass channel is an exact integer count
    # in both packages, the midpoint form equal; the annulus mean's
    # ln(rp) channel carries tabcorr_tpu's float32 chunk sums.
    if estimator == "midpoint":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        assert np.all(np.abs(got - want) <=
                      1e-6 * scale + np.abs(want - oracle))
    with pytest.raises(ValueError):
        tcf.mean_delta_sigma(gal, ptcl, mass, rp_bins, period=lbox,
                             estimator="nope", device="cpu")


# ----------------------------------------------------------------------
# The kernel's CPU side
# ----------------------------------------------------------------------
@pytest.mark.parametrize("period", [250.0, 150.0, 40.0, 1.0, 37.3, 1000.1])
def test_threshold_minimum_image_is_tabcorr_tpus(period):
    # The kernel compares |d| with a threshold where tabcorr_tpu divides
    # and rounds; for coordinates in [0, period] both give the same
    # float32, bit for bit, including at the half-period tie.
    rng = np.random.default_rng(9)
    per = np.float32(period)
    a = rng.uniform(0, per, 200_000).astype(np.float32)
    b = rng.uniform(0, per, 200_000).astype(np.float32)
    half = np.float32(per / np.float32(2))
    edge = [np.float32(0), per, half]
    for k in range(1, 40):
        edge += [np.nextafter(half, np.float32(0), dtype=np.float32) *
                 np.float32(1 + 1e-9 * k),
                 half + np.float32(k) * np.spacing(half)]
    edge = np.array(edge, dtype=np.float32)
    a = np.concatenate([a, edge, np.zeros_like(edge), per - edge,
                        np.full_like(edge, per)])
    b = np.concatenate([b, np.zeros_like(edge), edge, np.zeros_like(edge),
                        per - edge])
    d = torch.from_numpy(a) - torch.from_numpy(b)
    p = torch.tensor(per)
    want = d - p * torch.round(d / p)
    thr = pc.wrap_thresholds((float(per),) * 3)[0]
    # csrc/paircount.cu's min_image: fabsf(d) >= thr ? d - copysignf(p, d)
    # : d.
    got = torch.where(d.abs() >= thr, d - torch.copysign(p, d), d)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_square_root_is_correctly_rounded():
    # numpy's float32 sqrt is IEEE's, as XLA's and CUDA's __fsqrt_rn are.
    x = np.random.default_rng(10).uniform(0, 5000, 2_000_000).astype(
        np.float32)
    got = pc.sqrt32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))


def _emulate_kernel(sweep):
    """The kernel's traversal in tensor ops: every (tile, label_2) block of
    :func:`bucket_layout` over the runs of its neighbour columns
    (``pair_runs``, the kernel's ``column_runs``), with the geometry of the
    plain version (which the threshold test above holds equal to the
    kernel's).  Asserts the layout's invariants -- every labeled i-tracer
    in one tile, a tile within one (label group, xy cell), each offset a
    distinct cell, each j-run within its column -- and that no block
    evaluates a (i, j) pair twice.  Returns (histogram, layout, pairs
    evaluated)."""
    layout = pc.bucket_layout(sweep)
    consts = pc.sweep_constants(sweep)
    hist = pc._empty_hist(sweep)
    n_x, n_y = layout.cells
    n_cells = n_x * n_y
    n_l2 = sweep.n_labels_2
    n1 = len(layout.pos1)
    # i-side: tiles partition the tracers; one (group, cell) a tile.
    starts, counts = layout.tile_start.long(), layout.tile_count.long()
    assert bool(((counts >= 1) & (counts <= pc.TILE)).all())
    assert torch.equal(torch.cat([torch.arange(a, a + c) for a, c in
                                  zip(starts.tolist(), counts.tolist())]),
                       torch.arange(n1))
    assert n1 == int((sweep.labels1 >= 0).sum())
    tile_of = torch.repeat_interleave(torch.arange(layout.n_tiles), counts)
    scale = torch.tensor([n_x / sweep.period[0], n_y / sweep.period[1]],
                         dtype=torch.float32)
    cxy = torch.minimum(torch.floor(layout.pos1[:, :2] * scale).long(),
                        torch.tensor([n_x - 1, n_y - 1]))
    assert torch.equal(cxy[:, 0] * n_y + cxy[:, 1],
                       layout.tile_cell[tile_of].long())
    group = torch.searchsorted(layout.group_start.long(),
                               layout.labels1.long(), right=True) - 1
    assert torch.equal(group, layout.tile_group[tile_of].long())
    assert int(layout.group_start.diff().max()) == layout.group_rows
    # Offsets: distinct residues of each axis.
    offsets = layout.neighbours.long()
    assert len(torch.unique(offsets[:, 0] * n_y + offsets[:, 1])) == \
        len(offsets) <= pc.MAX_NEIGHBOURS
    assert bool(((offsets[:, 0] < n_x) & (offsets[:, 1] < n_y)).all())
    # j-side: columns of (label_2, cell).
    column_of = torch.repeat_interleave(torch.arange(n_l2 * n_cells),
                                        layout.columns.long().diff())
    label2 = column_of // n_cells
    runs = pc.pair_runs(sweep, layout, torch.arange(layout.n_tiles))
    evaluated = 0
    for t in range(layout.n_tiles):
        i0, i1 = int(starts[t]), int(starts[t] + counts[t])
        r = runs[t].reshape(-1, 4)
        a = torch.cat([r[:, 0], r[:, 2]])
        lengths = torch.cat([r[:, 1] - r[:, 0], r[:, 3] - r[:, 2]])
        assert bool((lengths >= 0).all())
        total = int(lengths.sum())
        if total == 0:
            continue
        js = torch.repeat_interleave(a, lengths) + torch.arange(total) - \
            torch.repeat_interleave(torch.cumsum(lengths, 0) - lengths,
                                    lengths)
        # No (i, j) pair twice: each j once in the tile's blocks.
        assert len(torch.unique(js)) == total
        sub, valid, rp_sq = pc.pair_geometry(
            layout.pos1[i0:i1, :3], layout.index1[i0:i1],
            layout.pos2[js, :3], layout.index2[js], sweep, consts)
        pc.accumulate(hist, sub, valid, rp_sq, layout.labels1[i0:i1],
                      label2[js], layout.pos2[js, 3], sweep)
        evaluated += (i1 - i0) * total
    assert evaluated == pc.candidate_count(sweep, layout)
    return hist, layout, evaluated


def _sweep(p1, l1, n_l1, kind, p2=None, l2=None, n_l2=None, w2=None,
           period=L, pair_weight="unit", sort=True, mu=MU_UNIFORM,
           r_edges=None):
    args = _kind_args(kind, mu)
    if r_edges is not None:
        args["r_edges"] = r_edges
    period3 = tuple(float(np.float32(p)) for p in
                    np.broadcast_to(np.asarray(period, float), (3,)))
    z_cut = {"rppi": args.get("pi_max"),
             "smu": float(args["r_edges"][-1]), "proj": None}[kind]
    if not (sort and z_cut is not None and 2 * z_cut < period3[2]):
        z_cut = None
    t = torch.from_numpy
    return pc.Sweep(
        pos1=t(p1.astype(np.float32)), labels1=t(l1.astype(np.int32)),
        n_labels_1=n_l1,
        pos2=None if p2 is None else t(p2.astype(np.float32)),
        labels2=None if l2 is None else t(l2.astype(np.int32)),
        n_labels_2=n_l1 if p2 is None else n_l2,
        weights2=None if w2 is None else t(w2.astype(np.float32)),
        period=period3, kind=kind,
        edges_sq=(args["r_edges"] ** 2).astype(np.float32),
        mu_edges=(mu if kind == "smu" else np.zeros(2)).astype(np.float32),
        pi_max=float(np.float32(args.get("pi_max", 0.0))),
        pair_weight=pair_weight, z_cut=z_cut)


def _layout_sample(seed, n=700, period=L):
    """Labels of 1 tracer, of 257 (a full tile and a partial one), and
    the rest; a band of tracers at each periodic z boundary (wrapping
    windows) and coordinates on the boundary."""
    period = np.broadcast_to(np.asarray(period, float), (3,))
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (n, 3)) * period
    p[:60, 2] = rng.uniform(0, 1.0, 60)
    p[60:120, 2] = rng.uniform(period[2] - 1.0, period[2], 60)
    p[120, 2] = period[2]               # coordinates on the boundary
    p[121, 0] = period[0]
    p[122, :2] = period[:2]
    labels = np.full(n, 2)
    labels[rng.choice(np.arange(320, n), 40, replace=False)] = -1
    labels[257 - 20:257 + 20] = 2
    labels[:257 - 20] = 0
    labels[n - 20:] = 0
    labels[300] = 1
    return p, labels


def _assert_equal_plain(sweep, got):
    want = pc.paircount_plain(sweep)
    if sweep.unit_counts:
        assert torch.equal(got, want)
        assert int(want.sum()) > 0
    else:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["rppi", "smu", "proj"])
def test_kernel_layout_emulation_auto(kind):
    p, labels = _layout_sample(10)
    sweep = _sweep(p, labels, 4, kind)      # label 3: empty
    got, layout, evaluated = _emulate_kernel(sweep)
    assert torch.equal(got, pc.paircount_plain(sweep))
    assert int(layout.tile_count.min()) < pc.TILE
    hist = got.reshape(4, 4, -1)
    assert torch.equal(hist, hist.transpose(0, 1))
    # The cell lists cut the work: fewer pairs than all; and the windows
    # wrap (a tile at the bottom of z reaches the top of the box).
    assert evaluated < len(layout.pos1) * len(layout.pos2)
    if kind != "proj":
        runs = pc.pair_runs(sweep, layout, torch.arange(layout.n_tiles))
        assert bool((runs[..., 3] > runs[..., 2]).any())


@pytest.mark.parametrize("pair_weight", ["log_rp", "unit+log_rp"])
@pytest.mark.parametrize("kind", ["rppi", "smu", "proj"])
def test_kernel_layout_emulation_auto_weighted(kind, pair_weight):
    p, labels = _layout_sample(15)
    w = np.random.default_rng(16).uniform(0.2, 1.0, len(p))
    sweep = _sweep(p, labels, 3, kind, w2=w, pair_weight=pair_weight)
    got, _, _ = _emulate_kernel(sweep)
    _assert_equal_plain(sweep, got)


@pytest.mark.parametrize("pair_weight", ["unit", "log_rp", "unit+log_rp"])
@pytest.mark.parametrize("kind", ["rppi", "smu", "proj"])
def test_kernel_layout_emulation_cross(kind, pair_weight):
    p, labels = _layout_sample(11)
    rng = np.random.default_rng(12)
    p2 = rng.uniform(0, L, (500, 3))
    p2[:50, 2] = rng.uniform(0, 0.5, 50)
    l2 = rng.integers(-1, 2, 500)
    w2 = None if pair_weight == "unit" and kind != "proj" else \
        rng.uniform(0.2, 1.0, 500)
    sweep = _sweep(p, labels, 3, kind, p2=p2, l2=l2, n_l2=2, w2=w2,
                   pair_weight=pair_weight)
    got, _, _ = _emulate_kernel(sweep)
    _assert_equal_plain(sweep, got)


def test_kernel_layout_without_window():
    # 2 * z_cut >= period_z: every block scans whole columns.
    p, labels = _layout_sample(13)
    sweep = _sweep(p, labels, 3, "rppi", period=L)
    wide = dataclasses.replace(sweep, pi_max=25.0, z_cut=None)
    got, layout, _ = _emulate_kernel(wide)
    assert torch.equal(got, pc.paircount_plain(wide))
    assert bool((layout.reach_z == -1).all())
    runs = pc.pair_runs(wide, layout, torch.arange(layout.n_tiles))
    sizes = layout.columns.long().diff()
    n_x, n_y = layout.cells
    cell = layout.tile_cell.long()[:, None]
    nb = layout.neighbours.long()
    ncell = ((cell // n_y + nb[:, 0]) % n_x * n_y +
             (cell % n_y + nb[:, 1]) % n_y)
    col = torch.arange(3)[None, :, None] * n_x * n_y + ncell[:, None, :]
    assert torch.equal(runs[..., 1] - runs[..., 0], sizes[col])
    assert bool((runs[..., 3] == runs[..., 2]).all())


@pytest.mark.parametrize("kind", ["rppi", "smu", "proj"])
@pytest.mark.parametrize("r_max", [15.0, 25.0, 60.0],
                         ids=["wrapped-offsets", "2rmax>=period", "one-cell"])
def test_kernel_layout_few_cells(kind, r_max):
    # Few cells per axis: 2 * reach + 1 >= n_a, so wrapped offsets would
    # name a cell twice but for the residues; 2 r_max >= period: no xy
    # culling (every offset kept); r_max above the period: one cell.
    p, labels = _layout_sample(17)
    edges = np.logspace(-0.5, np.log10(r_max), 6)
    if kind == "proj":
        edges = np.concatenate([[0.0], edges])
    sweep = _sweep(p, labels, 3, kind, r_edges=edges)
    got, layout, _ = _emulate_kernel(sweep)
    assert torch.equal(got, pc.paircount_plain(sweep))
    n_x, n_y = layout.cells
    assert n_x == n_y == max(1, int(L * pc.CELLS_PER_REACH // r_max))
    if 2 * r_max >= L:
        assert len(layout.neighbours) == n_x * n_y
    else:
        assert len(layout.neighbours) < n_x * n_y
        assert n_x < 2 * (pc.CELLS_PER_REACH + 1) + 1


@pytest.mark.parametrize("kind", ["rppi", "smu", "proj"])
def test_kernel_layout_non_cubic_period(kind):
    # The AP stretch makes wp and xi boxes non-cubic: cells per axis each
    # on its own.
    period = (40.0, 31.0, 47.0)
    p, labels = _layout_sample(18, period=period)
    rng = np.random.default_rng(19)
    p2 = rng.uniform(0, 1, (600, 3)) * period
    p2[0] = period
    l2 = rng.integers(0, 2, 600)
    for p_other in (None, p2):
        sweep = _sweep(p, labels, 3, kind, p2=p_other,
                       l2=None if p_other is None else l2,
                       n_l2=None if p_other is None else 2, period=period)
        got, layout, _ = _emulate_kernel(sweep)
        assert torch.equal(got, pc.paircount_plain(sweep))
        assert layout.cells == (16, 12)     # 40 / 2.5 and 31 / 2.5


@pytest.mark.parametrize("kind", ["rppi", "smu", "proj"])
def test_kernel_layout_label_groups(kind, monkeypatch):
    # A small histogram budget splits the labels into several groups: a
    # tile mixes the labels of one group, and each group's rows land in
    # their own rows of the histogram.
    rng = np.random.default_rng(20)
    p = rng.uniform(0, L, (900, 3))
    labels = rng.integers(-1, 7, 900)
    labels[:5] = 6
    sweep = _sweep(p, labels, 8, kind)      # label 7: empty
    row_bytes = sweep.n_channels * sweep.n_hist_r * 4
    monkeypatch.setattr(pc, "HIST_BYTES", 3 * row_bytes)
    got, layout, _ = _emulate_kernel(sweep)
    assert torch.equal(got, pc.paircount_plain(sweep))
    assert layout.group_start.tolist() == [0, 3, 6, 8]
    assert layout.group_rows == 3
    assert len(torch.unique(layout.tile_group)) == 3
    # One group of every label where the budget holds all rows.
    monkeypatch.setattr(pc, "HIST_BYTES", 8 * row_bytes)
    _, whole, _ = _emulate_kernel(sweep)
    assert whole.group_start.tolist() == [0, 8]


@pytest.mark.parametrize("kind,pair_weight,private", [
    ("rppi", "log_rp", True), ("proj", "unit+log_rp", True),
    ("smu", "unit+log_rp", False), ("proj", "unit", False)])
def test_kernel_layout_private_rows(kind, pair_weight, private, monkeypatch):
    # A weighted sweep whose 256 float64 rows a block fit
    # PRIVATE_ROWS_BYTES adds into a private row a thread, one group of
    # every label; else (xi(s, mu)'s 2 x 30 cells a row here, unit
    # counts) the group histogram.
    p, labels = _layout_sample(23)
    w = np.random.default_rng(24).uniform(0.2, 1.0, len(p))
    sweep = _sweep(p, labels, 3, kind, pair_weight=pair_weight,
                   w2=None if pair_weight == "unit" else w)
    row_bytes = sweep.n_channels * sweep.n_hist_r * (
        4 if sweep.unit_counts else 8)
    monkeypatch.setattr(pc, "HIST_BYTES", row_bytes)
    got, layout, _ = _emulate_kernel(sweep)
    _assert_equal_plain(sweep, got)
    assert layout.private_rows == private
    assert layout.group_start.tolist() == ([0, 3] if private else
                                           [0, 1, 2, 3])


@pytest.mark.parametrize("kind", ["rppi", "proj"])
def test_kernel_layout_self_pairs_by_index(kind):
    # Auto mode with a first edge at 0: distinct tracers on one position
    # pair at rp = 0, a tracer with itself does not; i and j are two
    # arrays sorted differently, so the self test is by tracer index.
    rng = np.random.default_rng(21)
    p = rng.uniform(0, L, (500, 3))
    p[100:110] = p[90]                  # 11 tracers on one point
    labels = rng.integers(0, 3, 500)
    edges = np.concatenate([[0.0], R_EDGES])
    sweep = _sweep(p, labels, 3, kind, r_edges=edges)
    got, _, _ = _emulate_kernel(sweep)
    assert torch.equal(got, pc.paircount_plain(sweep))
    # The coincident tracers' ordered pairs at rp = 0: 11 * 10.
    assert int(got.reshape(3, 3, -1)[:, :, 0].sum()) >= 110


@pytest.mark.parametrize("kind", ["rppi", "smu", "proj"])
def test_kernel_layout_visits_fewer_pairs_than_the_z_slab_layout(kind):
    # A uniform sample at the shape of the tabulation's sweeps (a box of
    # 250, r_max 63 for rppi / smu with pi_max 80, r_max 40 for proj, 120
    # sparse labels): the cell lists visit fewer pairs than the layout
    # they replace, tiles of one label sorted in z, each against every
    # j-tracer in its periodic z-window.
    rng = np.random.default_rng(22)
    box = 250.0
    p = rng.uniform(0, box, (4000, 3))
    labels = rng.integers(0, 120, 4000)
    r_max = 10 ** (1.6 if kind == "proj" else 1.8)
    edges = np.logspace(-1, np.log10(r_max), 15)
    sweep = _sweep(p, labels, 120, kind, period=box, r_edges=edges)
    if kind == "rppi":
        sweep = dataclasses.replace(sweep, pi_max=80.0, z_cut=80.0)
    layout = pc.bucket_layout(sweep)
    new = pc.candidate_count(sweep, layout)
    # The layout being replaced, counted in numpy.
    z = p[:, 2]
    zc = sweep.z_cut + 1e-3 + 1e-6 * box if sweep.z_cut else None
    z_all = np.sort(np.float32(z).astype(np.float64))
    old = 0
    for lab in range(120):
        zs = np.sort(np.float32(z[labels == lab]).astype(np.float64))
        for t0 in range(0, len(zs), pc.TILE):
            n_t = min(pc.TILE, len(zs) - t0)
            if zc is None:
                old += n_t * len(z)
                continue
            lo, hi = zs[t0] - zc, zs[t0 + n_t - 1] + zc
            if hi - lo >= box:
                old += n_t * len(z)
                continue
            inside = sum(int(np.searchsorted(z_all, hi + k, "right") -
                             np.searchsorted(z_all, lo + k, "left"))
                         for k in (-box, 0.0, box))
            old += n_t * inside
    assert new < 0.6 * old, (new, old)
    if kind == "proj":
        assert new < 0.25 * old, (new, old)


def test_refusals():
    p, labels = _layout_sample(14)
    sweep = _sweep(p, labels, 3, "rppi")
    with pytest.raises(ValueError, match="CUDA"):
        pc.paircount_launch(sweep)
    with pytest.raises(ValueError, match="below n_labels"):
        pc.paircount_plain(dataclasses.replace(sweep, n_labels_1=2,
                                               n_labels_2=2))
    with pytest.raises(ValueError, match="float32"):
        pc.paircount_plain(dataclasses.replace(sweep,
                                               pos1=sweep.pos1.double()))
    with pytest.raises(ValueError, match="kind"):
        pc.labeled_pair_count(p, labels, 3, kind="xyz", r_edges=R_EDGES,
                              device="cpu")
    # mesh= shards the sweep (test_torch_parallel_sweep.py); the host
    # counter takes none.
    with pytest.raises(ValueError, match="takes no mesh"):
        pc.labeled_pair_count(p, labels, 3, r_edges=R_EDGES, pi_max=5.0,
                              mesh=object(), strategy="native",
                              device="cpu")
    with pytest.raises(ValueError, match="explicitly"):
        pc.labeled_pair_count(p, labels, 3, r_edges=R_EDGES, pi_max=5.0,
                              device=None)
