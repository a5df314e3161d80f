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
    """The kernel's traversal in tensor ops: every (tile, j-label) block of
    :func:`bucket_layout` over its j-runs (the geometry of the plain
    version, which the threshold test above holds equal to the kernel's);
    returns the flat histogram and the layout."""
    layout = pc.bucket_layout(sweep)
    consts = pc.sweep_constants(sweep)
    hist = pc._empty_hist(sweep)
    evaluated = 0
    label1 = torch.repeat_interleave(
        torch.arange(sweep.n_labels_1), layout.offsets1.diff())
    label2 = torch.repeat_interleave(
        torch.arange(sweep.n_labels_2), layout.offsets2.diff())
    for t in range(layout.n_tiles):
        i0 = int(layout.tile_start[t])
        i1 = i0 + int(layout.tile_count[t])
        assert 1 <= i1 - i0 <= pc.TILE
        assert bool((label1[i0:i1] == layout.tile_label[t]).all())
        for l2 in range(sweep.n_labels_2):
            a0, b0, a1, b1 = layout.runs[t, l2].tolist()
            assert a0 <= b0 and a1 <= b1 and (a1 == b1 or b1 <= a0)
            for ja, jb in ((a0, b0), (a1, b1)):
                if ja == jb:
                    continue
                assert bool((label2[ja:jb] == l2).all())
                idx1 = torch.arange(i0, i1)
                idx2 = torch.arange(ja, jb) if sweep.auto else \
                    torch.full((jb - ja,), -1)
                sub, valid, rp_sq = pc.pair_geometry(
                    layout.pos1[i0:i1, :3], idx1, layout.pos2[ja:jb, :3],
                    idx2, sweep, consts)
                pc.accumulate(hist, sub, valid, rp_sq, label1[i0:i1],
                              label2[ja:jb], layout.pos2[ja:jb, 3], sweep)
                evaluated += (i1 - i0) * (jb - ja)
    assert evaluated == layout.candidates
    return hist, layout


def _sweep(p1, l1, n_l1, kind, p2=None, l2=None, n_l2=None, w2=None,
           period=L, pair_weight="unit", sort=True, mu=MU_UNIFORM):
    args = _kind_args(kind, mu)
    period3 = (float(np.float32(period)),) * 3
    z_cut = {"rppi": args.get("pi_max"),
             "smu": float(args["r_edges"][-1]), "proj": None}[kind]
    if not (sort and z_cut is not None and 2 * z_cut < period):
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


def _layout_sample(seed, n=700):
    """Labels of 1 tracer, of 257 (a full tile and a partial one), and
    the rest; a band of tracers at each periodic z boundary (wrapping
    windows)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, L, (n, 3))
    p[:60, 2] = rng.uniform(0, 1.0, 60)
    p[60:120, 2] = rng.uniform(L - 1.0, L, 60)
    p[120, 2] = L                       # a coordinate on the boundary
    labels = np.full(n, 2)
    labels[rng.choice(np.arange(320, n), 40, replace=False)] = -1
    labels[257 - 20:257 + 20] = 2
    labels[:257 - 20] = 0
    labels[n - 20:] = 0
    labels[300] = 1
    return p, labels


@pytest.mark.parametrize("kind", ["rppi", "smu", "proj"])
def test_kernel_layout_emulation_auto(kind):
    p, labels = _layout_sample(10)
    sweep = _sweep(p, labels, 4, kind)      # label 3: empty
    got, layout = _emulate_kernel(sweep)
    assert torch.equal(got, pc.paircount_plain(sweep))
    assert int(layout.tile_count.min()) < pc.TILE
    assert 1 in layout.tile_count.tolist()
    hist = got.reshape(4, 4, -1)
    assert torch.equal(hist, hist.transpose(0, 1))
    if kind != "proj":
        # The windows cut the work, and wrap: a tile at the bottom of z
        # reaches the top of the box.
        full = sum(int(layout.tile_count[t]) * len(layout.pos2)
                   for t in range(layout.n_tiles))
        assert layout.candidates < full
        assert bool((layout.runs[:, :, 3] > layout.runs[:, :, 2]).any())


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
    got, _ = _emulate_kernel(sweep)
    want = pc.paircount_plain(sweep)
    if sweep.unit_counts:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_kernel_layout_without_window():
    # 2 * z_cut >= period_z: every block scans its whole bucket.
    p, labels = _layout_sample(13)
    sweep = _sweep(p, labels, 3, "rppi", period=L)
    wide = dataclasses.replace(sweep, pi_max=25.0, z_cut=None)
    got, layout = _emulate_kernel(wide)
    assert torch.equal(got, pc.paircount_plain(wide))
    sizes = layout.offsets2.diff()
    assert torch.equal(layout.runs[:, :, 1] - layout.runs[:, :, 0],
                       sizes[None, :].expand(layout.n_tiles, -1).int())
    assert bool((layout.runs[:, :, 3] == layout.runs[:, :, 2]).all())


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
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        pc.labeled_pair_count(p, labels, 3, r_edges=R_EDGES, pi_max=5.0,
                              mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="explicitly"):
        pc.labeled_pair_count(p, labels, 3, r_edges=R_EDGES, pi_max=5.0,
                              device=None)
