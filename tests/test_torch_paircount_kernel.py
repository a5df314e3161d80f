"""The CUDA pair counter (csrc/paircount.cu) against its plain PyTorch
version on the card: every kind, mode and channel; partial tiles, a
one-tracer label, windows that wrap the periodic boundary, sweeps without
a window; ``TabCorr.tabulate`` on the card against the CPU; the launch
counter and the wrapper's refusals.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_paircount_kernel.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from tabcorr_tpu_torch.ops import paircount as pc

pytestmark = pytest.mark.gpu

L = 40.0
R_EDGES = np.logspace(-0.7, 1.0, 9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tracers(seed, n, n_labels):
    """Uniform tracers with bands at both z boundaries (wrapping
    windows), a one-tracer label 1, a label 0 of 257 tracers (one full
    tile and one partial), ignored tracers (-1) and, with four or more
    labels, an empty last label."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, L, (n, 3))
    p[:80, 2] = rng.uniform(0, 1.0, 80)
    p[80:160, 2] = rng.uniform(L - 1.0, L, 80)
    p[160, 2] = L
    labels = rng.integers(2, max(n_labels - 1, 3), n)
    labels[rng.choice(np.arange(300, n), 50, replace=False)] = -1
    labels[:257] = 0
    labels[280] = 1
    return p, labels


def _sweep(cuda, kind, auto, pair_weight="unit", weighted=False, seed=0,
           z_cut=True, mu=np.linspace(0, 1, 7)):
    p1, l1 = _tracers(seed, 1500, 5)
    p2, l2 = _tracers(seed + 1, 1100, 3)
    rng = np.random.default_rng(seed + 2)
    w = rng.uniform(0.1, 1.0, len(p1) if auto else len(p2))
    pi_max = 7.0
    edges = R_EDGES if kind != "proj" else np.concatenate([[0.0], R_EDGES])
    cut = {"rppi": pi_max, "smu": float(edges[-1]), "proj": None}[kind]

    def t(a, dtype):
        return torch.tensor(a, dtype=dtype, device=cuda)

    return pc.Sweep(
        pos1=t(p1, torch.float32), labels1=t(l1, torch.int32), n_labels_1=5,
        pos2=None if auto else t(p2, torch.float32),
        labels2=None if auto else t(l2, torch.int32),
        n_labels_2=5 if auto else 3,
        weights2=t(w, torch.float32) if weighted else None,
        period=(L, L, L), kind=kind, edges_sq=(edges ** 2).astype(np.float32),
        mu_edges=(mu if kind == "smu" else np.zeros(2)).astype(np.float32),
        pi_max=pi_max, pair_weight=pair_weight,
        z_cut=cut if z_cut else None)


def _check(sweep):
    before = pc.PAIRCOUNT_LAUNCHES
    got = pc.paircount_launch(sweep)
    torch.cuda.synchronize()
    assert pc.PAIRCOUNT_LAUNCHES == before + 1
    want = pc.paircount_plain(sweep)
    if sweep.unit_counts:
        assert got.dtype == torch.int64
        assert torch.equal(got, want)
        assert int(got.sum()) > 0
    else:
        # float64 sums of the same float32 pair weights (log's 1-ulp
        # differences aside) in another order.
        scale = float(want.abs().max())
        assert bool(((got - want).abs() <=
                     1e-7 * want.abs() + 1e-7 * scale).all())
    return got


@pytest.mark.parametrize("auto", [True, False], ids=["auto", "cross"])
@pytest.mark.parametrize("kind", ["rppi", "smu", "proj"])
def test_unit_counts_equal_plain(cuda, kind, auto):
    hist = _check(_sweep(cuda, kind, auto))
    if auto:
        h = hist.reshape(5, 5, -1)
        assert torch.equal(h, h.transpose(0, 1))


@pytest.mark.parametrize("pair_weight", ["unit", "log_rp", "unit+log_rp"])
@pytest.mark.parametrize("auto", [True, False], ids=["auto", "cross"])
@pytest.mark.parametrize("kind", ["rppi", "smu", "proj"])
def test_weighted_channels_match_plain(cuda, kind, auto, pair_weight):
    _check(_sweep(cuda, kind, auto, pair_weight, weighted=True))


@pytest.mark.parametrize("kind", ["rppi", "smu"])
def test_without_window(cuda, kind):
    # 2 * z_cut >= period_z (or sort=False): whole buckets.
    _check(_sweep(cuda, kind, True, z_cut=False))
    _check(_sweep(cuda, kind, False, z_cut=False))


def test_skewed_mu_bins(cuda):
    _check(_sweep(cuda, "smu", True,
                  mu=np.array([0.0, 0.1, 0.35, 0.5, 0.8, 0.93, 1.0])))


@pytest.mark.parametrize("pi_max", [9.0, 25.0])   # 2 pi_max >= L: no window
def test_labeled_pair_count_on_the_card(cuda, pi_max):
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, L, (3000, 3))
    labels = rng.integers(-1, 4, 3000)
    kw = dict(period=L, kind="rppi", r_edges=R_EDGES, pi_max=pi_max)
    before = pc.PAIRCOUNT_LAUNCHES
    got = pc.labeled_pair_count(pos, labels, 4, device=cuda, **kw)
    assert pc.PAIRCOUNT_LAUNCHES == before + 1
    want = pc.labeled_pair_count(pos, labels, 4, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stat", ["wp", "s_mu_tpcf", "mean_delta_sigma"])
def test_tabulate_on_the_card_equals_the_cpu(cuda, stat):
    # The same catalog and seed through the kernel and the plain version:
    # equal counts, so equal tables up to the host estimators' rounding.
    import tabcorr_tpu_torch as tp
    from tabcorr_tpu_torch.utils.synthetic import synthetic_halocat
    halocat = synthetic_halocat(2000, 100.0)
    bins = np.logspace(-0.5, 1.2, 6)
    args = {"wp": (bins, 20.0), "s_mu_tpcf": (bins, np.linspace(0, 1, 6)),
            "mean_delta_sigma": (np.random.default_rng(1).uniform(
                0, 100.0, (20000, 3)), 1e10, bins)}[stat]
    kw = dict(prim_haloprop_bins=5, sec_haloprop_percentile_bins=0.5,
              sats_per_prim_haloprop=2e-13, seed=3,
              mode="cross" if stat == "mean_delta_sigma" else "auto")
    before = pc.PAIRCOUNT_LAUNCHES
    card = tp.TabCorr.tabulate(halocat, getattr(tp.corrfunc, stat), *args,
                               device=cuda, **kw)
    assert pc.PAIRCOUNT_LAUNCHES == before + 1
    host = tp.TabCorr.tabulate(halocat, getattr(tp.corrfunc, stat), *args,
                               device="cpu", **kw)
    scale = np.abs(host.tpcf_matrix).max()
    if stat != "mean_delta_sigma":
        np.testing.assert_allclose(card.tpcf_matrix, host.tpcf_matrix,
                                   rtol=1e-12, atol=1e-12 * scale)
        return
    # The annulus mean's ln(rp) channel: the card's logf and the CPU's log
    # differ by an ulp here and there, and the estimator's bracket cancels
    # (8e-8 of the largest entry measured on an H100).
    np.testing.assert_allclose(card.tpcf_matrix, host.tpcf_matrix, rtol=0,
                               atol=1e-6 * scale)


def test_refusals(cuda):
    sweep = _sweep(cuda, "rppi", True)
    before = pc.PAIRCOUNT_LAUNCHES
    cpu = dataclasses.replace(sweep, pos1=sweep.pos1.cpu(),
                              labels1=sweep.labels1.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        pc.paircount_launch(cpu)
    with pytest.raises(ValueError, match="float32"):
        pc.paircount_launch(dataclasses.replace(sweep,
                                                pos1=sweep.pos1.double()))
    with pytest.raises(ValueError, match="int32"):
        pc.paircount_launch(dataclasses.replace(
            sweep, labels1=sweep.labels1.long()))
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        pc.paircount_launch(dataclasses.replace(sweep,
                                                pos1=sweep.pos1[:, :2]))
    with pytest.raises(ValueError, match="below n_labels"):
        pc.paircount_launch(dataclasses.replace(sweep, n_labels_1=3,
                                                n_labels_2=3))
    outside = sweep.pos1.clone()
    outside[3, 0] = L + 1.0
    with pytest.raises(ValueError, match="period"):
        pc.paircount_launch(dataclasses.replace(sweep, pos1=outside))
    with pytest.raises(ValueError, match="contiguous"):
        pc.paircount_launch(dataclasses.replace(
            sweep, pos1=torch.cat([sweep.pos1, sweep.pos1], 1)[:, ::2]))
    assert pc.PAIRCOUNT_LAUNCHES == before
