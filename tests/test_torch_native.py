"""The port's host C++ pair counter (``tabcorr_tpu_torch.native``) and the
routes to it: ``labeled_pair_count(strategy="native", device="cpu")`` and
``TabCorr.tabulate(backend="native", device="cpu")``.

The counter is built from the port's own copy of the JAX package's
source, so it must count bit for bit as ``tabcorr_tpu.native`` does: unit
counts and weights that are integer multiples of a power of two, whose
float64 sums are exact in any order.  The ln(rp) channel is held at 1e-13:
the counter's OpenMP loop is scheduled dynamically, so two calls of one
library sum it in different orders.  Both are also held against a float64
brute force.  Then the refusals, the build
directory and its name, and ``progress=`` (tqdm, or plain lines on stderr
without it).
"""

import builtins
import re
from pathlib import Path

import numpy as np
import pytest

import tabcorr_tpu as tt
import tabcorr_tpu.native as jnative
import tabcorr_tpu.ops.paircount as jpc
import tabcorr_tpu_torch as tp
from tabcorr_tpu_torch import native
from tabcorr_tpu_torch.ops import paircount as pc

ROOT = Path(__file__).absolute().parents[1]
LBOX = 40.0
R_EDGES = np.logspace(-1, 1, 7)
MU_EDGES = np.linspace(0, 1, 5)


def _tracers(n, n_labels, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, LBOX, (n, 3)), rng.integers(-1, n_labels, n)


def _brute(pos1, lab1, n1, pos2, lab2, n2, weights2, kind, pi_max,
           pair_weight, auto):
    """Float64 labeled counts: every ordered pair (self-pairs out)."""
    d = pos1[:, None, :] - pos2[None, :, :]
    d -= LBOX * np.round(d / LBOX)
    rp_sq = d[..., 0] ** 2 + d[..., 1] ** 2
    dz = np.abs(d[..., 2])
    ok = (lab1[:, None] >= 0) & (lab2[None, :] >= 0)
    if auto:
        np.fill_diagonal(ok, False)
    e_sq = R_EDGES ** 2
    n_mu = len(MU_EDGES) - 1 if kind == "smu" else 1
    if kind == "smu":
        s_sq = rp_sq + dz ** 2
        r_bin = np.searchsorted(e_sq, s_sq, side="right") - 1
        mu = np.where(s_sq > 0, dz / np.sqrt(np.maximum(s_sq, 1e-300)), 0.0)
        sub = r_bin * n_mu + np.minimum((mu * n_mu).astype(int), n_mu - 1)
        ok &= s_sq > 0
    else:
        r_bin = np.searchsorted(e_sq, rp_sq, side="right") - 1
        sub = r_bin
        if kind == "rppi":
            ok &= dz < pi_max
    ok &= (r_bin >= 0) & (r_bin < len(R_EDGES) - 1)
    cell = (lab1[:, None] * n2 + lab2[None, :]) * (len(R_EDGES) - 1) * n_mu
    cell = (cell + sub)[ok]
    w = np.broadcast_to(weights2[None, :], ok.shape)[ok]
    size = n1 * n2 * (len(R_EDGES) - 1) * n_mu
    log_w = w * 0.5 * np.log(np.maximum(rp_sq[ok], 1e-300))
    chans = {"unit": [w], "log_rp": [log_w], "unit+log_rp": [w, log_w]}
    out = np.stack([np.bincount(cell, weights=c, minlength=size)
                    for c in chans[pair_weight]])
    shape = (n1, n2, len(R_EDGES) - 1) + ((n_mu,) if kind == "smu" else ())
    return out.reshape((-1,) + shape)


CASES = {
    "rppi-auto": dict(kind="rppi", pi_max=8.0),
    "smu-auto": dict(kind="smu", mu_edges=MU_EDGES),
    "rppi-cross": dict(kind="rppi", pi_max=5.0, cross=True),
    "proj-weighted": dict(kind="proj", cross=True, weights=True),
    "proj-log-rp": dict(kind="proj", cross=True, weights=True,
                        pair_weight="log_rp"),
    "proj-unit+log-rp": dict(kind="proj", cross=True, weights=True,
                             pair_weight="unit+log_rp"),
    "smu-weighted-auto": dict(kind="smu", mu_edges=MU_EDGES, weights=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_counts_equal_tabcorr_tpu_and_brute_force(case):
    c = dict(CASES[case])
    cross, weights = c.pop("cross", False), c.pop("weights", False)
    pair_weight = c.pop("pair_weight", "unit")
    pos1, lab1 = _tracers(700, 3, 1)
    kw = dict(period=LBOX, r_edges=R_EDGES, pair_weight=pair_weight, **c)
    n2 = 3
    pos2 = lab2 = None
    if cross:
        pos2, lab2 = _tracers(900, 2, 2)
        lab2 = np.abs(lab2)   # every j-tracer labeled
        n2 = 2
        kw.update(pos2=pos2, labels2=lab2, n_labels_2=n2)
    w2 = None
    if weights:
        w2 = np.random.default_rng(3).integers(
            1, 5, 900 if cross else 700) * 2.0 ** 33
        kw["weights2"] = w2
    got = native.labeled_pair_count(pos1, lab1, 3, **kw)
    exact = "log_rp" not in pair_weight
    for other in (jnative.labeled_pair_count(pos1, lab1, 3, **kw),
                  pc.labeled_pair_count(pos1, lab1, 3, **kw,
                                        strategy="native", device="cpu")):
        if exact:
            np.testing.assert_array_equal(got, other)
        else:
            np.testing.assert_allclose(got, other, rtol=1e-13, atol=0)
    want = _brute(pos1, lab1, 3, pos1 if pos2 is None else pos2,
                  lab1 if lab2 is None else lab2, n2,
                  np.ones(len(pos1) if pos2 is None else len(pos2))
                  if w2 is None else w2, c["kind"], c.get("pi_max"),
                  pair_weight, not cross)
    want = want if pair_weight == "unit+log_rp" else want[0]
    if w2 is None:
        np.testing.assert_array_equal(got, want)
        assert got.sum() > 0
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def test_native_agrees_with_the_plain_version():
    # float64 geometry against the plain version's float32: equal unit
    # counts where no pair lies within a float32 ulp of an edge.
    pos, lab = _tracers(1500, 4, 5)
    kw = dict(period=LBOX, kind="rppi", r_edges=R_EDGES, pi_max=8.0)
    np.testing.assert_array_equal(
        pc.labeled_pair_count(pos, lab, 4, strategy="native", device="cpu",
                              **kw),
        pc.labeled_pair_count(pos, lab, 4, device="cpu", **kw))


def test_native_refusals():
    pos, lab = _tracers(50, 2, 0)
    with pytest.raises(ValueError, match="uniform mu"):
        native.labeled_pair_count(pos, lab, 2, period=LBOX, kind="smu",
                                  r_edges=R_EDGES,
                                  mu_edges=[0, 0.2, 0.5, 1.0])
    with pytest.raises(ValueError, match="pi_max"):
        native.labeled_pair_count(pos, lab, 2, period=LBOX, kind="rppi",
                                  r_edges=R_EDGES)
    with pytest.raises(ValueError, match="below"):
        native.labeled_pair_count(pos, lab, 1, period=LBOX, kind="proj",
                                  r_edges=R_EDGES)
    for device in ("cuda", None):
        with pytest.raises(ValueError, match="device='cpu'"):
            pc.labeled_pair_count(pos, lab, 2, period=LBOX, kind="proj",
                                  r_edges=R_EDGES, strategy="native",
                                  device=device)
    with pytest.raises(ValueError, match="strategy"):
        pc.labeled_pair_count(pos, lab, 2, period=LBOX, kind="proj",
                              r_edges=R_EDGES, strategy="scatter",
                              device="cpu")


def test_native_builds_from_the_ports_source_into_build_native(
        monkeypatch):
    # The port's copy is the JAX package's source, byte for byte.
    assert native.SOURCE.read_bytes() == (
        ROOT / "tabcorr_tpu" / "native_src" / "paircount.cpp").read_bytes()
    assert native.SOURCE.parent == ROOT / "tabcorr_tpu_torch" / "native_src"
    path = native.library_path()
    assert path.parent == ROOT / "build" / "native"
    assert re.fullmatch(r"libtabcorr_paircount-[0-9a-f]{16}\.so", path.name)
    lib = native.load_library()
    assert Path(lib._name) == path and path.exists()
    assert not list(path.parent.glob("*.tmp"))
    assert native.native_available()
    # The name follows the flags (and the source).
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path
    assert native.library_path().parent == path.parent


def test_nothing_routes_to_native_unless_asked(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the C++ counter was called")

    monkeypatch.setattr(native, "labeled_pair_count", refuse)
    pos, lab = _tracers(300, 2, 4)
    pc.labeled_pair_count(pos, lab, 2, period=LBOX, kind="smu",
                          r_edges=R_EDGES, mu_edges=MU_EDGES, device="cpu")


def _catalogs(n_halos=600, seed=2):
    rng = np.random.default_rng(seed)
    mass = 10.0 ** rng.uniform(12.0, 13.5, n_halos)
    cols = {f"halo_{a}": rng.uniform(0, 100.0, n_halos) for a in "xyz"}
    cols.update({f"halo_v{a}": 300 * rng.normal(size=n_halos)
                 for a in "xyz"})
    cols.update(halo_mvir=mass, halo_rvir=0.3 * (mass / 1e13) ** (1 / 3),
                halo_nfw_conc=8 * (mass / 1e13) ** -0.1,
                halo_upid=np.full(n_halos, -1, dtype=np.int64))
    return [pkg.HaloCatalog({k: v.copy() for k, v in cols.items()},
                            Lbox=100.0, particle_mass=1e9, redshift=0.0,
                            cosmology=pkg.cosmology.FlatFLRW(
                                H0=70, Om0=0.3, Tcmb0=0, Neff=0),
                            simname="synthetic") for pkg in (tt, tp)]


PTCL = np.random.default_rng(7).uniform(0, 100.0, (2000, 3))
TAB_CASES = {
    "wp": ("wp", (R_EDGES, 20.0), dict(mode="auto")),
    "s_mu": ("s_mu_tpcf", (R_EDGES, MU_EDGES), dict(mode="auto",
                                                    project_xyz=True)),
    "ds": ("mean_delta_sigma", (PTCL, 1e9, R_EDGES),
           dict(mode="cross", prim_haloprop_bins=5)),
}


@pytest.mark.parametrize("case", list(TAB_CASES))
def test_tabulate_native_matches_tabcorr_tpu_native(case):
    name, args, kwargs = TAB_CASES[case]
    kwargs = dict(dict(prim_haloprop_bins=4, sats_per_prim_haloprop=1e-12,
                       seed=5), **kwargs)
    cat_j, cat_t = _catalogs()
    tab_j = tt.TabCorr.tabulate(cat_j, getattr(tt.corrfunc, name), *args,
                                backend="native", **kwargs)
    tab_t = tp.TabCorr.tabulate(cat_t, getattr(tp.corrfunc, name), *args,
                                backend="native", device="cpu", **kwargs)
    assert tab_t.attrs == tab_j.attrs
    for col in tab_j.gal_type.colnames:
        np.testing.assert_array_equal(tab_t.gal_type[col],
                                      tab_j.gal_type[col])
    # Tables at test_torch_tabulate.py's 1e-9: the counter's float64 sums
    # come in a different order each call (~1e-14), and Delta Sigma's
    # annulus bracket cancels them up to ~1e-11.
    np.testing.assert_allclose(tab_t.tpcf_matrix, tab_j.tpcf_matrix,
                               rtol=1e-9,
                               atol=1e-9 * np.abs(tab_j.tpcf_matrix).max())
    with pytest.raises(ValueError, match="device='cpu'"):
        tp.TabCorr.tabulate(cat_t, getattr(tp.corrfunc, name), *args,
                            backend="native", **kwargs)


def _block_tqdm(monkeypatch):
    real_import = builtins.__import__

    def no_tqdm(name, *args, **kwargs):
        if name == "tqdm" or name.startswith("tqdm."):
            raise ImportError("No module named 'tqdm'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tqdm)


@pytest.mark.parametrize("tqdm_installed", [True, False])
def test_progress_reports_one_step_a_chunk_window(capsys, monkeypatch,
                                                  tqdm_installed):
    # 2,500 labeled i-tracers: three i-chunk windows of 1,024 on the
    # plain version.
    pos, lab = _tracers(2500, 3, 6)
    lab = np.abs(lab)
    kw = dict(period=LBOX, kind="rppi", r_edges=R_EDGES, pi_max=8.0,
              device="cpu")
    quiet = pc.labeled_pair_count(pos, lab, 3, **kw)
    assert capsys.readouterr().err == ""
    if not tqdm_installed:
        _block_tqdm(monkeypatch)
    shown = pc.labeled_pair_count(pos, lab, 3, progress=True, **kw)
    np.testing.assert_array_equal(shown, quiet)
    err = capsys.readouterr().err
    if tqdm_installed:
        assert "pair counting" in err and "3/3" in err
    else:
        assert err.splitlines() == [f"pair counting: {i}/3"
                                    for i in (1, 2, 3)]


def test_verbose_tabulation_shows_its_sweeps_without_tqdm(capsys,
                                                          monkeypatch):
    # The fast path's sweeps and the generic path's per-bin-pair tasks.
    _, cat_t = _catalogs()
    _block_tqdm(monkeypatch)
    kw = dict(prim_haloprop_bins=2, sats_per_prim_haloprop=1e-12, seed=5,
              device="cpu", verbose=True)
    tp.TabCorr.tabulate(cat_t, "wp", R_EDGES, 20.0, **kw)
    err = capsys.readouterr().err
    assert re.search(r"^pair counting: 1/\d+$", err, re.M)

    def user_wp(*args, **kwargs):
        return tp.corrfunc.wp(*args, device="cpu", **kwargs)

    tp.TabCorr.tabulate(cat_t, user_wp, R_EDGES, 20.0, **kw)
    lines = capsys.readouterr().err.splitlines()
    assert lines and lines[-1] == "progress: 10/10"   # 4 labels: 10 pairs


def test_tabcorr_tpu_progress_is_what_the_port_mirrors(monkeypatch):
    # tabcorr_tpu's sweep takes progress= the same way (one bar a sweep).
    monkeypatch.setattr(jpc, "_native_eligible", lambda *a: False)
    pos, lab = _tracers(300, 2, 8)
    out = jpc.labeled_pair_count(pos, lab, 2, period=LBOX, kind="rppi",
                                 r_edges=R_EDGES, pi_max=8.0, progress=True)
    np.testing.assert_array_equal(out, pc.labeled_pair_count(
        pos, lab, 2, period=LBOX, kind="rppi", r_edges=R_EDGES, pi_max=8.0,
        progress=True, device="cpu"))
