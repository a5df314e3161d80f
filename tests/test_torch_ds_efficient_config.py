"""The benchmark's ds_efficient configuration (the decorated Leauthaud11
HOD on TabCorr's 'efficient' Delta Sigma grid) held against its plain
reference, ``benchmark/reference/leauthaud11_tables.py``, on the CPU.

The reference is written from the published equations and imports
nothing of the port.  Here it is held to the port's plain engine in
float64 (the real table and a seeded random cross-mode grid, rows
outside the grid included), to the fused engine's CPU version in float32
at the limits the configuration sets it (its ``cpu_version_limits``), and
to itself (the SHMR's inversion).
"""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tabcorr_tpu_torch as tt
from tabcorr_tpu_torch.io import ColumnTable

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CONFIG = json.loads(
    (BENCH / "configs" / "assembias_leauthaud11_ds_efficient.json")
    .read_text())
STRENGTHS = ("mean_occupation_centrals_assembias_param1",
             "mean_occupation_satellites_assembias_param1")


def _bench(name):
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    return importlib.import_module(name)


def _model(redshift=0.5):
    model = tt.AssembiasLeauthaud11Model(redshift=redshift,
                                         **CONFIG["model"]["kwargs"])
    model.param_dict.update(CONFIG["fiducial"])
    return model


def _params(rows, seed, spread=0.05, log_eta=None):
    """Seeded rows around the fiducial point, inside the priors; the
    sampled grid key uniform over ``log_eta`` (an interval wider than the
    grid puts rows outside it)."""
    g = torch.Generator().manual_seed(seed)
    p = {}
    for k, v in CONFIG["fiducial"].items():
        x = float(v) + spread * torch.randn(rows, generator=g,
                                            dtype=torch.float64)
        if k in CONFIG["bounds"]:
            lo, hi = CONFIG["bounds"][k]
            x = x.clamp(lo + 1e-3, hi - 1e-3)
        p[k] = x
    if log_eta is not None:
        lo, hi = log_eta
        p["log_eta"] = lo + (hi - lo) * torch.rand(rows, generator=g,
                                                   dtype=torch.float64)
    return p


def _real_grid():
    raw = _bench("systems.interpolator_file").read_grid(
        BENCH / "data" / "ds_efficient.npz")
    return raw, tt.Interpolator.read(BENCH / "data" / "ds_efficient.npz")


def _random_grid(seed, n_prim=6, n_xi=5):
    """A seeded cross-mode grid: 2 x 6 x 2 = 24 bins (two concentration
    halves), 5 r_p rows, 4 nodes over log_eta; as raw arrays and as the
    port's Interpolator."""
    rng = np.random.default_rng(seed)
    cols = _bench("tables.synthetic_default_grid").columns(
        n_prim, 2, rng.uniform(-2.0, 2.0, 4 * n_prim))
    n_bins = 4 * n_prim
    values = np.array([[-0.4771212637424469], [-0.1590404212474823],
                       [0.1590404212474823], [0.4771212637424469]])
    base = 10.0 ** rng.uniform(11.0, 14.0, (n_xi, n_bins))
    matrix = base[None] * (1.0 + 0.1 * rng.standard_normal((4, n_xi,
                                                            n_bins)))
    raw = _bench("benchlib.inputs").RawTable(
        matrix=matrix, columns=cols, mode="cross", tpcf_shape=(n_xi,),
        redshift=0.5, grid=(["log_eta"], values))
    tabs = []
    for m in matrix:
        t = tt.TabCorr()
        t.gal_type = ColumnTable(cols)
        t.attrs = {"mode": "cross", "tpcf": "mean_delta_sigma",
                   "redshift": 0.5, "simname": "synthetic",
                   "Num_ptcl_requirement": 300,
                   "prim_haloprop_key": "halo_m258m",
                   "sec_haloprop_key": "halo_nfw_conc"}
        t.tpcf_shape = (n_xi,)
        t.tpcf_matrix = m
        tabs.append(t)
    return raw, tt.Interpolator(tabs, ColumnTable({"log_eta": values[:, 0]}))


def _reference(raw, precision="float64"):
    return _bench("reference.leauthaud11_tables").Reference(
        [raw], CONFIG, "cpu", precision=precision)


def _float64_pair(grid, params):
    raw, interp = grid
    want, = _reference(raw).predict(params)
    got = tt.make_predictor(interp, _model(raw.redshift),
                            dtype=torch.float64, engine="plain",
                            device="cpu")(params)
    return got, want


def _cpu_version_limits():
    """The limits of the fused engine's CPU version: the card's, with the
    configuration's ``cpu_version_limits`` in their place (that version
    evaluates the occupation in float32, the card's kernel in float64)."""
    limits = dict(CONFIG["limits"])
    limits.update((k, v) for k, v in CONFIG["cpu_version_limits"].items()
                  if k in limits)
    return limits


def _rel(got, want):
    return float((got.double().reshape(want.shape) / want - 1.0).abs().max())


@pytest.mark.parametrize("grid", ["ds_efficient", "random_cross"])
def test_the_port_in_float64_matches_the_reference(grid):
    """16 rows, 4 of them outside the log_eta grid: NaN on both
    sides there, 1e-10 relative elsewhere (both are float64; the port
    inverts the SHMR by a seeded Newton walk, the reference by bisection).
    """
    grid = _real_grid() if grid == "ds_efficient" else _random_grid(5)
    params = _params(16, 3, log_eta=(-0.45, 0.45))
    params["log_eta"][[2, 7, 11, 15]] = torch.tensor(
        [0.5, -0.48, 0.65, -0.9], dtype=torch.float64)
    (ngal_p, ds_p), (ngal_r, ds_r) = _float64_pair(grid, params)
    outside = params["log_eta"].abs() > 0.4771212637424469
    assert int(outside.sum()) == 4
    ds_p = ds_p.reshape(ds_r.shape)
    for got, want in ((ngal_p, ngal_r), (ds_p, ds_r)):
        nan_p = torch.isnan(got.reshape(16, -1)).any(dim=1)
        nan_r = torch.isnan(want.reshape(16, -1)).any(dim=1)
        assert torch.equal(nan_p, outside) and torch.equal(nan_r, outside)
    inside = ~outside
    assert _rel(ngal_p[inside], ngal_r[inside]) < 1e-10
    assert _rel(ds_p[inside], ds_r[inside]) < 1e-10
    assert bool((ds_r[inside] > 0).all())


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_rows_beyond_the_relation_s_domain_are_nan_and_flat_ones_agree(
        engine):
    """Proposals beyond the priors reach relations that turn (beta, delta
    or gamma <= 0 at z = 0.5: NaN on both sides) or are nearly flat at low
    mass (beta 5e-4: the lowest halos' roots lie below 10^5 M*, which both
    sides take as the bracket's end)."""
    raw, interp = _real_grid()
    params = _params(6, 41, spread=0.0, log_eta=(-0.3, 0.3))
    params["smhm_beta_0"] = torch.tensor(
        [0.43, 0.0605, 0.065, 0.03, 0.43, 0.43], dtype=torch.float64)
    params["smhm_delta_0"][4] = 0.02
    params["smhm_gamma_0"][5] = 0.8
    want, = _reference(raw).predict(params)
    dtype = torch.float64 if engine == "plain" else torch.float32
    got = tt.make_predictor(interp, _model(), dtype=dtype, engine=engine,
                            device="cpu")({k: v.to(dtype)
                                           for k, v in params.items()})
    outside = torch.tensor([False] * 3 + [True] * 3)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g.reshape(6, -1)).any(dim=1), outside)
        assert torch.equal(torch.isnan(w.reshape(6, -1)).any(dim=1), outside)
    limits = _cpu_version_limits() if engine == "fused" else dict(
        ngal_rel_err=1e-10, ds_rel_err=1e-10)
    assert _rel(got[0][:3], want[0][:3]) <= limits["ngal_rel_err"]
    assert _rel(got[1][:3], want[1][:3]) <= limits["ds_rel_err"]


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 7])
def test_the_fused_cpu_version_meets_the_configuration_limits(seed):
    """The fused engine's CPU version (float32; the card runs the kernels)
    at the limits the configuration sets it: ngal and each Delta Sigma
    element relative."""
    raw, interp = _real_grid()
    params = _params(32, seed, spread=0.02, log_eta=(-0.45, 0.45))
    want, = _reference(raw).predict(params)
    predict = tt.make_predictor(interp, _model(), engine="fused",
                                accuracy="elementwise", device="cpu")
    ngal, ds = predict({k: v.float() for k, v in params.items()})
    assert ngal.dtype == torch.float32
    limits = _cpu_version_limits()
    assert _rel(ngal, want[0]) <= limits["ngal_rel_err"]
    assert _rel(ds, want[1]) <= limits["ds_rel_err"]


@pytest.mark.parametrize("strength", [0.8, -0.8])
@pytest.mark.parametrize("kind", ["centrals", "satellites"])
def test_a_decoration_strength_moves_delta_sigma_alike_on_both_sides(
        kind, strength):
    """A strength of +-0.8 on one galaxy type moves Delta Sigma by far
    more than the sides' agreement, in the same way on both."""
    grid = _real_grid()
    params = _params(4, 17, spread=0.0, log_eta=(-0.4, 0.4))
    for k in STRENGTHS:
        params[k] = torch.zeros(4, dtype=torch.float64)
    (_, plain_p), (_, plain_r) = _float64_pair(grid, params)
    key = STRENGTHS[kind == "satellites"]
    params[key] = torch.full((4,), strength, dtype=torch.float64)
    (_, ds_p), (_, ds_r) = _float64_pair(grid, params)
    moved_r = ds_r / plain_r - 1.0
    moved_p = ds_p.reshape(ds_r.shape) / plain_p.reshape(ds_r.shape) - 1.0
    assert float(moved_r.abs().max()) > 1e-3
    assert float((moved_p - moved_r).abs().max()) < 1e-10


def test_the_reference_inverts_the_stellar_to_halo_mass_relation():
    """f_SHMR(M_h(M*)) = M* to 1e-12 over the bracket's inside, at the
    fiducial point and a row of other coefficients."""
    ref = _bench("reference.leauthaud11_tables")
    params = _params(2, 23, spread=0.05)
    q = {k: v[:, None] for k, v in params.items()}
    coeffs = ref.smhm_coefficients(q, 1.0 / 1.5)
    log_mstar = torch.linspace(8.0, 12.5, 91, dtype=torch.float64)[None]
    log_mh = ref.log_halo_mass(log_mstar, coeffs)
    back = ref.log_stellar_mass(log_mh, coeffs)
    assert float((back - log_mstar).abs().max()) < 1e-12
    # Monotone, so the bisection has one root to find.
    assert bool((log_mh.diff(dim=1) > 0).all())


@pytest.mark.parametrize("i, key", [(0, "ngal_rel_err"), (1, "ds_rel_err")])
def test_the_tf32_control_is_a_lower_precision(i, key):
    """The reference's float32 / TF32 control misses the float64 reference
    by more than the limit the configuration holds the card to, in ngal
    and in Delta Sigma."""
    raw, _ = _real_grid()
    params = _params(64, 29, spread=0.02, log_eta=(-0.45, 0.45))
    want, = _reference(raw).predict(params)
    got, = _reference(raw, "tf32").predict(params)
    assert got[i].dtype == torch.float32
    assert _rel(got[i], want[i]) > CONFIG["limits"][key]
