"""The plain reference against the port's plain float64 engine at a tiny
size on the CPU, and its spline against closed forms.  (The reference
imports nothing of the port; this test does, to compare.)"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from benchlib import manifest  # noqa: E402

ROWS = 12


def random_params(cfg, rows, seed):
    g = torch.Generator().manual_seed(seed)
    p = {}
    for k, v in cfg["fiducial"].items():
        lo, hi = cfg["bounds"].get(k, (None, None))
        x = float(v) + 0.05 * torch.randn(rows, generator=g,
                                          dtype=torch.float64)
        if k in cfg.get("grid", {}).get("axes", {}):
            axis = cfg["grid"]["axes"][k]
            x = axis[0] + (axis[-1] - axis[0]) * torch.rand(
                rows, generator=g, dtype=torch.float64)
        p[k] = x if lo is None else x.clamp(lo + 1e-3, hi - 1e-3)
    return p


@pytest.mark.parametrize("name", ["zheng07_wp_xiell", "zheng07_grid64"])
def test_reference_matches_the_port_in_float64(name):
    import tabcorr_tpu_torch as tt
    cfg = manifest.Manifest().config(name)
    system = manifest.load("systems", cfg["system"])
    raw = system.inputs(cfg, 11, torch.device("cpu"))
    ref = manifest.load("reference", cfg["reference"]).Reference(
        raw, cfg, "cpu")
    params = random_params(cfg, ROWS, 3)
    want = ref.predict(params)
    from benchlib.inputs import hod_model
    model = hod_model(cfg, raw[0].redshift)
    if cfg["system"] == "tabcorr":
        tabs = [tt.TabCorr.read(ROOT / t["file"]) for t in cfg["tables"]]
        got = tt.make_multi_predictor(tabs, model, dtype=torch.float64,
                                      engine="auto", device="cpu")(params)
    else:
        interp = system.interpolator(raw[0])
        got = [tt.make_predictor(interp, model, dtype=torch.float64,
                                 engine="plain", device="cpu")(params)]
    for (ng, xg), (nw, xw) in zip(got, want):
        assert torch.allclose(ng, nw, rtol=1e-10, atol=0)
        xg = xg.reshape(ROWS, -1)
        assert float(((xg - xw).abs().amax(1) / xw.abs().amax(1)).max()) \
            < 1e-10


def test_out_of_grid_rows_are_nan():
    cfg = manifest.Manifest().config("zheng07_grid64")
    system = manifest.load("systems", cfg["system"])
    raw = system.inputs(cfg, 2, torch.device("cpu"))
    ref = manifest.load("reference", cfg["reference"]).Reference(
        raw, cfg, "cpu")
    params = random_params(cfg, 4, 5)
    params["alpha_c"][1] = 0.41
    params["log_eta"][2] = -0.48
    ngal, xi = ref.predict(params)[0]
    assert torch.isnan(xi[1]).all() and torch.isnan(xi[2]).all()
    assert torch.isnan(ngal[1]) and torch.isnan(ngal[2])
    assert torch.isfinite(xi[[0, 3]]).all()


def test_the_not_a_knot_spline_of_4_nodes_is_the_cubic_through_them():
    hod = manifest.load("reference", "hod_tables")
    xp = np.array([-0.4771212637424469, -0.1590404212474823,
                   0.1590404212474823, 0.4771212637424469])
    c = hod.not_a_knot_basis(xp)
    for x in (-0.47, -0.2, 0.0, 0.3, 0.4771):
        k = min(max(np.searchsorted(xp, x, side="right") - 1, 0), 2)
        w = np.einsum("pj,p->j", c[k], (x - xp[k]) ** np.arange(4))
        lagrange = [np.prod([(x - xp[m]) / (xp[j] - xp[m])
                             for m in range(4) if m != j])
                    for j in range(4)]
        assert np.allclose(w, lagrange, rtol=0, atol=1e-12)


def test_the_not_a_knot_spline_matches_scipy_on_more_nodes():
    from scipy.interpolate import CubicSpline
    hod = manifest.load("reference", "hod_tables")
    xp = np.array([0.0, 0.3, 0.45, 1.0, 1.7, 2.0])
    y = np.sin(3 * xp) + xp ** 2
    c = hod.not_a_knot_basis(xp)
    spline = CubicSpline(xp, y)
    for x in np.linspace(0, 2, 17):
        k = min(max(np.searchsorted(xp, x, side="right") - 1, 0), 4)
        got = np.einsum("pj,j,p->", c[k], y, (x - xp[k]) ** np.arange(4))
        assert got == pytest.approx(float(spline(x)), abs=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    hod = manifest.load("reference", "hod_tables")
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      3.0], dtype=torch.float32)
    got = hod.round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, 3.0]
