"""The stellar-to-halo-mass relation's inverse and its domain.

f_SHMR inverts the Behroozi et al. (2010) relation, which increases by
its form where beta, delta and gamma are all positive; elsewhere it may
turn and has no inverse, and the port's f_SHMR is NaN there, on every
engine (``models.leauthaud11.shmr_increasing``); so are the centrals
whose log-normal scatter is not positive (``positive``).  Near the
domain's edge the relation is flat at low mass: a root beyond [5, 13] dex
of M* is the bracket's end, and the occupation kernel reseeds its Newton
walk where beta lets the root move far between nodes.

The CPU tests cover the Python engines; the test marked ``gpu`` holds the
occupation kernel to the plain float64 engine on such rows and skips
without a card.  The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_shmr_domain.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import tabcorr_tpu_torch as tt
from tabcorr_tpu_torch.models.leauthaud11 import (fshmr_log_mstar,
                                                  shmr_increasing)
from tabcorr_tpu_torch.models.zu_mandelbaum15 import zu15_log_mstar

DATA = Path(tt.__file__).parent / "data"
A = 1.0 / 1.5       # ds_efficient's scale factor (z = 0.5)
# smhm_beta_0 - 0.06, smhm_delta_0 - 0.06 and smhm_gamma_0 - 0.84 are the
# coefficients at z = 0.5 with the published *_a terms.
ROWS = {                           # (beta_0, delta_0, gamma_0, scatter)
    "fiducial": (0.43, 0.56, 1.54, 0.2),
    "flat, beta 5e-4": (0.0605, 0.56, 1.54, 0.2),
    "flat, beta 1e-3, delta 0.02": (0.061, 0.08, 1.54, 0.2),
    "flat, beta 5e-3, gamma 0.02": (0.065, 0.56, 0.86, 0.2),
    "scatter 1e-3": (0.43, 0.56, 1.54, 1e-3),
    "beta < 0": (0.03, 0.56, 1.54, 0.2),
    "delta < 0": (0.43, 0.02, 1.54, 0.2),
    "gamma < 0": (0.43, 0.56, 0.8, 0.2),
    "scatter < 0": (0.43, 0.56, 1.54, -0.05),
}
OUTSIDE = [k.endswith("< 0") for k in ROWS]
COLUMNS = ("smhm_beta_0", "smhm_delta_0", "smhm_gamma_0",
           "scatter_model_param1")


def _leauthaud11_params(model, dtype, device):
    rows = len(ROWS)
    p = {k: torch.full((rows,), float(v), dtype=dtype, device=device)
         for k, v in model.param_dict.items()}
    for col, key in enumerate(COLUMNS):
        p[key] = torch.tensor([r[col] for r in ROWS.values()], dtype=dtype,
                              device=device)
    return p


def _ds_model():
    model = tt.AssembiasLeauthaud11Model(
        threshold=10.5, redshift=0.5, prim_haloprop_key="halo_m258m")
    model.param_dict.update(
        mean_occupation_centrals_assembias_param1=0.3,
        mean_occupation_satellites_assembias_param1=-0.3, log_eta=0.0)
    return model


@pytest.mark.parametrize("coeffs, want", [
    ((0.37, 0.5, 0.7), True), ((1e-9, 1e-9, 1e-9), True),
    ((0.0, 0.5, 0.7), False), ((0.37, -0.1, 0.7), False),
    ((0.37, 0.5, -0.2), False), ((-0.37, -0.5, -0.7), False)])
def test_the_relation_increases_by_its_form_only_with_positive_terms(
        coeffs, want):
    assert bool(shmr_increasing(*coeffs)) is want
    # Where it does, its derivative is positive from 10^5 to 10^13 M*.
    if want:
        beta, delta, gamma = coeffs
        x = np.linspace(-6.0, 3.0, 2001)
        s = 10.0 ** (-gamma * x)
        d = beta + np.log(10) * 10.0 ** (delta * x) * (
            delta + (delta + gamma) * s) / (1 + s) ** 2
        assert (d > 0).all()


@pytest.mark.parametrize("backend", ["numpy", "float64", "float32"])
def test_f_shmr_is_nan_outside_the_domain_and_only_there(backend):
    params = dict(tt.models.leauthaud11.LEAUTHAUD11_PARAMS)
    log_mh = np.linspace(11.8, 15.4, 7)
    cols = {k: np.array([r[i] for r in ROWS.values()])
            for i, k in enumerate(COLUMNS[:3])}
    shmr = [not k.endswith("< 0") or "scatter" in k for k in ROWS]
    if backend == "numpy":   # the host path: one parameter vector a call
        got = np.stack([fshmr_log_mstar(log_mh, dict(params, **{
            k: float(v[r]) for k, v in cols.items()}), A)
            for r in range(len(ROWS))])
    else:
        dtype = getattr(torch, backend)
        p = {k: torch.tensor(v, dtype=dtype) for k, v in params.items()}
        p.update({k: torch.tensor(v, dtype=dtype)[:, None]
                  for k, v in cols.items()})
        got = fshmr_log_mstar(torch.tensor(log_mh, dtype=dtype)[None], p,
                              A).numpy()
    nan_rows = np.isnan(got).all(axis=1)
    assert (~nan_rows).tolist() == shmr
    assert np.isfinite(got[~nan_rows]).all()
    # Python numbers: a scalar NaN or the root.
    scalar = dict(params, smhm_beta_0=0.0)
    assert np.isnan(fshmr_log_mstar(np.float64(12.0), scalar, A))
    assert np.isfinite(fshmr_log_mstar(np.float64(12.0), params, A))


def test_zu15_inverse_has_the_same_domain():
    model = tt.ZuMandelbaum15Model(threshold=10.5)
    p = {k: torch.full((3, 1), float(v), dtype=torch.float64)
         for k, v in model.param_dict.items()}
    p["smhm_beta"] = torch.tensor([[0.33], [-0.1], [0.33]],
                                  dtype=torch.float64)
    p["smhm_gamma"] = torch.tensor([[1.21], [1.21], [0.0]],
                                   dtype=torch.float64)
    got = zu15_log_mstar(torch.linspace(11.0, 15.0, 5,
                                        dtype=torch.float64)[None], p)
    assert torch.isfinite(got[0]).all()
    assert torch.isnan(got[1:]).all()


@pytest.mark.parametrize("engine, dtype", [("plain", torch.float64),
                                           ("fused", torch.float32)])
def test_a_predictor_gives_nan_rows_outside_the_domain(engine, dtype):
    """The ds_efficient grid with the decorated Leauthaud11 model: every
    row outside the domain NaN (ngal and Delta Sigma), every other finite;
    on the CPU the fused engine runs its plain version."""
    model = _ds_model()
    interp = tt.Interpolator.read(DATA / "ds_efficient.npz")
    predict = tt.make_predictor(interp, model, dtype=dtype, engine=engine,
                                device="cpu")
    ngal, ds = predict(_leauthaud11_params(model, dtype, "cpu"))
    nan_rows = torch.isnan(ds).any(dim=1) | torch.isnan(ngal)
    assert nan_rows.tolist() == OUTSIDE
    assert torch.isnan(ds[nan_rows]).all()
    assert torch.isfinite(ds[~nan_rows]).all()


@pytest.mark.gpu
def test_on_the_card_the_kernel_keeps_the_domain_and_flat_relations():
    """The occupation kernel (then the grid kernel) against the plain
    float64 engine on the card: NaN rows alike, and the flat relations'
    rows within the 1e-6 contract."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _ds_model()
    interp = tt.Interpolator.read(DATA / "ds_efficient.npz")
    params = _leauthaud11_params(model, torch.float32, "cuda")
    fused = tt.make_predictor(interp, model, engine="fused",
                              accuracy="elementwise", device="cuda")
    plain = tt.make_predictor(interp, model, dtype=torch.float64,
                              engine="plain", device="cuda")
    ngal, ds = (x.double() for x in fused(params))
    ngal_p, ds_p = plain({k: v.double() for k, v in params.items()})
    nan_rows = torch.isnan(ds).any(dim=1) | torch.isnan(ngal)
    assert nan_rows.tolist() == OUTSIDE
    assert (torch.isnan(ds_p).any(dim=1) | torch.isnan(ngal_p)).tolist() \
        == OUTSIDE
    keep = ~nan_rows
    assert float((ngal[keep] / ngal_p[keep] - 1).abs().max()) <= 1e-6
    assert float((ds[keep] / ds_p[keep] - 1).abs().max()) <= 1e-6
