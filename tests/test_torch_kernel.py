"""The CUDA bundle kernel against its plain PyTorch version.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tabcorr_tpu_torch import (TabCorr, Zheng07Model, make_multi_predictor,
                               occupation_functions, params_batch)
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.ops.predict import TableData, quadrature_grid

pytestmark = pytest.mark.gpu

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _params(model, batch, seed, device):
    rng = np.random.default_rng(seed)
    return params_batch(model, {
        "logMmin": 11.35 + 0.3 * rng.normal(size=batch),
        "sigma_logM": 0.25 + 0.05 * rng.uniform(size=batch),
        "logM0": 11.2 + 0.3 * rng.normal(size=batch),
        "logM1": 12.4 + 0.3 * rng.normal(size=batch),
        "alpha": 0.83 + 0.1 * rng.normal(size=batch)}, (batch,),
        device=device)


def _assert_close(got, want, what):
    """ngal: 1e-6 relative; xi: 2e-6 of each row's largest element (the
    two differ in summation order and transcendental rounding only)."""
    for (ng, xi), (ng_p, xi_p) in zip(got, want):
        ng, ng_p = ng.double().cpu(), ng_p.double().cpu()
        assert float(((ng - ng_p).abs() / ng_p.abs()).max()) <= 1e-6, what
        xi = xi.double().cpu().reshape(xi.shape[0], -1)
        xi_p = xi_p.double().cpu().reshape(xi.shape[0], -1)
        scaled = (xi - xi_p).abs().amax(1) / xi_p.abs().amax(1)
        assert float(scaled.max()) <= 2e-6, what


@pytest.mark.parametrize("batch", [13, 4096 + 37])
def test_kernel_matches_plain_on_bench_tables(cuda, batch):
    wp = TabCorr.read(DATA / "bolplanck_wp.npz")
    xi = TabCorr.read(DATA / "synthetic_xi_ell.npz")
    model = Zheng07Model(threshold=-18, redshift=wp.attrs["redshift"])
    kernel = make_multi_predictor([wp, xi], model, device=cuda)
    plain = make_multi_predictor([wp, xi], model, device=cuda,
                                 engine="plain")
    params = _params(model, batch, 1, cuda)
    before = fused.BUNDLE_LAUNCHES
    got = kernel(params)
    torch.cuda.synchronize()
    assert fused.BUNDLE_LAUNCHES == before + 1
    assert got[0][1].shape == (batch, 19) and got[1][1].shape == (batch, 3, 14)
    _assert_close(got, plain(params), "bench tables")


def _synthetic_table(mode, n_bins, n_centrals, n_xi, seed, device):
    rng = np.random.default_rng(seed)
    log_min = np.linspace(10.8, 14.6, n_bins) + 0.01 * rng.normal(size=n_bins)
    log_quad, weight = quadrature_grid(log_min, log_min + 0.2,
                                       rng.uniform(-1.9, -1.5, n_bins), 10)
    hi64 = log_quad.astype(np.float32).astype(np.float64)
    if mode == "auto":
        a = rng.normal(size=(n_xi, n_bins, n_bins))
        dense = 3.0 + 0.5 * (a + np.swapaxes(a, 1, 2))
    else:
        dense = 3.0 + rng.normal(size=(n_xi, n_bins))
    return TableData.from_numpy(
        dict(tpcf_dense=dense, n_h=10.0 ** rng.uniform(-6, -2, n_bins),
             log_prim_quad=log_quad, quad_weight=weight,
             sec_perc=np.full(n_bins, 0.5),
             log_prim_quad_lo=log_quad - hi64),
        mode=mode, tpcf_shape=(n_xi,), n_centrals=n_centrals,
        device=device, dtype=torch.float32)


@pytest.mark.parametrize("modulate", [False, True])
def test_kernel_matches_plain_on_odd_shapes(cuda, modulate):
    # Odd bin counts (padding of every tile dimension), both modes in one
    # launch, a ragged batch, and zheng07's central modulation.
    tables = [_synthetic_table("auto", 37, 17, 5, 2, cuda),
              _synthetic_table("cross", 45, 20, 3, 3, cuda),
              _synthetic_table("auto", 130, 64, 11, 4, cuda)]
    model = Zheng07Model(threshold=-20, modulate_with_cenocc=modulate)
    consts = [fused.bundle_table_constants(t) for t in tables]
    occ = occupation_functions(model)
    predict = fused.make_fused_bundle_predictor(tables, model)
    params = _params(model, 77, 5, cuda)
    got = predict(params)
    want = fused.shaped(consts, fused.bundle_predict_plain(consts, params,
                                                           *occ))
    _assert_close(got, want, f"synthetic, modulate={modulate}")


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    table = _synthetic_table("auto", 37, 17, 5, 2, cuda)
    consts = [fused.bundle_table_constants(table)]
    pmat = torch.ones((8, 5), device=cuda)
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat.double())
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat.t().contiguous().t())
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat.cpu())
    with pytest.raises(ValueError):
        fused.bundle_launch(consts, pmat[:, :4].contiguous())
