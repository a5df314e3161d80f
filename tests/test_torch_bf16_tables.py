"""The bfloat16 layer of the port against tabcorr_tpu's: tables, spline
constants and the rounding from float64 bit for bit; the bfloat16
contraction's constants and plain version against numpy float64 of the
same bfloat16 inputs (one bfloat16 ulp); the routing of engine='auto';
and the defect of tabcorr_tpu's own fused bfloat16 route, which is why
the route tests hold the port to tabcorr_tpu's XLA engine instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.predictor import make_predictor as jax_make_predictor
from tabcorr_tpu_torch import predictor
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.ops.predict import TableData
from tabcorr_tpu_torch.utils.device import host_tensor

from conftest import DATA_DIR

FIXTURES = ["examples/bolplanck_wp.hdf5", "examples/bolplanck_ds.hdf5",
            "examples/synthetic_xi_ell.hdf5", "regression/synthetic_wp.hdf5"]
FIELDS = ("tpcf_dense", "n_h", "log_prim_quad", "quad_weight", "sec_perc",
          "log_prim_quad_lo")
INTERPOLATORS = [
    "examples/synthetic_xi_ell_interp.hdf5",
    "AbacusSummit/base_c000_ph000/0p50/ds_efficient.hdf5"]


def _bits(x):
    """bfloat16 values as their 16-bit patterns (numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_host_rounding_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(size=200_000) * 10.0 ** rng.uniform(-30, 30, 200_000)
    x[:4] = (0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -9)  # ties
    np.testing.assert_array_equal(
        _bits(host_tensor(x, torch.bfloat16)),
        _bits(jnp.asarray(x, dtype=jnp.bfloat16)))
    with pytest.raises(ValueError, match="bfloat16, float32 or float64"):
        host_tensor(x, torch.float16)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_table_data_equals_jax_bit_for_bit(fixture):
    ref = tt.TabCorr.read(DATA_DIR / fixture).table_data(
        n_gauss=10, dtype=jnp.bfloat16)
    got = ttt.TabCorr.read(DATA_DIR / fixture).table_data(
        n_gauss=10, dtype=torch.bfloat16, device="cpu")
    for field in FIELDS:
        have, want = getattr(got, field), getattr(ref, field)
        assert have.dtype == torch.bfloat16, field
        assert have.shape == want.shape, field
        np.testing.assert_array_equal(_bits(have), _bits(want),
                                      err_msg=field)
    assert (got.mode, got.tpcf_shape, got.n_centrals) == (
        ref.mode, tuple(int(s) for s in ref.tpcf_shape), ref.n_centrals)


def test_from_numpy_takes_bfloat16():
    ref = tt.TabCorr.read(DATA_DIR / FIXTURES[0]).table_data(
        n_gauss=10, dtype=jnp.float32)
    arrays = {f: np.array(getattr(ref, f), np.float64) for f in FIELDS}
    got = TableData.from_numpy(arrays, ref.mode, ref.tpcf_shape,
                               ref.n_centrals, device="cpu",
                               dtype=torch.bfloat16)
    for field in FIELDS:
        np.testing.assert_array_equal(
            _bits(getattr(got, field)),
            _bits(jnp.asarray(arrays[field], dtype=jnp.bfloat16)))


@pytest.mark.parametrize("fixture", INTERPOLATORS)
def test_spline_constants_equal_jax_bit_for_bit(fixture):
    ref = tt.Interpolator.read(DATA_DIR / fixture)
    keys, xp, a = predictor._spline_constants(
        ttt.Interpolator.read(DATA_DIR / fixture), torch.bfloat16, "cpu")
    assert list(keys) == list(ref.keys)
    for have, want in zip(xp + a, list(ref.xp) + list(ref.a)):
        np.testing.assert_array_equal(
            _bits(have), _bits(jnp.asarray(want, dtype=jnp.bfloat16)))


def _ulp(x):
    """One bfloat16 ulp at |x| (float64 x): 2^(e - 7) for x in [2^e,
    2^(e+1))."""
    return np.exp2(np.floor(np.log2(np.abs(x))) - 7)


@pytest.mark.parametrize("fixture", FIXTURES[:3])
def test_contraction_plain_within_one_ulp_of_float64(fixture):
    table = ttt.TabCorr.read(DATA_DIR / fixture).table_data(
        n_gauss=10, dtype=torch.bfloat16, device="cpu")
    c = fused.bf16_table_constants(table)
    nb = table.n_bins
    assert c.kp % 16 == 0 and c.kp >= nb
    assert c.bt.dtype == torch.bfloat16 and c.bt.shape[1] == c.kp
    rng = np.random.default_rng(1)
    ngal = host_tensor(rng.uniform(0.0, 1.0, (37, nb)) *
                       np.exp(-np.arange(nb) / 20.0), torch.bfloat16)
    total, xi = fused.contraction_bf16_plain(c, ngal)
    assert total.dtype == xi.dtype == torch.bfloat16
    n = ngal.double().numpy()
    f = table.tpcf_dense.double().numpy()
    tot = n.sum(-1)
    if table.mode == "auto":
        assert c.bt.shape[0] == f.shape[0] * c.ni and c.ni % 8 == 0
        want = np.einsum("kij,bi,bj->bk", f, n, n) / tot[:, None] ** 2
    else:
        assert c.bt.shape[0] % 8 == 0
        want = np.einsum("kj,bj->bk", f, n) / tot[:, None]
    for have, ref in ((total, tot), (xi, want)):
        have = have.double().numpy()
        assert np.all(np.abs(have - ref) <= _ulp(ref))


def test_bf16_constants_refuse_float32_tables():
    table = ttt.TabCorr.read(DATA_DIR / FIXTURES[0]).table_data(
        n_gauss=10, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="bfloat16 tables"):
        fused.bf16_table_constants(table)
    c = fused.bf16_table_constants(
        ttt.TabCorr.read(DATA_DIR / FIXTURES[0]).table_data(
            n_gauss=10, dtype=torch.bfloat16, device="cpu"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.contraction_bf16_launch(c, torch.zeros((2, c.n_bins),
                                                     dtype=torch.bfloat16))


def test_kernel_takes_every_shape_of_the_bf16_route():
    # bolplanck wp, synthetic xi_ell, ds 'efficient' (cross, 4 nodes), the
    # 64-node grid and the wide grid (stacked rows).
    for n_bins, rows in ((60, 19), (120, 42), (1104, 52), (60, 2688),
                         (160, 2688), (121, 1)):
        assert fused.contraction_bf16_takes(n_bins, rows)
    assert not fused.contraction_bf16_takes(4000, 1)


def test_auto_picks_plain_on_the_cpu_and_fused_for_cuda():
    tab = ttt.TabCorr.read(DATA_DIR / FIXTURES[0])
    interp = ttt.Interpolator.read(DATA_DIR / INTERPOLATORS[1])
    model = ttt.Zheng07Model(threshold=-21)
    for obj in (tab, interp):
        for device, want in ((torch.device("cpu"), "plain"),
                             (torch.device("cuda"), "fused")):
            assert predictor._auto_engine(
                obj, model, torch.bfloat16, False, device) == want
        # Neither separate_gal_type nor vectorized=False take a kernel.
        assert predictor._auto_engine(
            obj, model, torch.bfloat16, True, torch.device("cuda")) == "plain"
        assert predictor._auto_engine(
            obj, model, torch.bfloat16, False, torch.device("cuda"),
            vectorized=False) == "plain"
    # make_multi_predictor(dtype=bfloat16) resolves to its members, as
    # tabcorr_tpu's 'xla' composition does; the bundle stays float32.
    assert predictor.multi_engine_for([tab], model, torch.bfloat16,
                                      torch.device("cuda")) == "members"
    with pytest.raises(ValueError, match="float32"):
        ttt.make_multi_predictor([tab], model, dtype=torch.bfloat16,
                                 device="cpu", engine="bundle")


def test_jax_fused_bf16_route_fails_its_store_dtype_check():
    """tabcorr_tpu's fused bfloat16 route stores float32 values into its
    kernel's bfloat16 output refs (``tabcorr_tpu/ops/fused.py:186-197``),
    which Pallas refuses at trace time; so the port's fused bfloat16 route
    is held to tabcorr_tpu's XLA engine in bfloat16 fed the same bfloat16
    parameters (test_torch_bf16_routes.py)."""
    tab = tt.TabCorr.read(DATA_DIR / FIXTURES[0])
    model = tt.Zheng07Model(threshold=-20)
    f = jax_make_predictor(tab, model, dtype=jnp.bfloat16, engine="fused")
    params = {k: jnp.full((8,), v, dtype=jnp.bfloat16)
              for k, v in model.param_dict.items()}
    with pytest.raises(ValueError, match="Invalid dtype"):
        f(params)
