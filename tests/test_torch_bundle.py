"""The bundle predictor's plain version against tabcorr_tpu's Pallas bundle.

Both packages get the same float32 parameter vectors (numpy, seeded).  The
JAX bundle runs as its own tests run it on the CPU (interpret mode, small
batch tile).  Contracts, as bench.py reports them: wp per-element relative
error <= 1e-6, xi_ell and Delta Sigma <= 1e-6 of the statistic's largest
element ('scaled'), ngal <= 1e-6 relative -- each package against the
float64 host path at the float32 parameter values, and the two packages
against each other.  The CUDA kernel itself is held against this plain
version in test_torch_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.ops.fused import make_fused_bundle_predictor
from tabcorr_tpu.predictor import occupation_functions
from tabcorr_tpu_torch.ops import fused

from conftest import DATA_DIR

FILES = {"wp": "bolplanck_wp", "xi": "synthetic_xi_ell", "ds": "bolplanck_ds"}
NAMES = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")


@pytest.fixture(scope="module")
def tabs():
    return {k: (tt.TabCorr.read(DATA_DIR / "examples" / f"{f}.hdf5"),
                ttt.TabCorr.read(DATA_DIR / "examples" / f"{f}.hdf5"))
            for k, f in FILES.items()}


def _params(box, batch, seed=0):
    """float32 parameters: bench.py's distribution around the threshold
    -18 defaults, or the wide box of test_torch_models.py."""
    rng = np.random.default_rng(seed)
    if box == "bench":
        p = {"logMmin": 11.35 + 0.1 * rng.normal(size=batch),
             "sigma_logM": 0.25 + 0.01 * rng.normal(size=batch),
             "logM0": 11.2 + 0.1 * rng.normal(size=batch),
             "logM1": 12.4 + 0.1 * rng.normal(size=batch),
             "alpha": 0.83 + 0.02 * rng.normal(size=batch)}
    else:
        p = {"logMmin": rng.uniform(10.5, 13.5, batch),
             "sigma_logM": rng.uniform(0.1, 1.0, batch),
             "logM0": 11.2 + rng.uniform(-1.0, 1.0, batch),
             "logM1": 12.4 + rng.uniform(-1.0, 1.0, batch),
             "alpha": rng.uniform(0.5, 1.5, batch)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _error(stat, got, want):
    """The statistic's contract metric: per-element relative for wp,
    scaled by the largest element otherwise."""
    got, want = np.ravel(got), np.ravel(want)
    if stat == "wp":
        return float(np.max(np.abs(got - want) / np.abs(want)))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("stats,box,batch", [
    (("wp", "xi"), "wide", 16),
    (("wp", "xi"), "bench", 13),
    (("ds",), "wide", 16),
    (("ds",), "bench", 13),
])
def test_plain_bundle_matches_jax_bundle_and_float64(tabs, stats, box, batch):
    accuracy = tuple("elementwise" if s == "wp" else "scaled" for s in stats)
    redshift = float(tabs[stats[0]][0].attrs["redshift"])
    params = _params(box, batch)

    jax_model = tt.Zheng07Model(threshold=-18, redshift=redshift)
    jax_fn = make_fused_bundle_predictor(
        [tabs[s][0].table_data(n_gauss=10, dtype=jnp.float32) for s in stats],
        *occupation_functions(jax_model), NAMES, batch_tile=8,
        interpret=True, accuracy=accuracy)
    jax_out = jax_fn({k: jnp.asarray(v) for k, v in params.items()})

    model = ttt.Zheng07Model(threshold=-18, redshift=redshift)
    port_fn = ttt.make_multi_predictor([tabs[s][1] for s in stats], model,
                                       device="cpu", accuracy=accuracy)
    port_out = port_fn({k: torch.tensor(v) for k, v in params.items()})

    for s, (ng_j, xi_j), (ng_p, xi_p) in zip(stats, jax_out, port_out):
        assert ng_p.shape == (batch,) and ng_p.dtype == torch.float32
        assert xi_p.shape == (batch,) + tabs[s][1].tpcf_shape
        for i in range(batch):
            host = ttt.Zheng07Model(threshold=-18, redshift=redshift)
            for k in NAMES:
                host.param_dict[k] = float(params[k][i])
            ng64, xi64 = tabs[s][1].predict(host, check_consistency=False)
            port_xi = xi_p[i].double().numpy()
            jax_xi = np.asarray(xi_j[i], np.float64)
            assert _error(s, port_xi, xi64) <= 1e-6, (s, i)
            assert _error(s, jax_xi, xi64) <= 1e-6, (s, i)
            assert _error(s, port_xi, jax_xi) <= 1e-6, (s, i)
            assert abs(float(ng_p[i]) / ng64 - 1) <= 1e-6, (s, i)
            assert abs(float(ng_j[i]) / float(ng_p[i]) - 1) <= 1e-6, (s, i)


def _wp_xi_predictor(tabs, engine="bundle"):
    model = ttt.Zheng07Model(threshold=-18,
                             redshift=tabs["wp"][1].attrs["redshift"])
    return model, ttt.make_multi_predictor(
        [tabs["wp"][1], tabs["xi"][1]], model, device="cpu", engine=engine)


def test_cpu_tensors_take_the_plain_version_without_a_launch(tabs):
    model, predict = _wp_xi_predictor(tabs)
    params = {k: torch.tensor(v) for k, v in _params("bench", 9).items()}
    before = fused.BUNDLE_LAUNCHES
    got = predict(params)
    assert fused.BUNDLE_LAUNCHES == before
    _, plain = _wp_xi_predictor(tabs, engine="plain")
    for (a, b), (c, d) in zip(got, plain(params)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
        torch.testing.assert_close(b, d, rtol=0, atol=0)


def test_plain_version_is_independent_of_the_chunk(tabs, monkeypatch):
    model, _ = _wp_xi_predictor(tabs)
    consts = [fused.bundle_table_constants(
        tabs[s][1].table_data(device="cpu")) for s in ("wp", "xi")]
    occ = ttt.occupation_functions(model)
    params = {k: torch.tensor(v) for k, v in _params("wide", 11).items()}
    whole = fused.bundle_predict_plain(consts, params, *occ)
    monkeypatch.setattr(fused, "_PLAIN_CHUNK", 4)
    chunked = fused.bundle_predict_plain(consts, params, *occ)
    for (a, b), (c, d) in zip(whole, chunked):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=0)
        torch.testing.assert_close(b, d, rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))


def test_kernel_wrapper_never_falls_back_to_the_cpu(tabs):
    consts = [fused.bundle_table_constants(
        tabs["wp"][1].table_data(device="cpu"))]
    with pytest.raises(ValueError, match="CUDA"):
        fused.bundle_launch(consts, torch.ones((4, 5)))


def test_multi_predictor_validates_its_arguments(tabs):
    model = ttt.Zheng07Model(threshold=-18)
    objs = [tabs["wp"][1], tabs["xi"][1]]
    with pytest.raises(ValueError):
        ttt.make_multi_predictor(objs, model, device="cpu",
                                 accuracy=("elementwise",))
    with pytest.raises(ValueError):
        ttt.make_multi_predictor(objs, model, device="cpu",
                                 accuracy=("elementwise", "loose"))
    with pytest.raises(ValueError):
        ttt.make_multi_predictor(objs, model, device="cpu", engine="xla")
    with pytest.raises(ValueError):
        ttt.make_multi_predictor(objs, model, device=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ttt.make_multi_predictor(objs, model, device="cuda")


@pytest.mark.parametrize("stat", ["wp", "ds"])
def test_float64_tensor_predictor_matches_host(tabs, stat):
    tab = tabs[stat][1]
    model = ttt.Zheng07Model(threshold=-18, redshift=tab.attrs["redshift"])
    predict = ttt.make_predictor(tab, model, dtype=torch.float64,
                                 device="cpu")
    params = _params("bench", 5, seed=4)
    ngal, xi = predict({k: torch.tensor(v, dtype=torch.float64)
                        for k, v in params.items()})
    assert xi.shape == (5,) + tab.tpcf_shape
    for i in range(5):
        for k in NAMES:
            model.param_dict[k] = float(params[k][i])
        ng64, xi64 = tab.predict(model)
        assert abs(float(ngal[i]) / ng64 - 1) <= 1e-12
        np.testing.assert_allclose(xi[i].numpy(), xi64, rtol=1e-11)
