"""The port's stretch-move sampler and batched log posterior against
tabcorr_tpu.mcmc, fed the same inputs and the same random numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tabcorr_tpu import mcmc as jax_mcmc
from tabcorr_tpu_torch import mcmc

NAMES = ("logMmin", "logM1", "alpha")
BASE = {"logMmin": 11.35, "sigma_logM": 0.25, "logM0": 11.2, "logM1": 12.4,
        "alpha": 0.83}


def _linear_predictor(xp):
    """A two-statistic stand-in for the bundle predictor, identical in
    both frameworks: xi = theta @ A + c with theta the five parameters."""
    rng = np.random.default_rng(0)
    mats = [rng.normal(size=(5, 6)), rng.normal(size=(5, 4))]
    keys = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")

    def predict_all(params):
        theta = xp.stack([params[k] for k in keys], axis=-1)
        out = []
        for m in mats:
            m = xp.asarray(m, dtype=theta.dtype)
            out.append((theta.sum(-1), theta @ m + 1.0))
        return out

    return predict_all


def _posterior_inputs():
    rng = np.random.default_rng(1)
    data = [rng.normal(size=6) + 2.0, rng.normal(size=4) + 2.0]
    inv_cov = []
    for d in data:
        a = rng.normal(size=(d.size, d.size))
        inv_cov.append(a @ a.T / d.size + np.eye(d.size))
    theta = (np.array([BASE[k] for k in NAMES])[None, :] +
             0.05 * rng.normal(size=(32, len(NAMES)))).astype(np.float32)
    theta[3, 1] = 20.0                        # outside the logM1 bound
    return data, inv_cov, theta


def test_gaussian_logpost_batched_matches_jax():
    data, inv_cov, theta = _posterior_inputs()
    kwargs = dict(bounds={"logM1": (11.0, 14.0)}, ngal_data=30.0,
                  ngal_sigma=0.5)
    ref = jax_mcmc.make_gaussian_logpost_batched(
        _linear_predictor(jnp), NAMES, BASE, data, inv_cov, **kwargs)(
        jnp.asarray(theta))
    got = mcmc.make_gaussian_logpost_batched(
        _linear_predictor(torch), NAMES, BASE, data, inv_cov,
        device="cpu", **kwargs)(torch.tensor(theta))
    assert got.dtype == torch.float32 and got.shape == (32,)
    ref = np.asarray(ref, np.float64)
    got = got.double().numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    assert np.isinf(got[3])
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-6)


def test_float64_logpost_batched_keeps_the_data_in_float64():
    """float64 theta: data, residual and inverse covariance stay float64,
    as tabcorr_tpu's under x64 (1e-12), on data float32 cannot hold."""
    data, inv_cov, theta = _posterior_inputs()
    data = [d + 1e-9 * np.arange(d.size) for d in data]
    assert all(np.any(d.astype(np.float32) != d) for d in data)
    theta = theta.astype(np.float64)
    kwargs = dict(bounds={"logM1": (11.0, 14.0)}, ngal_data=30.0,
                  ngal_sigma=0.5)
    ref = np.asarray(jax_mcmc.make_gaussian_logpost_batched(
        _linear_predictor(jnp), NAMES, BASE, data, inv_cov, **kwargs)(
        jnp.asarray(theta)))
    got = mcmc.make_gaussian_logpost_batched(
        _linear_predictor(torch), NAMES, BASE, data, inv_cov,
        device="cpu", **kwargs)(torch.tensor(theta))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got.numpy()[finite], ref[finite], rtol=1e-12)
    # The float32 path rounds the data: the same theta in float32 reads
    # the chi^2 of the rounded data.
    got32 = mcmc.make_gaussian_logpost_batched(
        _linear_predictor(torch), NAMES, BASE, data, inv_cov,
        device="cpu", **kwargs)(torch.tensor(theta, dtype=torch.float32))
    assert got32.dtype == torch.float32


@pytest.mark.parametrize("target", ["wp", "grid"])
def test_gaussian_logpost_matches_jax(target):
    """The unvectorized log posterior over the plain float64 predictor,
    mapped by torch.vmap, against tabcorr_tpu's under jax.vmap (1e-12):
    the ngal term, the bounds, and -inf outside an Interpolator's grid."""
    import tabcorr_tpu as tt
    import tabcorr_tpu_torch as ttt
    from tabcorr_tpu.predictor import make_predictor as jax_make_predictor

    from conftest import DATA_DIR

    if target == "grid":
        path = (DATA_DIR / "AbacusSummit" / "base_c000_ph000" / "0p50" /
                "ds_efficient.hdf5")
        objs = (tt.Interpolator.read(path), ttt.Interpolator.read(path))
        kw = dict(threshold=-21, redshift=0.5,
                  prim_haloprop_key="halo_m258m")
        names = ("logM1", "log_eta")
    else:
        path = DATA_DIR / "examples" / "bolplanck_wp.hdf5"
        objs = (tt.TabCorr.read(path), ttt.TabCorr.read(path))
        kw = dict(threshold=-18,
                  redshift=float(objs[1].attrs["redshift"]))
        names = ("logMmin", "logM1")
    models = (tt.Zheng07Model(**kw), ttt.Zheng07Model(**kw))
    for m in models:
        m.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
    jax_one = jax_make_predictor(objs[0], models[0], dtype=jnp.float64,
                                 vectorized=False, jit=False, engine="xla")
    one = ttt.make_predictor(objs[1], models[1], dtype=torch.float64,
                             vectorized=False, device="cpu")
    ngal, xi = objs[1].predict(models[1])
    data = np.asarray(xi).ravel() * 1.03
    inv_cov = np.diag(1.0 / (0.05 * np.abs(data)) ** 2)
    kwargs = dict(bounds={"logM1": (12.0, 14.0)},
                  ngal_data=float(ngal) * 1.1,
                  ngal_sigma=float(ngal) * 0.2)
    jax_lp = jax_mcmc.make_gaussian_logpost(
        jax_one, names, {k: jnp.float64(v)
                         for k, v in models[0].param_dict.items()},
        data, inv_cov, **kwargs)
    lp = mcmc.make_gaussian_logpost(one, names, models[1].param_dict, data,
                                    inv_cov, device="cpu", **kwargs)
    rng = np.random.default_rng(5)
    theta = (np.array([models[1].param_dict[k] for k in names]) +
             0.03 * rng.normal(size=(6, 2)))
    theta[1, names.index("logM1")] = 11.5             # out of bounds
    if target == "grid":
        theta[4, 1] = 3.0                              # outside the grid
    want = np.asarray(jax.vmap(jax_lp)(jnp.asarray(theta)))
    got = torch.vmap(lp)(torch.tensor(theta))
    assert got.dtype == torch.float64 and got.shape == (6,)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    assert np.isneginf(got[1].item())
    assert np.isneginf(got[4].item()) == (target == "grid")
    finite = np.isfinite(want)
    assert finite.sum() >= 4
    np.testing.assert_allclose(got.numpy()[finite], want[finite],
                               rtol=1e-12)
    # One theta at a time, as the samplers' vmap sees it.
    np.testing.assert_allclose(lp(torch.tensor(theta[0])).item(), want[0],
                               rtol=1e-12)


def _gauss_torch(theta):
    mean = torch.tensor([1.0, -2.0], dtype=theta.dtype)
    sigma = torch.tensor([0.5, 2.0], dtype=theta.dtype)
    return -0.5 * torch.sum(((theta - mean) / sigma) ** 2, dim=-1)


def _gauss_jax(theta):
    mean = jnp.array([1.0, -2.0], dtype=theta.dtype)
    sigma = jnp.array([0.5, 2.0], dtype=theta.dtype)
    return -0.5 * jnp.sum(((theta - mean) / sigma) ** 2, axis=-1)


@pytest.mark.parametrize("vectorized", [True, False])
def test_stretch_half_matches_jax_with_shared_draws(monkeypatch, vectorized):
    rng = np.random.default_rng(2)
    active = rng.normal(size=(24, 2)).astype(np.float32)
    passive = rng.normal(size=(24, 2)).astype(np.float32)
    u = rng.uniform(size=24).astype(np.float32)
    picks = rng.integers(0, 24, size=24)
    u_accept = rng.uniform(size=24).astype(np.float32)
    uniforms = iter([u, u_accept])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(next(uniforms)))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(picks))

    lp_active = np.asarray(_gauss_jax(jnp.asarray(active)))
    ref = jax_mcmc._stretch_half(
        jax.random.key(0), jnp.asarray(active), jnp.asarray(passive),
        jnp.asarray(lp_active), _gauss_jax, 2.0, vectorized=vectorized)
    got = mcmc._stretch_half(
        (torch.tensor(u), torch.tensor(picks), torch.tensor(u_accept)),
        torch.tensor(active), torch.tensor(passive), torch.tensor(lp_active),
        _gauss_torch, 2.0, vectorized=vectorized)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert 0 < int(got[2].sum()) < 24
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-5, atol=1e-6)


def test_ensemble_samples_gaussian():
    generator = torch.Generator().manual_seed(0)
    walkers0 = torch.randn((64, 2), generator=generator)
    chain, lp, accept = mcmc.run_ensemble(generator, _gauss_torch, walkers0,
                                          n_steps=600, vectorized=True)
    assert chain.shape == (600, 64, 2) and lp.shape == (600, 64)
    assert 0.2 < float(accept) < 0.9
    samples = chain[200:].reshape(-1, 2).double().numpy()
    np.testing.assert_allclose(samples.mean(axis=0), [1.0, -2.0], atol=0.15)
    np.testing.assert_allclose(samples.std(axis=0), [0.5, 2.0], rtol=0.15)


def test_ensemble_step_keeps_log_prob_consistent():
    generator = torch.Generator().manual_seed(4)
    walkers = torch.randn((32, 2), generator=generator)
    lp = torch.vmap(_gauss_torch)(walkers)
    new, new_lp, accept = mcmc.ensemble_step(generator, walkers, lp,
                                             _gauss_torch)
    assert new.shape == walkers.shape
    assert 0.0 <= float(accept) <= 1.0
    torch.testing.assert_close(_gauss_torch(new), new_lp)


def test_run_ensemble_thins_and_is_reproducible():
    def run():
        generator = torch.Generator().manual_seed(5)
        walkers0 = torch.randn((16, 2), generator=generator)
        return mcmc.run_ensemble(generator, _gauss_torch, walkers0,
                                 n_steps=12, thin=3, vectorized=True)

    chain, lp, _ = run()
    again, _, _ = run()
    assert chain.shape == (4, 16, 2) and lp.shape == (4, 16)
    torch.testing.assert_close(chain, again, rtol=0, atol=0)


@pytest.mark.parametrize("start", [False, True])
def test_log_posterior_and_plain_engine_leave_the_tf32_flag(start):
    """Neither building nor calling the log posterior or the plain
    multi-statistic engine changes the process-wide TF32 flag: the chi^2
    and the plain contraction run in float64."""
    import tabcorr_tpu_torch as ttt
    from tabcorr_tpu_torch.utils.synthetic import synthetic_tabcorr

    flag = torch.backends.cuda.matmul
    before = flag.allow_tf32
    try:
        flag.allow_tf32 = start
        data, inv_cov, theta = _posterior_inputs()
        log_prob = mcmc.make_gaussian_logpost_batched(
            _linear_predictor(torch), NAMES, BASE, data, inv_cov,
            device="cpu")
        assert flag.allow_tf32 is start
        assert log_prob(torch.tensor(theta)).shape == (32,)
        assert flag.allow_tf32 is start
        tab = synthetic_tabcorr(np.random.default_rng(3), 6, 1, 4, "auto")
        model = ttt.Zheng07Model(threshold=-20)
        predict = ttt.make_multi_predictor([tab], model, device="cpu",
                                           engine="plain")
        assert flag.allow_tf32 is start
        params = ttt.params_batch(model, batch_shape=(3,), device="cpu")
        assert predict(params)[0][1].dtype == torch.float32
        assert flag.allow_tf32 is start
    finally:
        flag.allow_tf32 = before
