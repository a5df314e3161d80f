"""The port's deterministic examples (examples/torch_example_{wp,ds,
fisher,nonparametric,multichip}.py) run through ``run(device="cpu",
...)`` at reduced sizes (the multi-GPU example in a world of 2 gloo ranks) and held against the same quantities computed here with
tabcorr_tpu's functions at the same inputs (the JAX example scripts plot
and run at import, so they are not run); each ``plot`` draws into
``tmp_path``.  test_torch_examples_samplers.py holds the two samplers'
examples.

Tolerances: float64 results 1e-8 relative; the wp example's batch runs
float32 on both sides and is held at 2e-6 scaled, the float32 bar of the
port's other engine tests.  The non-parametric fit runs optax's
``adam(3e-2)`` as ``torch.optim.Adam`` with the same settings, the same
update: after 50 iterations in float64 its -log posterior matches the
optax loop's to 1e-8 relative at every step.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tabcorr_tpu as tt
from tabcorr_tpu.models import smoothness_log_prior
from tabcorr_tpu.predictor import (make_occupation_predictor,
                                   make_predictor, params_batch)

from conftest import DATA_DIR

sys.path.insert(0, str(Path(__file__).absolute().parents[1] / "examples"))

import torch_example_ds  # noqa: E402
import torch_example_fisher  # noqa: E402
import torch_example_multichip  # noqa: E402
import torch_example_nonparametric  # noqa: E402
import torch_example_wp  # noqa: E402

WP = DATA_DIR / "examples" / "bolplanck_wp.hdf5"
DS = DATA_DIR / "examples" / "bolplanck_ds.hdf5"


@pytest.fixture(autouse=True)
def agg_backend(monkeypatch):
    monkeypatch.setenv("MPLBACKEND", "Agg")


def _close(got, want, rtol=1e-8):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0.0)


def test_wp_example(tmp_path):
    got = torch_example_wp.run(device="cpu", n_models=40)
    halotab = tt.TabCorr.read(WP)
    model = tt.Zheng07Model(
        threshold=-18, redshift=halotab.attrs["redshift"],
        prim_haloprop_key=halotab.attrs["prim_haloprop_key"])
    ngal, wp = halotab.predict(model)
    _, wp_sep = halotab.predict(model, separate_gal_type=True)
    _close(got["ngal"], ngal)
    _close(got["wp"], wp)
    assert set(got["wp_sep"]) == set(wp_sep)
    for key in wp_sep:
        _close(got["wp_sep"][key], wp_sep[key])
    logm1 = np.linspace(12.0, 12.8, 40)
    _, wp_batch = make_predictor(halotab, model)(
        params_batch(model, {"logM1": logm1}, (40,)))
    want = np.asarray(wp_batch, np.float64)
    assert got["wp_batch"].dtype == np.float32
    err = np.max(np.abs(got["wp_batch"] - want), axis=1) / np.max(
        np.abs(want), axis=1)
    assert np.max(err) <= 2e-6
    torch_example_wp.plot(got, tmp_path)
    assert (tmp_path / "wp_decomposition.png").exists()
    assert (tmp_path / "wp_vs_logm1.png").exists()


def test_ds_example(tmp_path):
    got = torch_example_ds.run(device="cpu")
    halotab = tt.TabCorr.read(DS)
    model = tt.Zheng07Model(
        threshold=-21, redshift=halotab.attrs["redshift"],
        prim_haloprop_key=halotab.attrs["prim_haloprop_key"])
    ngal, ds = halotab.predict(model)
    _, ds_sep = halotab.predict(model, separate_gal_type=True)
    _close(got["ngal"], ngal)
    _close(got["ds"], ds)
    assert set(got["ds_sep"]) == set(ds_sep)
    for key in ds_sep:
        _close(got["ds_sep"][key], ds_sep[key])
    torch_example_ds.plot(got, tmp_path)
    assert (tmp_path / "ds_decomposition.png").exists()


def test_fisher_example(tmp_path):
    got = torch_example_fisher.run(device="cpu")
    halotab = tt.TabCorr.read(WP)
    model = tt.Zheng07Model(threshold=-18,
                            redshift=halotab.attrs["redshift"])
    names = tuple(model.param_dict)
    theta0 = jnp.asarray([model.param_dict[k] for k in names], jnp.float64)
    predict = make_predictor(halotab, model, dtype=jnp.float64,
                             vectorized=False, engine="xla")

    def observables(theta):
        return predict(dict(zip(names, theta)))

    ngal0, wp0 = observables(theta0)
    jac_wp = jax.jacfwd(lambda t: observables(t)[1])(theta0)
    jac_ngal = jax.jacfwd(lambda t: observables(t)[0])(theta0)
    fisher = (jac_wp.T @ jnp.diag(1.0 / (0.05 * wp0) ** 2) @ jac_wp +
              jnp.outer(jac_ngal, jac_ngal) / (0.03 * ngal0) ** 2)
    cov = jnp.linalg.inv(fisher)
    sigma = jnp.sqrt(jnp.diag(cov))
    assert got["names"] == names
    _close(got["fisher"].numpy(), fisher)
    _close(got["sigma"].numpy(), sigma)
    _close(got["corr"].numpy(), cov / jnp.outer(sigma, sigma))
    assert np.all(got["sigma"].numpy() > 0)
    torch_example_fisher.plot(got, tmp_path)
    assert (tmp_path / "fisher_correlation.png").exists()


def _optax_losses(n_iter):
    """The JAX example's Adam loop (examples/example_nonparametric.py) for
    ``n_iter`` steps: the -log posterior before each update."""
    halotab = tt.TabCorr.read(WP)
    truth = tt.Zheng07Model(threshold=-18,
                            redshift=halotab.attrs["redshift"])
    _, wp_true = halotab.predict(truth)
    rng = np.random.default_rng(42)
    sigma = 0.03 * np.abs(wp_true)
    wp_data = wp_true + sigma * rng.normal(size=wp_true.shape)
    n_cen = halotab.n_centrals
    f = make_occupation_predictor(halotab, dtype=jnp.float64, jit=False)
    data = jnp.asarray(wp_data.ravel())
    ivar = jnp.asarray(1.0 / sigma.ravel() ** 2)

    def neg_log_post(log_occ):
        occ = 10.0 ** log_occ
        _, wp = f(occ)
        chi2 = jnp.sum((wp.ravel() - data) ** 2 * ivar)
        return -(-0.5 * chi2 + smoothness_log_prior(occ[:n_cen], scale=0.35)
                 + smoothness_log_prior(occ[n_cen:], scale=0.35))

    x = jnp.asarray(np.full(halotab.n_bins, -1.5))
    opt = optax.adam(3e-2)
    state = opt.init(x)

    @jax.jit
    def step(x, s):
        lp, g = jax.value_and_grad(neg_log_post)(x)
        updates, s = opt.update(g, s)
        return optax.apply_updates(x, updates), s, lp

    losses = []
    for _ in range(n_iter):
        x, state, nlp = step(x, state)
        losses.append(float(nlp))
    return losses, wp_data


def test_nonparametric_example(tmp_path):
    got = torch_example_nonparametric.run(device="cpu", n_iter=50)
    want, wp_data = _optax_losses(50)
    _close(got["wp_data"], wp_data, rtol=1e-12)
    assert got["n_cen"] == tt.TabCorr.read(WP).n_centrals
    _close(got["losses"], want)
    assert got["losses"][-1] < got["losses"][0]
    torch_example_nonparametric.plot(got, tmp_path)
    assert (tmp_path / "nonparametric_fit.png").exists()


def test_multichip_example():
    # Two gloo ranks: the dp-sharded bundle predictor (its plain version
    # on the CPU) and an ensemble whose log posterior gathers over dp.
    ranks = torch_example_multichip.run(device="cpu", n_ranks=2,
                                        batch_per_rank=8,
                                        walkers_per_rank=16, n_steps=5)
    first = ranks[0]
    assert len(ranks) == 2 and first["n_ranks"] == 2
    assert first["rows"] == 8 and first["launches"] == 0
    assert first["wp"].shape == (16, 19)
    # Every rank holds the same ensemble and the same gathered batch.
    for r in ranks[1:]:
        for key in ("walkers", "log_prob", "ngal", "wp"):
            np.testing.assert_array_equal(r[key], first[key])
        assert r["accept"] == first["accept"]
    assert np.all(np.isfinite(first["log_prob"]))
    assert 0.0 < first["accept"] <= 1.0
    halotab = tt.TabCorr.read(WP)
    model = tt.Zheng07Model(threshold=-18,
                            redshift=halotab.attrs["redshift"])
    f = make_predictor(halotab, model, dtype=jnp.float32, engine="xla")
    ngal, wp = f({k: jnp.asarray(v) for k, v in first["params"].items()})
    np.testing.assert_allclose(first["ngal"], np.asarray(ngal), rtol=2e-6)
    wp = np.asarray(wp, np.float64)
    assert np.max(np.abs(first["wp"] - wp)) <= 2e-6 * np.max(np.abs(wp))

