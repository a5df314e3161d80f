"""The port's sampler examples (examples/torch_example_{mcmc,shmr_fit}.py)
at reduced sizes on the CPU: their results are stochastic, so the
posterior means must fall within 3 sigma (the samples' own spread) of the
truth the example uses, and the acceptance rate (ensemble) or step size
(NUTS) must be finite and nonzero.  The mcmc example's route follows its
``device``: the plain engine here, the bundle kernel on the card (run
there by chip_smoke.py); no example falls back to the CPU without a card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).absolute().parents[1] / "examples"))

import torch_example_mcmc  # noqa: E402
import torch_example_shmr_fit  # noqa: E402


@pytest.fixture(autouse=True)
def agg_backend(monkeypatch):
    monkeypatch.setenv("MPLBACKEND", "Agg")


def _within_3_sigma(samples, truth, names):
    mean, std = samples.mean(0), samples.std(0)
    for i, name in enumerate(names):
        assert std[i] > 0
        assert abs(mean[i] - truth[name]) <= 3.0 * std[i], name


def test_mcmc_example(tmp_path):
    got = torch_example_mcmc.run(device="cpu", n_walkers=32, n_steps=80,
                                 burn=30)
    assert got["route"] == "plain"
    assert got["samples"].shape == (50 * 32, 3)
    assert np.isfinite(got["accept"]) and 0.0 < got["accept"] <= 1.0
    _within_3_sigma(got["samples"], got["truth"], got["names"])
    torch_example_mcmc.plot(got, tmp_path)
    assert (tmp_path / "mcmc_posterior.png").exists()


def test_shmr_fit_example(tmp_path):
    got = torch_example_shmr_fit.run(device="cpu", n_chains=2, n_warmup=8,
                                     n_steps=10, max_depth=3)
    assert got["samples"].shape == (20, 3)
    assert np.isfinite(got["step_size"]) and got["step_size"] > 0.0
    _within_3_sigma(got["samples"], got["truth"],
                    torch_example_shmr_fit.SAMPLED)
    torch_example_shmr_fit.plot(got, tmp_path)
    assert (tmp_path / "shmr_posterior.png").exists()


def test_examples_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for run in (torch_example_mcmc.run, torch_example_shmr_fit.run):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(device="cuda")
