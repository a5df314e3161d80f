"""MCMC with the PyTorch port: fit zheng07 wp(rp) data (counterpart of
examples/example_mcmc.py).

Generates wp data at known HOD parameters (3% errors), then samples the
(logMmin, logM1, alpha) posterior with the stretch-move ensemble sampler.
The route follows ``device``: on the card every half-ensemble's
likelihood is one launch of the bundle kernel
(``make_multi_predictor``); on the CPU the plain float32 engine, walker
by walker under ``torch.vmap``.

    python examples/torch_example_mcmc.py --device cuda
"""

import argparse
from pathlib import Path

import numpy as np
import torch

import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch.utils.device import resolve_device

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"
NAMES = ("logMmin", "logM1", "alpha")
TRUTH = {"logMmin": 11.45, "logM1": 12.5, "alpha": 0.9}
BOUNDS = {"logMmin": (10.5, 12.5), "logM1": (11.5, 13.5),
          "alpha": (0.3, 1.6)}


def run(device="cuda", n_walkers=256, n_steps=500, burn=200, seed=0):
    """Mock data (numpy ``seed``), then ``n_steps`` ensemble steps of
    ``n_walkers`` walkers (torch generator seeded ``seed + 1``).  Returns
    the post-burn-in samples (n, 3), the acceptance fraction, the truth
    and the route taken."""
    device = resolve_device(device)
    halotab = ttt.TabCorr.read(DATA / "bolplanck_wp.npz")
    model = ttt.Zheng07Model(threshold=-18,
                             redshift=halotab.attrs["redshift"])
    model.param_dict.update(TRUTH)
    ngal_true, wp_true = halotab.predict(model)
    sigma = 0.03 * np.abs(wp_true)
    inv_cov = np.diag(1.0 / sigma ** 2)
    rng = np.random.default_rng(seed)
    wp_data = wp_true + sigma * rng.normal(size=len(wp_true))

    base = {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in model.param_dict.items()}
    walkers0 = torch.tensor(
        np.array([TRUTH[k] for k in NAMES])[None] +
        0.05 * rng.normal(size=(n_walkers, len(NAMES))),
        dtype=torch.float32, device=device)
    # A number-density constraint breaks the logMmin-logM1 degeneracy.
    density = dict(ngal_data=ngal_true, ngal_sigma=0.02 * ngal_true,
                   bounds=BOUNDS)
    if device.type == "cuda":
        route = "bundle"
        predict_all = ttt.make_multi_predictor([halotab], model,
                                               device=device)
        log_prob = ttt.make_gaussian_logpost_batched(
            predict_all, NAMES, base, [wp_data], [inv_cov], device=device,
            **density)
    else:
        route = "plain"
        predict_one = ttt.make_predictor(halotab, model, vectorized=False,
                                         engine="plain", device=device)
        log_prob = ttt.make_gaussian_logpost(
            predict_one, NAMES, base, wp_data, inv_cov, device=device,
            **density)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    chain, _, accept = ttt.run_ensemble(generator, log_prob, walkers0,
                                        n_steps,
                                        vectorized=route == "bundle")
    samples = chain[burn:].reshape(-1, len(NAMES)).double().cpu().numpy()
    return dict(samples=samples, accept=float(accept), truth=dict(TRUTH),
                names=NAMES, route=route)


def plot(results, path="."):
    """mcmc_posterior.png (marginal histograms) in the directory
    ``path``."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(NAMES), figsize=(9, 3))
    for i, (ax, name) in enumerate(zip(axes, NAMES)):
        ax.hist(results["samples"][:, i], bins=40, histtype="step")
        ax.axvline(results["truth"][name], color="k", ls="--")
        ax.set_xlabel(name)
    fig.tight_layout(pad=0.3)
    fig.savefig(Path(path) / "mcmc_posterior.png", dpi=200)
    plt.close(fig)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    results = run(device=args.device)
    print(f"acceptance fraction: {results['accept']:.2f} "
          f"({results['route']} route)")
    for i, name in enumerate(NAMES):
        s = results["samples"][:, i]
        print(f"{name}: {s.mean():.3f} +- {s.std():.3f}   "
              f"(truth {TRUTH[name]})")
    plot(results)
    print("wrote mcmc_posterior.png")
