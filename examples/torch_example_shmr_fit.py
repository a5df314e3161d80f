"""Gradient-based SHMR inference with the Leauthaud11 model and the
PyTorch port (counterpart of examples/example_shmr_fit.py).

The port's SHMR inversion differentiates under autograd, so the chain
SHMR parameters -> occupations -> wp is exactly differentiable and NUTS
(mass-matrix warmup on) recovers (smhm_m1_0, smhm_beta_0,
scatter_model_param1) from synthetic wp data (5% errors) on the plain
float64 engine.

    python examples/torch_example_shmr_fit.py --device cuda
"""

import argparse
from pathlib import Path

import numpy as np
import torch

import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch import mcmc

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"
SAMPLED = ("smhm_m1_0", "smhm_beta_0", "scatter_model_param1")
BOUNDS = {"smhm_m1_0": (11.5, 13.5), "smhm_beta_0": (0.1, 1.0),
          "scatter_model_param1": (0.05, 0.6)}


def run(device="cuda", n_chains=4, n_warmup=200, n_steps=400, max_depth=6,
        seed=42):
    """Synthetic data at the fiducial parameters (numpy ``seed``), then
    multi-chain NUTS from 2% around the truth.  Returns the samples
    (n_steps * n_chains, 3), the truth, the mean tree depth, the step
    size and the effective sample size per dimension."""
    halotab = ttt.TabCorr.read(DATA / "bolplanck_wp.npz")
    model = ttt.Leauthaud11Model(threshold=10.5,
                                 redshift=halotab.attrs["redshift"])
    predict = ttt.make_predictor(halotab, model, dtype=torch.float64,
                                 vectorized=False, engine="plain",
                                 device=device)
    base = dict(model.param_dict)
    ngal0, wp0 = predict(base)
    rng = np.random.default_rng(seed)
    wp0 = wp0.cpu().numpy()
    sigma = 0.05 * np.abs(wp0)
    data = wp0 + sigma * rng.normal(size=wp0.shape)
    log_prob = mcmc.make_gaussian_logpost(
        predict, SAMPLED, base, data, np.diag(1.0 / sigma ** 2),
        bounds=BOUNDS, ngal_data=float(ngal0),
        ngal_sigma=0.05 * float(ngal0), device=device)

    theta0 = torch.tensor([base[k] for k in SAMPLED], dtype=torch.float64,
                          device=device)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    start = theta0 + 0.02 * torch.randn(
        (n_chains, len(SAMPLED)), generator=generator, dtype=torch.float64,
        device=device)
    chain, _, depth, step = mcmc.run_nuts(
        generator, torch.vmap(log_prob), start, n_warmup, n_steps,
        max_depth=max_depth, adapt_mass_matrix=True)
    chain = chain.cpu()
    return dict(samples=chain.reshape(-1, len(SAMPLED)).numpy(),
                truth=dict(zip(SAMPLED, theta0.tolist())),
                mean_depth=float(torch.as_tensor(depth).double().mean()),
                step_size=float(step),
                ess=np.asarray(mcmc.effective_sample_size(chain)))


def plot(results, path="."):
    """shmr_posterior.png (marginal histograms) in the directory
    ``path``."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(SAMPLED), figsize=(9, 3))
    for i, (ax, name) in enumerate(zip(axes, SAMPLED)):
        ax.hist(results["samples"][:, i], bins=40, histtype="step")
        ax.axvline(results["truth"][name], color="k", ls="--")
        ax.set_xlabel(name)
    fig.tight_layout(pad=0.3)
    fig.savefig(Path(path) / "shmr_posterior.png", dpi=200)
    plt.close(fig)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    results = run(device=args.device)
    print(f"NUTS: mean tree depth {results['mean_depth']:.1f}, "
          f"step size {results['step_size']:.3g}")
    for i, name in enumerate(SAMPLED):
        lo, mid, hi = np.percentile(results["samples"][:, i], [16, 50, 84])
        print(f"  {name:22s} truth {results['truth'][name]:7.3f}   "
              f"posterior {mid:7.3f} +{hi - mid:.3f} -{mid - lo:.3f}")
    print("effective sample size per dim:", np.round(results["ess"], 0))
    plot(results)
    print("wrote shmr_posterior.png")
