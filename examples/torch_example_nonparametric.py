"""Non-parametric HOD inference with the PyTorch port: fit per-bin
occupations to wp(rp) (counterpart of examples/example_nonparametric.py).

The predicted statistic is an exact quadratic form in the occupation
vector, so the posterior (Gaussian wp data term plus a second-difference
smoothness prior on log occupations) differentiates exactly; Adam at
optax's ``adam(3e-2)`` settings (betas 0.9 and 0.999, eps 1e-8, the same
update) finds the MAP occupation function in float64.

    python examples/torch_example_nonparametric.py --device cuda
"""

import argparse
from pathlib import Path

import numpy as np
import torch

import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch.models import smoothness_log_prior
from tabcorr_tpu_torch.models.protocol import CENTRALS

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"


def run(device="cuda", n_iter=1500, seed=42):
    """Mock wp data of a zheng07 truth with 3% noise (numpy ``seed``),
    then ``n_iter`` Adam steps from log10 occupations of -1.5.  Returns
    the truth, the fit, the data and the -log posterior of every step."""
    halotab = ttt.TabCorr.read(DATA / "bolplanck_wp.npz")
    truth = ttt.Zheng07Model(threshold=-18,
                             redshift=halotab.attrs["redshift"])
    occ_truth = halotab.mean_occupation(truth)
    _, wp_true = halotab.predict(truth)
    rng = np.random.default_rng(seed)
    sigma = 0.03 * np.abs(wp_true)
    wp_data = wp_true + sigma * rng.normal(size=wp_true.shape)

    n_cen = len(ttt.NonparametricHodModel.from_table(
        halotab).occupation_vector(CENTRALS))
    f = ttt.make_occupation_predictor(halotab, dtype=torch.float64,
                                      device=device)
    data = torch.tensor(wp_data.ravel(), dtype=torch.float64, device=device)
    ivar = torch.tensor(1.0 / sigma.ravel() ** 2, dtype=torch.float64,
                        device=device)

    def neg_log_post(log_occ):
        occ = 10.0 ** log_occ
        _, wp = f(occ)
        chi2 = torch.sum((wp.reshape(-1) - data) ** 2 * ivar)
        return (0.5 * chi2 - smoothness_log_prior(occ[:n_cen], scale=0.35)
                - smoothness_log_prior(occ[n_cen:], scale=0.35))

    x = torch.full((halotab.n_bins,), -1.5, dtype=torch.float64,
                   device=device, requires_grad=True)
    opt = torch.optim.Adam([x], lr=3e-2, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(n_iter):
        opt.zero_grad()
        loss = neg_log_post(x)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        occ_fit = 10.0 ** x
        _, wp_fit = f(occ_fit)
    wp_fit = wp_fit.cpu().numpy().ravel()
    logm = 0.5 * (np.asarray(halotab.gal_type["log_prim_haloprop_min"]) +
                  np.asarray(halotab.gal_type["log_prim_haloprop_max"]))
    return dict(occ_truth=occ_truth, occ_fit=occ_fit.cpu().numpy(),
                n_cen=n_cen, logm=logm, wp_data=wp_data, sigma=sigma,
                wp_fit=wp_fit, losses=losses,
                rp=np.sqrt(halotab.tpcf_args[0][:-1] *
                           halotab.tpcf_args[0][1:]),
                chi2=float(np.sum((wp_fit - wp_data.ravel()) ** 2 /
                                  sigma.ravel() ** 2)))


def plot(results, path="."):
    """nonparametric_fit.png (occupations, wp) in the directory ``path``."""
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.5))
    n_cen, logm = results["n_cen"], results["logm"]
    for sl, label in ((slice(0, n_cen), "centrals"),
                      (slice(n_cen, None), "satellites")):
        order = np.argsort(logm[sl])
        ax1.plot(logm[sl][order], results["occ_truth"][sl][order], "-",
                 label=f"truth {label}")
        ax1.plot(logm[sl][order], results["occ_fit"][sl][order], "--",
                 label=f"fit {label}")
    ax1.set(xlabel=r"$\log_{10} M_{\rm vir}$",
            ylabel=r"$\langle N \rangle$", yscale="log", ylim=(1e-4, 50))
    ax1.legend(fontsize=7)
    ax2.errorbar(results["rp"], results["wp_data"], yerr=results["sigma"],
                 fmt="o", ms=3, label="mock data")
    ax2.plot(results["rp"], results["wp_fit"], label="non-parametric fit")
    ax2.set(xlabel=r"$r_p \ [h^{-1} \ \mathrm{Mpc}]$",
            ylabel=r"$w_p \ [h^{-1} \ \mathrm{Mpc}]$",
            xscale="log", yscale="log")
    ax2.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(Path(path) / "nonparametric_fit.png", dpi=150)
    plt.close(fig)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    results = run(device=args.device)
    for i in range(0, len(results["losses"]), 300):
        print(f"iter {i:5d}  -log post = {results['losses'][i]:.2f}")
    plot(results)
    print(f"final chi2 = {results['chi2']:.1f} / {results['wp_data'].size} "
          "bins; wrote nonparametric_fit.png")
