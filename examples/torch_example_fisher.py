"""Fisher forecast through the differentiable predictor, with the PyTorch
port (counterpart of examples/example_fisher.py).

The plain float64 engine is differentiable, so the Jacobian
d(wp)/d(theta) is exact to rounding with ``torch.func.jacfwd``, and the
Fisher matrix of a 5-parameter zheng07 HOD is

    F_ab = sum_ij (d wp_i / d theta_a) C^-1_ij (d wp_j / d theta_b)

plus an ngal term (toy errors: 5% diagonal on wp, 3% on ngal).

    python examples/torch_example_fisher.py --device cuda
"""

import argparse
from pathlib import Path

import torch

import tabcorr_tpu_torch as ttt

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"


def run(device="cuda"):
    """The forecast: parameter names, fiducial values, Fisher matrix,
    marginal errors and correlation matrix (float64 tensors on the
    host)."""
    halotab = ttt.TabCorr.read(DATA / "bolplanck_wp.npz")
    model = ttt.Zheng07Model(threshold=-18,
                             redshift=halotab.attrs["redshift"])
    names = tuple(model.param_dict)
    theta0 = torch.tensor([model.param_dict[k] for k in names],
                          dtype=torch.float64, device=device)
    predict = ttt.make_predictor(halotab, model, dtype=torch.float64,
                                 vectorized=False, engine="plain",
                                 device=device)

    def observables(theta):
        return predict(dict(zip(names, theta)))

    ngal0, wp0 = observables(theta0)
    jac_wp = torch.func.jacfwd(lambda t: observables(t)[1])(theta0)
    jac_ngal = torch.func.jacfwd(lambda t: observables(t)[0])(theta0)
    inv_cov_wp = torch.diag(1.0 / (0.05 * wp0) ** 2)
    fisher = (jac_wp.T @ inv_cov_wp @ jac_wp +
              torch.outer(jac_ngal, jac_ngal) / (0.03 * ngal0) ** 2)
    cov = torch.linalg.inv(fisher)
    sigma = torch.sqrt(torch.diag(cov))
    corr = cov / torch.outer(sigma, sigma)
    return dict(names=names, theta0=theta0.cpu(), fisher=fisher.cpu(),
                sigma=sigma.cpu(), corr=corr.cpu())


def plot(results, path="."):
    """fisher_correlation.png (the correlation matrix) in ``path``."""
    import matplotlib.pyplot as plt

    names = results["names"]
    fig, ax = plt.subplots(figsize=(4.5, 4))
    im = ax.imshow(results["corr"].numpy(), vmin=-1, vmax=1, cmap="RdBu_r")
    ax.set_xticks(range(len(names)), names, rotation=45, ha="right")
    ax.set_yticks(range(len(names)), names)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(Path(path) / "fisher_correlation.png", dpi=150)
    plt.close(fig)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    results = run(device=args.device)
    print("zheng07 Fisher forecast (wp + ngal, toy 5%/3% errors)")
    for k, t, s in zip(results["names"], results["theta0"],
                       results["sigma"]):
        print(f"  {k:>10s} = {float(t):7.3f} +/- {float(s):.3f}")
    plot(results)
    print("wrote fisher_correlation.png")
