"""Galaxy-galaxy lensing with the PyTorch port (counterpart of
examples/example_ds.py).

Predicts the excess surface density Delta Sigma(rp) of a zheng07 HOD from
the bolplanck cross-mode tabulation, in total and split into centrals and
satellites, with the float64 plain engine on ``device``.

    python examples/torch_example_ds.py --device cuda
"""

import argparse
from pathlib import Path

import torch

import tabcorr_tpu_torch as ttt

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"


def run(device="cuda"):
    """Delta Sigma and its decomposition at the zheng07 -21 model."""
    halotab = ttt.TabCorr.read(DATA / "bolplanck_ds.npz")
    rp_bins = halotab.tpcf_args[-1]
    model = ttt.Zheng07Model(
        threshold=-21, redshift=halotab.attrs["redshift"],
        prim_haloprop_key=halotab.attrs["prim_haloprop_key"])
    params = ttt.params_batch(model, batch_shape=(1,), dtype=torch.float64,
                              device=device)
    ngal, ds = ttt.make_predictor(halotab, model, dtype=torch.float64,
                                  device=device)(params)
    ngal_sep, ds_sep = ttt.make_predictor(
        halotab, model, dtype=torch.float64, separate_gal_type=True,
        device=device)(params)
    return dict(rp_ave=0.5 * (rp_bins[1:] + rp_bins[:-1]),
                ngal=float(ngal[0]), ds=ds[0].cpu().numpy(),
                ds_sep={k: v[0].cpu().numpy() for k, v in ds_sep.items()})


def plot(results, path="."):
    """ds_decomposition.png in the directory ``path``."""
    import matplotlib.pyplot as plt

    rp_ave = results["rp_ave"]
    plt.plot(rp_ave, rp_ave * results["ds"] / 1e12, label="total")
    for key, value in results["ds_sep"].items():
        plt.plot(rp_ave, rp_ave * value / 1e12, label=key, ls="--")
    plt.xscale("log")
    plt.xlabel(r"$r_{\rm p} \ [h^{-1} \ \mathrm{Mpc}]$")
    plt.ylabel(
        r"$r_{\rm p} \times \Delta\Sigma \ [10^6 \, M_\odot / \mathrm{pc}]$")
    plt.legend(loc="best", frameon=False)
    plt.tight_layout(pad=0.3)
    plt.savefig(Path(path) / "ds_decomposition.png", dpi=300)
    plt.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    plot(run(device=args.device))
    print("wrote ds_decomposition.png")
