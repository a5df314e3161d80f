"""Projected clustering with the PyTorch port (counterpart of
examples/example_wp.py).

Predicts wp(rp) of a zheng07 HOD from the bolplanck wp tabulation, split
by galaxy type, and its dependence on logM1 for a whole batch of models
in one call of the batched predictor (on the card the contraction
kernel).

    python examples/torch_example_wp.py --device cuda
"""

import argparse
from pathlib import Path

import numpy as np

import tabcorr_tpu_torch as ttt

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"


def run(device="cuda", n_models=1000):
    """The decomposition (float64, on the host) and ``n_models`` wp(rp)
    for logM1 over [12.0, 12.8] (float32, on ``device``)."""
    halotab = ttt.TabCorr.read(DATA / "bolplanck_wp.npz")
    rp_bins = halotab.tpcf_args[0]
    model = ttt.Zheng07Model(
        threshold=-18, redshift=halotab.attrs["redshift"],
        prim_haloprop_key=halotab.attrs["prim_haloprop_key"])
    ngal, wp = halotab.predict(model)
    ngal_sep, wp_sep = halotab.predict(model, separate_gal_type=True)

    predict = ttt.make_predictor(halotab, model, device=device)
    logm1 = np.linspace(12.0, 12.8, n_models)
    params = ttt.params_batch(model, {"logM1": logm1}, (n_models,),
                              device=device)
    ngal_batch, wp_batch = predict(params)
    return dict(rp_ave=0.5 * (rp_bins[1:] + rp_bins[:-1]), ngal=ngal,
                wp=wp, wp_sep=wp_sep, logm1=logm1,
                ngal_batch=ngal_batch.cpu().numpy(),
                wp_batch=wp_batch.cpu().numpy())


def plot(results, path="."):
    """wp_decomposition.png and wp_vs_logm1.png in the directory
    ``path``."""
    import matplotlib as mpl
    import matplotlib.pyplot as plt

    path = Path(path)
    rp_ave = results["rp_ave"]
    plt.plot(rp_ave, results["wp"], label="total")
    for key, value in results["wp_sep"].items():
        plt.plot(rp_ave, value, label=key, ls="--")
    plt.xscale("log")
    plt.yscale("log")
    plt.xlabel(r"$r_{\rm p} \ [h^{-1} \ \mathrm{Mpc}]$")
    plt.ylabel(r"$w_{\rm p} \ [h^{-1} \ \mathrm{Mpc}]$")
    plt.legend(loc="lower left", frameon=False)
    plt.tight_layout(pad=0.3)
    plt.savefig(path / "wp_decomposition.png", dpi=300)
    plt.close()

    logm1 = results["logm1"]
    sm = mpl.cm.ScalarMappable(
        cmap=mpl.cm.viridis,
        norm=mpl.colors.Normalize(vmin=logm1.min(), vmax=logm1.max()))
    for value, wp in zip(logm1, results["wp_batch"]):
        plt.plot(rp_ave, wp, color=sm.to_rgba(value), lw=0.1)
    cb = plt.colorbar(sm, ax=plt.gca())
    cb.set_label(r"$\log M_1$")
    plt.xscale("log")
    plt.yscale("log")
    plt.xlabel(r"$r_{\rm p} \ [h^{-1} \ \mathrm{Mpc}]$")
    plt.ylabel(r"$w_{\rm p} \ [h^{-1} \ \mathrm{Mpc}]$")
    plt.tight_layout(pad=0.3)
    plt.savefig(path / "wp_vs_logm1.png", dpi=300)
    plt.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    plot(run(device=args.device))
    print("wrote wp_decomposition.png, wp_vs_logm1.png")
