"""Multi-GPU batched prediction and MCMC with the PyTorch port
(counterpart of examples/example_multichip.py).

One process per GPU: the ranks form a ``torch.distributed`` world and a
("dp", "tp") mesh with the whole world on dp.  The zheng07 wp table is
small, so every rank holds it whole; a parameter batch, the same on every
rank (one seed), is split over dp, and each rank's bundle predictor
(``make_multi_predictor(mesh=)``) launches the bundle kernel on its own
rows, with no collective.  Then a stretch-move ensemble runs on every rank
alike (one generator seed): each call of the log posterior evaluates the
rank's rows of the walkers and gathers the log probabilities over dp, one
collective a call, so every rank holds the same ensemble.

    python examples/torch_example_multichip.py                # NCCL, a rank a GPU
    python examples/torch_example_multichip.py --device cpu --ranks 2   # gloo
"""

import argparse
from pathlib import Path

import numpy as np
import torch

import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch.parallel import make_mesh
from tabcorr_tpu_torch.parallel.mesh import (batch_sharding, gather_batch,
                                             run_world)

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"


def rank_run(device_type, batch_per_rank, walkers_per_rank, n_steps, seed):
    """What each rank runs (see the module docstring); returns its rows
    of the batch, gathered, and its final ensemble, as numpy."""
    from tabcorr_tpu_torch.ops import fused

    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    mesh = make_mesh()
    n_ranks = mesh.size(0)
    halotab = ttt.TabCorr.read(DATA / "bolplanck_wp.npz")
    model = ttt.Zheng07Model(threshold=-18,
                             redshift=halotab.attrs["redshift"])

    # The dp-sharded bundle predictor: the rank's rows of a global batch.
    predict = ttt.make_multi_predictor([halotab], model, device=device,
                                       mesh=mesh)
    rng = np.random.default_rng(seed)
    batch = batch_per_rank * n_ranks
    params = ttt.params_batch(
        model, {"logM1": 12.4 + 0.1 * rng.normal(size=batch)}, (batch,),
        device=device)
    launches = fused.BUNDLE_LAUNCHES
    [(ngal, wp)] = predict(params)
    launches = fused.BUNDLE_LAUNCHES - launches
    rows = len(ngal)

    # Synthetic data (float64 host path, 5% errors) and the posterior.
    truth = dict(model.param_dict)
    _, wp_data = halotab.predict(model)
    inv_cov = np.diag(1.0 / (0.05 * np.abs(wp_data)) ** 2)
    names = tuple(truth)
    log_prob_rows = ttt.make_gaussian_logpost_batched(
        ttt.make_multi_predictor([halotab], model, device=device), names,
        truth, [wp_data], [inv_cov], device=device)

    def log_prob(theta):
        """Every rank holds all walkers: it evaluates its rows of them and
        gathers the log probabilities over dp."""
        return gather_batch(
            log_prob_rows(theta[batch_sharding(mesh, len(theta))]), mesh)

    n_walkers = walkers_per_rank * n_ranks
    walkers0 = torch.tensor(
        np.array([truth[k] for k in names])[None, :] +
        0.05 * rng.normal(size=(n_walkers, len(names))),
        dtype=torch.float32, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    chain, log_probs, accept = ttt.run_ensemble(
        generator, log_prob, walkers0, n_steps, vectorized=True)
    return dict(
        n_ranks=n_ranks, rows=rows, launches=launches,
        params={k: v.cpu().numpy() for k, v in params.items()},
        ngal=gather_batch(ngal, mesh).cpu().numpy(),
        wp=gather_batch(wp, mesh).cpu().numpy(),
        walkers=chain[-1].cpu().numpy(),
        log_prob=log_probs[-1].cpu().numpy(), accept=float(accept),
        truth=truth, names=names)


def run(device="cuda", n_ranks=None, batch_per_rank=512,
        walkers_per_rank=128, n_steps=50, seed=42):
    """Spawn ``n_ranks`` ranks (default: one a GPU, or 2 on the CPU), NCCL
    on the card and gloo on the CPU, and run :func:`rank_run` on each;
    returns every rank's results."""
    device = torch.device(device).type
    if n_ranks is None:
        n_ranks = torch.cuda.device_count() if device == "cuda" else 2
    backend = "nccl" if device == "cuda" else "gloo"
    return run_world(rank_run, n_ranks, backend, device, args=(
        device, batch_per_rank, walkers_per_rank, n_steps, seed))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ranks", type=int, default=None)
    args = parser.parse_args()
    results = run(device=args.device, n_ranks=args.ranks)
    first = results[0]
    print(f"ranks: {first['n_ranks']} ({args.device})")
    print(f"sharded batch predict: {len(first['ngal'])} evaluations, "
          f"{first['rows']} a rank -> wp {first['wp'].shape}")
    best = first["walkers"][np.argmax(first["log_prob"])]
    print("truth  :", {k: round(first["truth"][k], 3)
                       for k in first["names"]})
    print("MAP-ish:", {k: round(float(v), 3)
                       for k, v in zip(first["names"], best)})
    print(f"acceptance: {first['accept']:.2f}")
