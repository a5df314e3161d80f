"""One sharded "training step" on a world of n ranks: the counterpart of
tabcorr_tpu's ``dryrun_multichip`` (``__graft_entry__.py:103-200``).

    from tabcorr_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, device="cpu")      # 4 gloo ranks on the CPU
    dryrun_multichip(1)                    # one NCCL rank on the card

The framework's training step is one MCMC ensemble update: walkers split
over the mesh's ``dp`` axis, the bolplanck wp table's halo bins over
``tp`` (``make_sharded_predict``), a Gaussian log posterior through the
whole prediction, a stretch-move step and a gradient (HMC's force).  For
every tp in (1, 2, 4) that divides the world the sharded prediction is
held against the unsharded plain engine on the same rows with the
reference's tolerances (ngal 1e-5 relative, xi 1e-4 relative plus 1e-6
of the batch's largest |xi|); the dp-sharded bundle predictor against the
unsharded one likewise.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .mesh import batch_sharding, gather_batch, make_mesh, run_world
from .shard import make_sharded_predict

DATA = Path(__file__).resolve().parents[1] / "data"
NAMES = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")


def _close(got, want, rtol, atol_scale):
    got, want = (np.asarray(x.detach().cpu(), np.float64)
                 for x in (got, want))
    atol = atol_scale * float(np.max(np.abs(want)))
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(
            f"sharded and unsharded differ: max |diff| "
            f"{np.max(np.abs(got - want)):.3e} (rtol {rtol}, atol {atol:.3e})")


def _dryrun_rank(n_devices, device_type):
    import tabcorr_tpu_torch as ttt
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    torch.backends.cuda.matmul.allow_tf32 = False
    tab = ttt.TabCorr.read(DATA / "bolplanck_wp.npz")
    model = ttt.Zheng07Model(threshold=-18, redshift=tab.attrs["redshift"])
    tp_degrees = [t for t in (1, 2, 4) if n_devices % t == 0]
    batch = 8 * n_devices
    rng = np.random.default_rng(1)
    params = ttt.params_batch(
        model, {"logM1": model.param_dict["logM1"] +
                0.1 * rng.normal(size=batch)}, (batch,), device=device)
    plain = ttt.make_predictor(tab, model, engine="plain", device=device)
    ngal_ref, xi_ref = plain(params)
    table = tab.table_data(n_gauss=10, dtype=torch.float32, device=device)
    for tp in tp_degrees:
        mesh = make_mesh(n_devices, table_parallel=tp)
        rows = batch_sharding(mesh, batch)
        predict, _ = make_sharded_predict(mesh, table, model)
        ngal, xi = predict(params)
        _close(ngal, ngal_ref[rows], 1e-5, 0.0)
        _close(xi, xi_ref[rows], 1e-4, 1e-6)

    # The training step, on the widest table split: a stretch-move step
    # over walkers whose log posterior each rank evaluates on its rows,
    # gathered over dp once a call, and the posterior's gradient.
    mesh = make_mesh(n_devices, table_parallel=tp_degrees[-1])
    predict, _ = make_sharded_predict(mesh, table, model)
    data = xi_ref[0].double()
    inv_var = 1.0 / (0.05 * data.abs() + 1e-3) ** 2

    def log_prob_rows(theta):
        p = {k: torch.full((len(theta),), float(v), device=device,
                           dtype=theta.dtype)
             for k, v in model.param_dict.items()}
        p.update({k: theta[:, i] for i, k in enumerate(NAMES)})
        _, xi = predict(p)
        return -0.5 * (((xi.double() - data) ** 2) * inv_var).sum(dim=-1)

    def log_prob(theta):
        return gather_batch(log_prob_rows(theta), mesh)

    n_walkers = 16 * n_devices
    walkers = torch.tensor(
        np.array([model.param_dict[k] for k in NAMES])[None, :] +
        0.01 * rng.normal(size=(n_walkers, len(NAMES))),
        dtype=torch.float32, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    lp = log_prob(walkers)
    walkers, lp, accept = ttt.ensemble_step(generator, walkers, lp,
                                            log_prob, vectorized=True)
    if walkers.shape != (n_walkers, len(NAMES)) or not bool(
            torch.isfinite(lp).all()):
        raise AssertionError("the sharded ensemble step lost its walkers.")
    theta = walkers.detach().clone().requires_grad_(True)
    force = torch.autograd.grad(log_prob_rows(theta).sum(), theta)[0]
    rows = batch_sharding(mesh, n_walkers)
    grad_finite = bool(torch.isfinite(force[rows]).all())
    if not grad_finite:
        raise AssertionError("the sharded gradient is not finite.")

    # The dp-sharded bundle predictor against the unsharded one.
    dp_mesh = make_mesh(n_devices, table_parallel=1)
    unsharded = ttt.make_multi_predictor([tab], model, device=device)
    sharded = ttt.make_multi_predictor([tab], model, device=device,
                                       mesh=dp_mesh)
    [(ng_p, xi_p)] = unsharded(params)
    [(ng_s, xi_s)] = sharded(params)
    rows = batch_sharding(dp_mesh, batch)
    _close(ng_s, ng_p[rows], 1e-5, 0.0)
    _close(xi_s, xi_p[rows], 1e-5, 1e-5)
    return {"rank": dist.get_rank(), "tp_degrees": tp_degrees,
            "grad_finite": grad_finite, "accept": float(accept)}


def dryrun_multichip(n_devices, *, device="cuda"):
    """Run the sharded step on a new world of ``n_devices`` ranks
    (:func:`~.mesh.run_world`): on the card under NCCL (a rank a GPU), or
    on the CPU under gloo with ``device='cpu'``.  Raises if any rank's
    check fails; returns each rank's report."""
    device = torch.device(device).type
    backend = "nccl" if device == "cuda" else "gloo"
    return run_world(_dryrun_rank, n_devices, backend, device,
                     args=(n_devices, device))


__all__ = ["dryrun_multichip"]
