"""What each rank of the CPU ``gloo`` worlds of test_torch_parallel.py and
test_torch_parallel_sweep.py runs.

The ranks are spawned processes: they import this module and the port,
never jax or tabcorr_tpu.  Every rank gets the same numpy inputs and
returns numpy results (the whole batch where the results are split over
dp, gathered with ``gather_batch``); the tests hold them against
tabcorr_tpu in the parent.
"""

import contextlib
from pathlib import Path

import torch
import torch.distributed as dist

import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.ops.paircount import labeled_pair_count
from tabcorr_tpu_torch.parallel import (initialize_multihost,
                                        make_mesh, make_sharded_predict)
from tabcorr_tpu_torch.parallel.mesh import batch_sharding, gather_batch
from tabcorr_tpu_torch.utils.synthetic import (grid64_interpolator,
                                               wide_grid_interpolator)

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "broadcast", "broadcast_object_list",
               "reduce", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "scatter", "gather",
               "barrier", "send", "recv", "isend", "irecv")
# The small Interpolators of the dp-sharded grid routes: 64 nodes (4 x 4 x
# 4, the fewest a cubic spline takes) of 8 bins (packed layout, the grid
# kernel) and of 128 bins (slab layout, the slab kernels), 3 rows.
PACKED_GRID = dict(n_nodes=64, n_prim=4, n_xi=3)
WIDE_GRID = dict(n_nodes=64, n_prim=32, n_sec=2, n_xi=3)


@contextlib.contextmanager
def collective_calls():
    """Count the calls of every ``torch.distributed`` collective inside
    the block: yields a list that holds their names."""
    calls, saved = [], {}
    for name in COLLECTIVES:
        fn = saved[name] = getattr(dist, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)

        setattr(dist, name, spy)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _tables():
    return {k: ttt.TabCorr.read(DATA / f"{f}.npz") for k, f in (
        ("wp", "bolplanck_wp"), ("ds", "bolplanck_ds"),
        ("xi", "synthetic_xi_ell"))}


def _numpy(x):
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy(v) for v in x)
    return x.detach().cpu().numpy()


def _errors(calls):
    """Each call's ValueError message, or None where it did not raise."""
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def parallel_rank(sharded_params, loss_weights, dp_params, grid_params,
                  odd_tab):
    """One rank of test_torch_parallel.py's 4-rank world; ``odd_tab`` is
    a 14-bin table, which 4 table shards pad."""
    rank = dist.get_rank()
    out = {"rank": rank, "world": dist.get_world_size(),
           "backend": dist.get_backend()}
    out["again"] = initialize_multihost(num_processes=4, process_id=rank,
                                        backend="gloo")
    out["init_errors"] = _errors([
        lambda: initialize_multihost(num_processes=3),
        lambda: initialize_multihost(process_id=(rank + 1) % 4)])
    out["mesh_errors"] = _errors([
        lambda: make_mesh(4, table_parallel=3),
        lambda: make_mesh(3), lambda: make_mesh(table_parallel=0)])
    tabs = _tables()
    tabs["odd"] = odd_tab
    model = ttt.Zheng07Model(threshold=-18,
                             redshift=tabs["wp"].attrs["redshift"])

    # Table-parallel predict, float64, and its gradient.
    out["sharded"] = {}
    for tp in (2, 4):
        mesh = make_mesh(4, table_parallel=tp)
        out.setdefault("mesh_shapes", []).append(
            (tuple(mesh.shape), tuple(mesh.mesh_dim_names),
             mesh.get_local_rank("dp"), mesh.get_local_rank("tp")))
        for name in ("wp", "ds", "odd"):
            table = tabs[name].table_data(dtype=torch.float64, device="cpu")
            predict, padded = make_sharded_predict(mesh, table, model)
            params = {k: torch.tensor(v, requires_grad=True)
                      for k, v in sharded_params.items()}
            ngal, xi = predict(params)
            rows = batch_sharding(mesh, len(loss_weights["ngal"]))
            w_xi = loss_weights["xi"][rows, :xi.shape[1]]
            loss = ((ngal * torch.tensor(loss_weights["ngal"][rows])).sum()
                    + (xi * torch.tensor(w_xi)).sum())
            loss.backward()
            grads = {k: v.grad[rows] for k, v in params.items()}
            out["sharded"][tp, name] = dict(
                _numpy(gather_batch(
                    {"ngal": ngal.detach(), "xi": xi.detach(), **{
                        "grad_" + k: g for k, g in grads.items()}}, mesh)),
                n_bins=padded.n_bins,
                nonzero_grad_rows=sorted({int(i) for v in params.values()
                                          for i in torch.nonzero(v.grad)}))

    # The dp-sharded kernels' plain versions (mesh (4, 1)): the rank's
    # rows, gathered; the collectives the predictor call itself runs.
    mesh = make_mesh(4)
    p32 = {k: torch.tensor(v) for k, v in dp_params.items()}
    bundle = ttt.make_multi_predictor(
        [tabs["wp"], tabs["xi"]], model, device="cpu", engine="bundle",
        accuracy=("elementwise", "scaled"), mesh=mesh)
    members = ttt.make_multi_predictor(
        [tabs["wp"], tabs["ds"]], model, device="cpu", engine="auto",
        mesh=mesh)
    grid_model = ttt.Zheng07Model(threshold=-20, redshift=0.0)
    g32 = {k: torch.tensor(v) for k, v in grid_params.items()}
    grids = {name: ttt.make_predictor(
        make_interp(**kw), grid_model, engine="fused", accuracy="scaled",
        device="cpu", mesh=mesh) for name, make_interp, kw in (
            ("packed", grid64_interpolator, PACKED_GRID),
            ("slab", wide_grid_interpolator, WIDE_GRID))}
    out["dp"], out["dp_calls"], out["dp_rows"] = {}, {}, {}
    for name, fn, p in (("bundle", bundle, p32), ("members", members, p32),
                        ("packed", grids["packed"], g32),
                        ("slab", grids["slab"], g32)):
        before = (fused.BUNDLE_LAUNCHES, fused.GRID_LAUNCHES,
                  fused.SLAB_LAUNCHES, fused.SLAB_TC_LAUNCHES)
        with collective_calls() as calls:
            rows = fn(p)
        assert before == (fused.BUNDLE_LAUNCHES, fused.GRID_LAUNCHES,
                          fused.SLAB_LAUNCHES, fused.SLAB_TC_LAUNCHES)
        out["dp_calls"][name] = list(calls)
        out["dp_rows"][name] = len((rows[0] if name in ("bundle", "members")
                                    else rows)[0])
        out["dp"][name] = _numpy(gather_batch(rows, mesh))
    out["dp_errors"] = _errors([
        lambda: bundle({k: v[:15] for k, v in p32.items()}),
        lambda: ttt.make_predictor(tabs["wp"], model, engine="fused",
                                   device="cpu", mesh=mesh),
        lambda: ttt.make_predictor(grid64_interpolator(**PACKED_GRID),
                                   grid_model, engine="plain",
                                   device="cpu", mesh=mesh)])
    return out


def sweep_rank(cases, tabulate_spec):
    """One rank of test_torch_parallel_sweep.py's 4-rank world: each case
    of ``cases`` (name -> labeled_pair_count keyword arguments) through
    ``labeled_pair_count(mesh=)``, with the collectives it runs, then
    ``TabCorr.tabulate(mesh=)`` of ``tabulate_spec``."""
    from tabcorr_tpu_torch.utils.synthetic import synthetic_halocat

    mesh = make_mesh(4)
    out = {"counts": {}, "calls": {}}
    for name, kwargs in cases.items():
        with collective_calls() as calls:
            out["counts"][name] = labeled_pair_count(
                **kwargs, mesh=mesh, device="cpu")
        out["calls"][name] = list(calls)
    halocat = synthetic_halocat(**tabulate_spec["halocat"])
    out["tabulate"] = {name: ttt.TabCorr.tabulate(
        halocat, tpcf, *args, **kwargs, mesh=mesh,
        device="cpu").tpcf_matrix
        for name, (tpcf, args, kwargs) in tabulate_spec["cases"].items()}
    return out
