"""Device meshes over ``torch.distributed``: one process per GPU.

tabcorr_tpu drives every device of a ``jax.sharding.Mesh`` from one
controller (``tabcorr_tpu/parallel/mesh.py``).  Here each GPU has its own
process (a rank); the ranks form one ``torch.distributed`` world and a
``DeviceMesh`` with the dimensions ("dp", "tp"):

* **dp** ("data parallel"): the parameter batch, or the MCMC walkers, is
  split over the ranks.  The tables are small (a few MB) and every rank
  holds them whole, so a dp-sharded predictor runs no collective: each
  rank computes its own rows (:func:`shard_params`) and
  :func:`gather_batch` assembles the batch where the caller needs it.
* **tp** ("table parallel"): the halo-bin axis of a table is split over
  the ranks, and the contraction ends in collectives over the tp group
  (:mod:`tabcorr_tpu_torch.parallel.shard`).

Every rank runs the same program on the same global batch (made from one
seed); a mesh predictor takes that batch and returns its rank's rows.
:func:`run_world` spawns such a world in one call, for tests, examples and
the multi-GPU dry run.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BATCH_AXIS = "dp"
TABLE_AXIS = "tp"
# How long run_world waits for its ranks [s].
WORLD_TIMEOUT = 600.0


def _init_method(coordinator_address):
    """``env://`` for None, ``tcp://host:port`` for ``host:port``, and any
    URL with a scheme (``tcp://``, ``file://``, ``env://``) as given."""
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, backend=None):
    """Join this process to the ``torch.distributed`` world.

    The counterpart of tabcorr_tpu's ``initialize_multihost``
    (``jax.distributed.initialize``): ``coordinator_address`` is the
    rendezvous (``host:port`` for a TCP store on rank 0's host, a
    ``file://`` path, or None for ``env://``, which reads MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK), ``num_processes`` the world size and
    ``process_id`` this rank.  ``backend`` is NCCL where torch finds a CUDA
    device and gloo on the CPU, unless the caller names one; NCCL is never
    replaced by gloo.  For NCCL the process's GPU is set first (rank modulo
    the GPUs of the host) unless CUDA is already initialized, in which
    case the caller's current device stands.

    Safe to call more than once: a later call with arguments the world
    agrees with returns at once; one that contradicts it raises.

    Returns the number of processes in the world.
    """
    if dist.is_initialized():
        for name, want, have in (
                ("num_processes", num_processes, dist.get_world_size()),
                ("process_id", process_id, dist.get_rank()),
                ("backend", backend, dist.get_backend())):
            if want is not None and want != have:
                raise ValueError(f"the world is initialized with {name}="
                                 f"{have!r}, not {want!r}.")
        return dist.get_world_size()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs a CUDA device.")
        if not torch.cuda.is_initialized():
            rank = process_id if process_id is not None else int(
                os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
            torch.cuda.set_device(rank % torch.cuda.device_count())
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=_init_method(
        coordinator_address), **kwargs)
    return dist.get_world_size()


def make_mesh(n_devices=None, table_parallel=1):
    """A (dp, tp) ``DeviceMesh`` over the initialized world.

    ``table_parallel`` ranks cooperate on each contraction (bin-sharded);
    the remaining factor splits the parameter batch.  A mesh spans the
    whole world: ``n_devices`` (default the world size) must equal it.  The
    mesh's device type is 'cuda' under NCCL and 'cpu' otherwise (a gloo
    world whose ranks share one GPU keeps its tensors on the GPU all the
    same; the mesh only carries the groups).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized world: call "
                           "initialize_multihost first.")
    world = dist.get_world_size()
    n_devices = world if n_devices is None else int(n_devices)
    if table_parallel < 1 or n_devices % table_parallel != 0:
        raise ValueError(f"table_parallel={table_parallel} must divide "
                         f"n_devices={n_devices}.")
    if n_devices != world:
        raise ValueError(f"a mesh spans the world: n_devices={n_devices}, "
                         f"world size {world}.")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type,
                            (n_devices // table_parallel, table_parallel),
                            mesh_dim_names=(BATCH_AXIS, TABLE_AXIS))


def _axis_size(mesh, axis):
    """The number of ranks along the mesh dimension ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_sharding(mesh, batch, batch_axis=BATCH_AXIS):
    """This rank's rows of a (batch, ...) array split in equal contiguous
    blocks over ``batch_axis``, as a slice.  ``batch`` must divide by the
    axis size, so that every rank's block has the same rows and
    :func:`gather_batch` needs one collective."""
    n = _axis_size(mesh, batch_axis)
    if batch % n != 0:
        raise ValueError(f"the batch ({batch}) must divide by the "
                         f"{batch_axis!r} axis size ({n}).")
    rows = batch // n
    start = mesh.get_local_rank(batch_axis) * rows
    return slice(start, start + rows)


def replicated_sharding(mesh, batch):
    """The rows of a replicated (batch, ...) array a rank holds: all."""
    return slice(0, batch)


def shard_params(params, mesh, batch_axis=BATCH_AXIS):
    """This rank's rows of a dict of (B,) parameter tensors: the global
    batch, the same on every rank, cut by :func:`batch_sharding`."""
    batch = next(iter(params.values())).shape[0]
    rows = batch_sharding(mesh, batch, batch_axis)
    return {k: v[rows] for k, v in params.items()}


def gather_batch(x, mesh, batch_axis=BATCH_AXIS):
    """The global batch from every rank's rows of ``x`` (a tensor, or
    tuples, lists and dicts of them): one all-gather over ``batch_axis``
    per tensor, concatenated along the first axis in rank order."""
    if isinstance(x, dict):
        return {k: gather_batch(v, mesh, batch_axis) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(gather_batch(v, mesh, batch_axis) for v in x)
    group = mesh.get_group(batch_axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


# ----------------------------------------------------------------------
# Spawning a world
# ----------------------------------------------------------------------
def _rank_main(rank, world_size, backend, device, init_method, fn, args,
               results):
    """One rank of :func:`run_world`: set the device, join the world, run
    ``fn(*pickle.loads(args))`` and send its pickled result (or the
    traceback) back."""
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        initialize_multihost(init_method, world_size, rank, backend)
        out = fn(*pickle.loads(args))
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world_size, backend, device, args=(), init_method=None):
    """Run ``fn(*args)`` on every rank of a new ``world_size``-process world
    and return the ranks' results in rank order.

    The ranks are spawned (``torch.multiprocessing``, start method
    'spawn'), so ``fn`` must be a module-level function and its result
    picklable (move tensors to the CPU).  Each rank sets its device
    (``device='cuda'``: GPU rank modulo the host's GPUs, so several ranks
    may share one GPU under gloo; 'cpu': one thread) and joins the world
    through :func:`initialize_multihost` with ``backend`` over
    ``init_method`` (default a ``file://`` store in a new temporary
    directory, so that concurrent worlds never share a port).  A rank that
    raises or dies, or a world that outlasts ``WORLD_TIMEOUT`` seconds,
    fails the call: every rank is stopped and the error raised with the
    ranks' tracebacks.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    store_dir = None
    if init_method is None:
        store_dir = tempfile.mkdtemp(prefix="tabcorr_world_")
        init_method = f"file://{os.path.join(store_dir, 'store')}"
    results = ctx.Queue()
    # Arguments and results travel as plain pickles: copies, where
    # torch's own reducers would move the caller's CPU tensors into shared
    # memory in place.
    payload = pickle.dumps(tuple(args))
    procs = [ctx.Process(target=_rank_main, args=(
        rank, world_size, backend, device, init_method, fn, payload,
        results), daemon=True) for rank in range(world_size)]
    outputs, errors = {}, {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + WORLD_TIMEOUT
        while len(outputs) + len(errors) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in
                        (None, 0) and r not in errors and r not in outputs]
                if dead and results.empty():
                    for r in dead:
                        errors[r] = (f"rank {r} exited with code "
                                     f"{procs[r].exitcode}")
                elif time.monotonic() > deadline:
                    errors[-1] = f"the world outlasted {WORLD_TIMEOUT} s"
                    break
                continue
            (outputs if ok else errors)[rank] = payload
            if errors:
                break
    finally:
        if errors:
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
    if errors:
        raise RuntimeError("run_world failed:\n" + "\n".join(
            errors[r] for r in sorted(errors)))
    return [pickle.loads(outputs[r]) for r in range(world_size)]


__all__ = ["BATCH_AXIS", "TABLE_AXIS", "initialize_multihost", "make_mesh",
           "batch_sharding", "replicated_sharding",
           "shard_params", "gather_batch", "run_world"]
