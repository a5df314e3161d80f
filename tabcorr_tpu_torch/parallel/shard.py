"""Bin-sharded ("table parallel") prediction over a (dp, tp) mesh.

The counterpart of ``tabcorr_tpu/parallel/shard.py``.  For tabulations too
large to replicate comfortably, the halo-bin axis of the dense matrix is
split over the ``tp`` ranks.  Each rank evaluates the occupation on its
bins and contracts its shard; collectives over the tp group finish the
forms:

    auto :  xi_k = sum_d( n_d^T F_k[d-shard, :] n ) / (sum_d sum n_d)^2
    cross:  xi_k = sum_d( F_k[:, d-shard] n_d ) / sum_d sum n_d

(an all-gather of n over tp for the auto form, then one all-reduce for the
numerator and one for sum n).  The parameter batch stays split over ``dp``
at the same time.  tabcorr_tpu contracts here with plain ``einsum`` at
``Precision.HIGHEST`` outside any Pallas kernel, and so does this module,
with TF32 off.

Gradients flow.  The collectives sit between two conjugate autograd
functions (the pair tensor-parallel training uses): the parameters enter
the tp shards through :class:`_CopyToShards` (forward the identity,
backward an all-reduce of the gradient over tp), and a sum over the shards
leaves through :class:`_ReduceFromShards` (forward an all-reduce, backward
the identity); the gathered densities, which each rank's partial sum
reads whole, come from :class:`_GatherFromShards` (forward an all-gather,
backward a reduce-scatter).  Every tp rank then holds the same prediction
and, after ``backward`` of the same loss, the same full gradient, as
``jax.grad`` through tabcorr_tpu's ``shard_map`` gives it.
(``torch.distributed.nn.functional``'s all-reduce differentiates to an
all-reduce, the rule for a loss summed over the ranks; a loss that every
tp rank holds alike would count tp times.)
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models.protocol import occupation_functions
from ..ops.predict import AUTO, TableData, occupation_with_residual
from .mesh import TABLE_AXIS, shard_params


def _pad_to_multiple(x, dim, multiple):
    """Zero-pad ``dim`` to a multiple; zero bins have n_h = 0 and drop
    out."""
    if x is None:
        return None
    pad = -x.shape[dim] % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def shard_table_data(table: TableData, n_shards: int) -> TableData:
    """Pad every bin-indexed axis of a table so it splits over ``n_shards``.

    Padding bins have ``n_h = 0``, so they contribute nothing to any
    contraction; the dense matrix is padded with zeros on both bin axes in
    auto mode (tabcorr_tpu's ``shard_table_data``)."""
    dense = _pad_to_multiple(table.tpcf_dense, 1, n_shards)
    if table.mode == AUTO:
        dense = _pad_to_multiple(dense, 2, n_shards)
    return dataclasses.replace(
        table, tpcf_dense=dense,
        **{f: _pad_to_multiple(getattr(table, f), 0, n_shards)
           for f in ("n_h", "log_prim_quad", "quad_weight", "sec_perc",
                     "log_prim_quad_lo")})


class _CopyToShards(torch.autograd.Function):
    """A tensor every tp rank holds whole, entering the shards: forward the
    identity, backward the sum of the shards' gradients (all-reduce)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromShards(torch.autograd.Function):
    """The sum over the tp shards, which every tp rank then holds: forward
    an all-reduce, backward the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromShards(torch.autograd.Function):
    """The shards' pieces concatenated along the last axis in tp order,
    which every tp rank then holds and uses in its own partial sums:
    forward an all-gather, backward the sum of the ranks' gradients
    (all-reduce) cut to this rank's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.index = dist.get_rank(group)
        ctx.width = x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        start = ctx.index * ctx.width
        return grad[..., start:start + ctx.width], None


def _check_matmul_precision(device):
    """The contraction must run in full float32: TF32 keeps ~3 digits."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("make_sharded_predict contracts in full float32:"
                           " set torch.backends.cuda.matmul.allow_tf32 = "
                           "False.")


def make_sharded_predict(mesh, table: TableData, model):
    """Build a (dp x tp)-sharded batched predict function.

    Returns ``(f, padded_table)``: ``f(params dict of (B,) tensors) ->
    (ngal (B / dp,), xi (B / dp, n_xi))`` takes the global batch (the same
    on every rank; B must divide by the dp axis size) and returns this
    rank's dp rows, which every rank of its tp group holds alike.  The
    table (float32 or float64, on this rank's device) is padded to split
    its bin axis over the tp axis; each tp rank keeps its shard of the
    bins, and of the dense matrix's first bin axis.  Differentiable in the
    parameters (see the module docstring).
    """
    group = mesh.get_group(TABLE_AXIS)
    n_tp = dist.get_world_size(group)
    shard = dist.get_rank(group)
    table = shard_table_data(table, n_tp)
    n_local = table.n_bins // n_tp
    bins = slice(shard * n_local, (shard + 1) * n_local)
    dense = table.tpcf_dense[:, bins]
    quad = {f: None if getattr(table, f) is None else getattr(table, f)[bins]
            for f in ("n_h", "log_prim_quad", "quad_weight", "sec_perc",
                      "log_prim_quad_lo")}
    global_bin = torch.arange(bins.start, bins.stop,
                              device=table.n_h.device)
    is_cen = (global_bin < table.n_centrals)[:, None]
    occ_cen, occ_sat = occupation_functions(model)
    auto = table.mode == AUTO

    def occupation(params):
        """(B, n_local) mean occupation on this rank's bins.  The
        central/satellite split is by global bin index: a shard may hold
        both kinds."""
        p = {k: v[..., None, None] for k, v in params.items()}
        sec = quad["sec_perc"][:, None]
        logm, res = quad["log_prim_quad"], quad["log_prim_quad_lo"]
        if res is None:
            occ_c = occ_cen(p, logm, sec)
            occ_s = occ_sat(p, logm, sec)
        else:
            occ_c = occupation_with_residual(occ_cen, p, logm, res, sec)
            occ_s = occupation_with_residual(occ_sat, p, logm, res, sec)
        occ = torch.where(is_cen, occ_c, occ_s)
        return torch.sum(quad["quad_weight"] * occ, dim=-1)

    def predict_batch(params):
        _check_matmul_precision(table.n_h.device)
        params = {k: _CopyToShards.apply(v, group)
                  for k, v in shard_params(params, mesh).items()}
        ngal_local = occupation(params) * quad["n_h"]       # (B, n_local)
        total = _ReduceFromShards.apply(ngal_local.sum(dim=-1), group)
        if auto:
            ngal_full = _GatherFromShards.apply(ngal_local, group)
            t = torch.einsum("kij,bj->bki", dense, ngal_full)
            xi = torch.einsum("bki,bi->bk", t, ngal_local)
            xi = _ReduceFromShards.apply(xi, group) / total[:, None] ** 2
        else:
            xi = torch.einsum("ki,bi->bk", dense, ngal_local)
            xi = _ReduceFromShards.apply(xi, group) / total[:, None]
        return total, xi

    return predict_batch, table


__all__ = ["make_sharded_predict", "shard_table_data"]
