"""The port's multi-GPU module (``tabcorr_tpu_torch.parallel``) in a CPU
``gloo`` world of 4 ranks, against tabcorr_tpu's meshes of virtual CPU
devices (tests/conftest.py forces 8).

One world per module (``world``): it joins over TCP through
``initialize_multihost("localhost:<port>", 4, rank, "gloo")`` (the
counterpart of tests/test_multihost.py) and runs
``torch_parallel_workers.parallel_rank`` on every rank; each test reads the
ranks' results.  The ranks import the port only.

Tolerances:

* ``make_sharded_predict`` in float64 against tabcorr_tpu's in float64
  (both ``einsum``s at full precision, summed in another order; the
  table-parallel sums add 2-4 partial sums): 1e-12 relative, values and
  gradients; against the port's unsharded float64 engine the same.
* The dp-sharded predictors (the plain versions of the bundle, grid and
  slab kernels, each rank on its rows): against the unsharded predictor
  on the whole batch within the bars of test_torch_bundle.py and
  test_torch_grid.py, ngal 1e-6 relative and xi 2e-6 of each row's
  largest element, and no collective inside the call.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.parallel import make_mesh as jax_make_mesh
from tabcorr_tpu.parallel import make_sharded_predict as jax_sharded
from tabcorr_tpu.parallel import shard_table_data as jax_shard_table
from tabcorr_tpu.predictor import occupation_functions
from tabcorr_tpu_torch.parallel import mesh as port_mesh
from tabcorr_tpu_torch.parallel import shard_table_data
from tabcorr_tpu_torch.parallel.dryrun import dryrun_multichip
from tabcorr_tpu_torch.utils.synthetic import (grid64_interpolator,
                                               wide_grid_interpolator)

from conftest import DATA_DIR
from test_bundle_shapes import synthetic_tabcorr
from test_torch_grid import _port_tab
from torch_parallel_workers import PACKED_GRID, WIDE_GRID, parallel_rank

B_SHARDED = 8
B_DP = 16
FILES = {"wp": "bolplanck_wp", "ds": "bolplanck_ds"}


def _zheng07_params(batch, seed):
    rng = np.random.default_rng(seed)
    return {"logMmin": 11.35 + 0.1 * rng.normal(size=batch),
            "sigma_logM": 0.25 + 0.01 * rng.normal(size=batch),
            "logM0": 11.2 + 0.1 * rng.normal(size=batch),
            "logM1": 12.4 + 0.1 * rng.normal(size=batch),
            "alpha": 0.83 + 0.02 * rng.normal(size=batch)}


def _inputs():
    rng = np.random.default_rng(3)
    odd = synthetic_tabcorr(np.random.default_rng(4), 7, 1, 5, "auto")
    grid = {k: np.asarray(v, np.float32)
            for k, v in _zheng07_params(B_DP, 5).items()}
    grid.update(alpha_c=rng.uniform(0.0, 0.4, B_DP).astype(np.float32),
                alpha_s=rng.uniform(0.8, 1.2, B_DP).astype(np.float32),
                log_eta=rng.uniform(-0.4, 0.4, B_DP).astype(np.float32))
    return dict(
        sharded_params=_zheng07_params(B_SHARDED, 1),
        loss_weights={"ngal": rng.normal(size=B_SHARDED),
                      "xi": rng.normal(size=(B_SHARDED, 19))},
        dp_params={k: np.asarray(v, np.float32)
                   for k, v in _zheng07_params(B_DP, 2).items()},
        grid_params=grid, odd=odd, odd_port=_port_tab(odd))


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    results = port_mesh.run_world(
        parallel_rank, 4, "gloo", "cpu", init_method=f"localhost:{port}",
        args=(inputs["sharded_params"], inputs["loss_weights"],
              inputs["dp_params"], inputs["grid_params"],
              inputs["odd_port"]))
    return inputs, results


def _jax_tab(name, inputs):
    if name == "odd":
        return inputs["odd"]
    return tt.TabCorr.read(DATA_DIR / "examples" / f"{FILES[name]}.hdf5")


def _port_tab_of(name, inputs):
    if name == "odd":
        return inputs["odd_port"]
    return ttt.TabCorr.read(DATA_DIR / "examples" / f"{FILES[name]}.hdf5")


def _loss_weights(inputs, n_xi):
    w = inputs["loss_weights"]
    return w["ngal"], w["xi"][:, :n_xi]


def test_initialize_multihost_joins_the_ranks_over_tcp(world):
    _, results = world
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    for r in results:
        assert r["world"] == 4 and r["backend"] == "gloo"
        assert r["again"] == 4            # idempotent
        assert all("initialized with" in e for e in r["init_errors"])


def test_mesh_construction_and_validation(world):
    _, results = world
    for r in results:
        assert r["mesh_errors"][0].startswith("table_parallel=3 must divide")
        assert "a mesh spans the world" in r["mesh_errors"][1]
        assert "table_parallel=0" in r["mesh_errors"][2]
        (s22, names, dp, tp), (s14, _, dp4, tp4) = r["mesh_shapes"]
        assert s22 == (2, 2) and s14 == (1, 4) and names == ("dp", "tp")
        assert (dp, tp) == divmod(r["rank"], 2)
        assert (dp4, tp4) == (0, r["rank"])
    # The same validation as tabcorr_tpu's make_mesh.
    with pytest.raises(ValueError):
        jax_make_mesh(8, table_parallel=3)


@pytest.mark.parametrize("n_shards", [2, 4, 7])
@pytest.mark.parametrize("name", ["wp", "ds", "odd"])
def test_shard_table_data_pads_as_tabcorr_tpu(name, n_shards):
    inputs = {"odd": synthetic_tabcorr(np.random.default_rng(4), 7, 1, 5,
                                       "auto")}
    inputs["odd_port"] = _port_tab(inputs["odd"])
    want = jax_shard_table(_jax_tab(name, inputs).table_data(
        dtype=jnp.float32), n_shards)
    got = shard_table_data(_port_tab_of(name, inputs).table_data(
        device="cpu"), n_shards)
    assert got.n_bins % n_shards == 0 and got.n_bins == want.n_bins
    for field in ("tpcf_dense", "n_h", "log_prim_quad", "quad_weight",
                  "sec_perc", "log_prim_quad_lo"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert (got.mode, got.n_centrals, got.tpcf_shape) == (
        want.mode, want.n_centrals, tuple(want.tpcf_shape))


def _jax_sharded(name, inputs, tp):
    tab = _jax_tab(name, inputs)
    model = tt.Zheng07Model(threshold=-18, redshift=0.0)
    mesh = jax_make_mesh(4, table_parallel=tp, devices=jax.devices()[:4])
    f, _ = jax_sharded(mesh, tab.table_data(dtype=jnp.float64),
                       *occupation_functions(model))
    params = {k: jnp.asarray(v) for k, v in inputs["sharded_params"].items()}
    a, w = _loss_weights(inputs, int(np.prod(tab.tpcf_shape)))

    def loss(p):
        ngal, xi = f(p)
        return jnp.sum(ngal * a) + jnp.sum(xi * w)

    ngal, xi = f(params)
    return np.asarray(ngal), np.asarray(xi), {
        k: np.asarray(v) for k, v in jax.grad(loss)(params).items()}


def _port_unsharded(name, inputs):
    tab = _port_tab_of(name, inputs)
    model = ttt.Zheng07Model(threshold=-18, redshift=0.0)
    f = ttt.make_predictor(tab, model, dtype=torch.float64, engine="plain",
                           device="cpu")
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in inputs["sharded_params"].items()}
    ngal, xi = f(params)
    xi = xi.reshape(len(ngal), -1)
    a, w = _loss_weights(inputs, xi.shape[1])
    ((ngal * torch.tensor(a)).sum() + (xi * torch.tensor(w)).sum()
     ).backward()
    return ngal.detach().numpy(), xi.detach().numpy(), {
        k: v.grad.numpy() for k, v in params.items()}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(want)))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["wp", "ds", "odd"])
def test_sharded_predict_matches_tabcorr_tpu_and_unsharded(world, name, tp):
    inputs, results = world
    want_jax = _jax_sharded(name, inputs, tp)
    want_port = _port_unsharded(name, inputs)
    for r in results:
        got = r["sharded"][tp, name]
        assert got["n_bins"] % tp == 0
        for want in (want_jax, want_port):
            _close(got["ngal"], want[0])
            _close(got["xi"], want[1])
            for k, g in want[2].items():
                _close(got["grad_" + k], g)
    # Each rank's gradient touches its own dp rows only.
    for r in results:
        dp = r["rank"] // tp
        rows = B_SHARDED // (4 // tp)
        assert r["sharded"][tp, name]["nonzero_grad_rows"] == list(
            range(dp * rows, (dp + 1) * rows))


def _scaled(got, want):
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    return float(np.max(np.max(np.abs(got - want), axis=1) /
                        np.max(np.abs(want), axis=1)))


def _unsharded_dp(name, inputs):
    tabs = {k: ttt.TabCorr.read(DATA_DIR / "examples" / f"{f}.hdf5")
            for k, f in (("wp", "bolplanck_wp"), ("ds", "bolplanck_ds"),
                         ("xi", "synthetic_xi_ell"))}
    model = ttt.Zheng07Model(threshold=-18,
                             redshift=tabs["wp"].attrs["redshift"])
    p32 = {k: torch.tensor(v) for k, v in inputs["dp_params"].items()}
    if name == "bundle":
        return ttt.make_multi_predictor(
            [tabs["wp"], tabs["xi"]], model, device="cpu", engine="bundle",
            accuracy=("elementwise", "scaled"))(p32)
    if name == "members":
        return ttt.make_multi_predictor([tabs["wp"], tabs["ds"]], model,
                                        device="cpu", engine="auto")(p32)
    make_interp, kw = {"packed": (grid64_interpolator, PACKED_GRID),
                   "slab": (wide_grid_interpolator, WIDE_GRID)}[name]
    f = ttt.make_predictor(make_interp(**kw),
                           ttt.Zheng07Model(threshold=-20, redshift=0.0),
                           engine="fused", accuracy="scaled", device="cpu")
    return [f({k: torch.tensor(v) for k, v in inputs["grid_params"].items()})]


@pytest.mark.parametrize("name", ["bundle", "members", "packed", "slab"])
def test_dp_sharded_predictors_match_unsharded_without_collectives(
        world, name):
    inputs, results = world
    want = _unsharded_dp(name, inputs)
    for r in results:
        assert r["dp_calls"][name] == []
        assert r["dp_rows"][name] == B_DP // 4
        got = r["dp"][name]
        got = got if name in ("bundle", "members") else [got]
        assert len(got) == len(want)
        for (ng, xi), (ng_w, xi_w) in zip(got, want):
            ng_w, xi_w = ng_w.numpy(), xi_w.numpy()
            assert xi.shape == xi_w.shape
            finite = np.isfinite(ng_w)
            np.testing.assert_array_equal(np.isfinite(ng), finite)
            np.testing.assert_allclose(ng[finite], ng_w[finite], rtol=1e-6)
            assert _scaled(xi[finite], xi_w[finite]) <= 2e-6


def test_mesh_arguments_are_refused_where_no_rank_rows_exist(world):
    _, results = world
    for r in results:
        batch, tabcorr, plain = r["dp_errors"]
        assert "must divide by the 'dp' axis size (4)" in batch
        assert "for a TabCorr use make_multi_predictor" in tabcorr
        assert "float32 fused Interpolator path" in plain


def test_batch_sharding_outside_a_world_is_arithmetic():
    class Mesh:
        mesh_dim_names = ("dp", "tp")

        def size(self, dim):
            return (4, 2)[dim]

        def get_local_rank(self, name):
            return {"dp": 3, "tp": 1}[name]

    assert port_mesh.batch_sharding(Mesh(), 16) == slice(12, 16)
    assert port_mesh.replicated_sharding(Mesh(), 16) == slice(0, 16)
    with pytest.raises(ValueError):
        port_mesh.batch_sharding(Mesh(), 18)
    params = {"a": torch.arange(16.0)}
    assert port_mesh.shard_params(params, Mesh())["a"].tolist() == [
        12.0, 13.0, 14.0, 15.0]


def test_dryrun_multichip_passes_on_four_ranks():
    report = dryrun_multichip(4, device="cpu")
    assert [r["tp_degrees"] for r in report] == [[1, 2, 4]] * 4
    assert all(r["grad_finite"] for r in report)
