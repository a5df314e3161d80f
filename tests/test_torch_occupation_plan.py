"""The occupation kernel's node plan on the CPU (ops/fused.py:
``OccupationPlan``, ``occupation_plan``; csrc/occupation.cu walks it).

The plan groups each table's (bin, node) abscissae -- the exact (float32
node, float32 residual) pairs -- into units of distinct mass bins and
lists the output bins each unit serves.  Here: every (table, bin, node)
abscissa comes back bit for bit from its unit, on the tables chip_smoke.py
drives; the distinct counts; a float64 emulation of the kernel's unit walk
(evaluate each unit's nodes once, gather, decorate, sum in node order)
against the port's float64 tensor path at 1e-12 for every family case of
the CUDA tests, and against tabcorr_tpu's float64 host path at the models'
values; the bundle's one-launch bookkeeping; the wrapper's refusals that
need no card.
"""

import copy
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
from tabcorr_tpu_torch import Interpolator, TabCorr
from tabcorr_tpu_torch.models.assembias import (ASSEMBIAS_PARAMS,
                                                heaviside_assembias)
from tabcorr_tpu_torch.models.protocol import CENTRALS, SATELLITES
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.predictor import stacked_grid
from tabcorr_tpu_torch.utils.synthetic import (grid64_interpolator,
                                               wide_grid_interpolator)

from conftest import DATA_DIR
from test_torch_kernel import (OCCUPATION_KINDS, _occupation_model,
                               _occupation_params)

DATA = Path(__file__).absolute().parents[1] / "tabcorr_tpu_torch" / "data"

# (bin, node) evaluations without the plan, and distinct abscissae.
COUNTS = {"wp": (600, 300), "xi_ell": (1200, 300), "bundle": (1800, 600),
          "ds_efficient": (11040, 2800), "grid64": (600, 300),
          "wide grid": (1600, 400)}


@functools.cache
def _tables():
    return [TabCorr.read(DATA / f).table_data(device="cpu")
            for f in ("bolplanck_wp.npz", "synthetic_xi_ell.npz")]


@functools.cache
def _consts(name):
    """The constants the card's route of ``name`` builds, on the CPU."""
    if name == "xi_ell twice":
        return _consts("xi_ell") * 2
    if name in ("wp", "xi_ell", "bundle"):
        tables = {"wp": _tables()[:1], "xi_ell": _tables()[1:],
                  "bundle": _tables()}[name]
        return tuple(fused.slab_tc_table_constants(t, 1) for t in tables)
    if name == "ds_efficient":
        stacked, n_nodes, _ = stacked_grid(
            Interpolator.read(DATA / "ds_efficient.npz"), device="cpu")
        return (fused.grid_table_constants(stacked, n_nodes),)
    if name == "grid64":
        stacked, n_nodes, _ = stacked_grid(grid64_interpolator(),
                                           device="cpu")
        return (fused.grid_table_constants(stacked, n_nodes),)
    stacked, n_nodes, _ = stacked_grid(wide_grid_interpolator(),
                                       device="cpu")
    return (fused.slab_tc_table_constants(stacked, n_nodes),)


@pytest.mark.parametrize("name", list(COUNTS) + ["xi_ell twice"])
def test_plan_gives_back_every_abscissa_bit_for_bit(name):
    consts = _consts(name)
    plan = fused.occupation_plan(consts)
    assert plan.built_from(consts)
    first = plan.first_out.numpy()
    assert first[0] == 0 and first[-1] == plan.n_out
    assert np.all(np.diff(first) >= 1)
    assert np.all(np.diff(first) <= fused._OCC_MAX_OUTS)
    unit_of = np.repeat(np.arange(plan.n_units), np.diff(first))
    node, res = plan.node.numpy(), plan.res.numpy()
    # Units ascend in the float64 abscissa of their first node.
    first_y = node[:, 0].astype(np.float64) + res[:, 0].astype(np.float64)
    assert np.all(np.diff(first_y) >= 0.0)
    seen = set()
    for o in range(plan.n_out):
        t, i = int(plan.out_table[o]), int(plan.out_bin[o])
        c, u = consts[t], unit_of[o]
        assert (t, i) not in seen
        seen.add((t, i))
        np.testing.assert_array_equal(node[u].view(np.uint32),
                                      c.logm[i].numpy().view(np.uint32))
        np.testing.assert_array_equal(res[u].view(np.uint32),
                                      c.logm_res[i].numpy().view(np.uint32))
        np.testing.assert_array_equal(
            plan.weight[o].numpy().view(np.uint32),
            c.weight[i].numpy().view(np.uint32))
        assert plan.out_sec[o] == c.sec[i, 0]
    assert seen == {(t, i) for t, c in enumerate(consts)
                    for i in range(c.n_bins)}
    assert plan.n_bins == tuple(c.n_bins for c in consts)
    assert plan.n_centrals == tuple(c.n_centrals for c in consts)


@pytest.mark.parametrize("name", list(COUNTS))
def test_plan_evaluates_each_distinct_abscissa_once(name):
    plan = fused.occupation_plan(_consts(name))
    evaluated, distinct = COUNTS[name]
    assert plan.n_evaluated == evaluated
    assert plan.n_distinct == distinct
    pairs = np.stack([plan.node.numpy().view(np.uint32),
                      plan.res.numpy().view(np.uint32)], axis=-1)
    assert len(np.unique(pairs.reshape(-1, 2), axis=0)) == distinct


def _unit_walk(plan, model, fam, params, weights):
    """csrc/occupation.cu's walk over ``plan`` in float64: per unit the
    base occupations at its nodes (the centrals where an output or the
    satellites' modulation reads them, the satellites where an output
    reads them, modulated by that central value), then every output bin
    of the unit decorated and summed in node order.  ``weights[t]`` are
    table t's (n_bins, n_gauss) quad_weight * n_h.  What the kernel does
    not evaluate is NaN here, so a read of it shows."""
    p = {k: v[:, None] for k, v in params.items()}
    base = {k: (torch.zeros_like(v) if k in ASSEMBIAS_PARAMS else v)
            for k, v in p.items()}
    unmodulated = copy.copy(model)
    if fam.modulate:
        unmodulated.modulate_with_cenocc = False
    sec = torch.tensor(0.5, dtype=torch.float64)
    batch = next(iter(params.values())).shape[0]
    dens = [torch.full((nb, batch), torch.nan, dtype=torch.float64)
            for nb in plan.n_bins]
    first = plan.first_out.tolist()
    for u in range(plan.n_units):
        y = plan.node[u].double() + plan.res[u].double()
        outs = [(o, int(plan.out_table[o]), int(plan.out_bin[o]))
                for o in range(first[u], first[u + 1])]
        central = [i < plan.n_centrals[t] for _, t, i in outs]
        cen = sat = torch.full((batch, y.shape[0]), torch.nan,
                               dtype=torch.float64)
        if any(central) or (not all(central) and fam.modulate):
            cen = model.occupation(base, CENTRALS, y, sec)
        if not all(central):
            sat = (unmodulated.occupation(base, SATELLITES, y, sec) * cen
                   if fam.modulate else
                   model.occupation(base, SATELLITES, y, sec))
        ceiling = (model._central_ceiling(p, y)
                   if fam.decorated and fam.family == 2 and fam.sfr else 1.0)
        for (o, t, i), is_cen in zip(outs, central):
            occ = cen if is_cen else sat
            if fam.decorated:
                occ = heaviside_assembias(
                    occ, p[ASSEMBIAS_PARAMS[0 if is_cen else 1]],
                    plan.out_sec[o].double(), split=fam.split,
                    lower_bound=0.0, upper_bound=ceiling if is_cen else None)
            acc = torch.zeros(batch, dtype=torch.float64)
            for g in range(y.shape[0]):
                acc = acc + occ[:, g] * weights[t][i, g]
            dens[t][i] = acc
    return dens


def _float64_tables(consts):
    """The bundle's tables in float64 at the plan's abscissae (float32 node
    + float32 residual, exactly), and their quad_weight * n_h."""
    tables = [TabCorr.read(DATA / f).table_data(device="cpu",
                                                dtype=torch.float64)
              for f in ("bolplanck_wp.npz", "synthetic_xi_ell.npz")]
    tables = [dataclasses.replace(
        t, log_prim_quad=c.logm.double() + c.logm_res.double(),
        log_prim_quad_lo=None) for t, c in zip(tables, consts)]
    return tables, [t.quad_weight * t.n_h[:, None] for t in tables]


@pytest.mark.parametrize("kind", OCCUPATION_KINDS)
def test_unit_walk_matches_the_float64_path(kind):
    """The walk over the bundle's plan (wp + xi_ell, one launch) against
    occupation_density in float64, each table, every row: 1e-12
    relative."""
    consts = _consts("bundle")
    plan = fused.occupation_plan(consts)
    model = _occupation_model(kind)
    fam = fused.OccupationFamily.of(model)
    params = {k: v.double() for k, v in
              _occupation_params(model, 24, 11, "cpu").items()}
    tables64, weights = _float64_tables(consts)
    got = _unit_walk(plan, model, fam, params, weights)
    for dens, table in zip(got, tables64):
        want = fused.occupation_density(table, model, params)
        assert bool(torch.isfinite(dens).all())
        assert bool(((dens.t() - want).abs() <= 1e-12 * want.abs()).all())


@pytest.mark.parametrize("kind", OCCUPATION_KINDS)
def test_unit_walk_matches_tabcorr_tpu_at_the_models_values(kind):
    """ngal of the walk over wp's plan at the model's values against
    tabcorr_tpu's float64 host prediction: 1e-9 relative, the two
    packages' float64 agreement on the occupations."""
    consts = _consts("wp")
    plan = fused.occupation_plan(consts)
    model = _occupation_model(kind)
    jax_model = _occupation_model(kind, package=tt)
    fam = fused.OccupationFamily.of(model)
    params = {k: v[:1].double() for k, v in
              _occupation_params(model, 1, 11, "cpu").items()}
    # The values the walk takes (float32, as every batch row).
    jax_model.param_dict.update({k: float(v[0]) for k, v in params.items()})
    _, weights = _float64_tables(_consts("bundle"))
    ngal = float(_unit_walk(plan, model, fam, params, weights[:1])[0].sum())
    want = tt.TabCorr.read(DATA_DIR / "examples" / "bolplanck_wp.hdf5"
                           ).predict(jax_model, check_consistency=False)[0]
    assert ngal == pytest.approx(float(want), rel=1e-9)


def test_bundle_plan_serves_each_table_in_one_launch():
    """One plan for both tables: the outputs each table's launch writes,
    in the shapes the wrapper allocates, and no node shared between wp and
    xi_ell."""
    consts = _consts("bundle")
    plan = fused.occupation_plan(consts)
    assert plan.n_bins == (60, 120) and plan.n_centrals == (30, 60)
    tables = plan.out_table.numpy()
    assert np.bincount(tables).tolist() == [60, 120]
    first = plan.first_out.numpy()
    for u in range(plan.n_units):
        assert len(set(tables[first[u]:first[u + 1]])) == 1
    singles = [fused.occupation_plan([c]) for c in consts]
    assert plan.n_units == sum(s.n_units for s in singles)
    assert [tuple(d.shape) for d in fused.occupation_outputs(
        plan, 7, True, torch.device("cpu"))] == [(60, 7), (120, 7)]
    assert [tuple(d.shape) for d in fused.occupation_outputs(
        plan, 7, False, torch.device("cpu"))] == [(7, 60), (7, 120)]


def test_plan_splits_a_mass_bin_read_by_more_bins_than_a_unit_holds():
    """xi_ell twice: each mass bin is read by 8 output bins (two tables x
    central and satellite x above and below the split), so it becomes two
    units of 4 (the kernel's most), each node then evaluated twice; the
    walk over that plan still gives every table's float64 densities."""
    consts = _consts("xi_ell twice")
    plan = fused.occupation_plan(consts)
    assert fused._OCC_MAX_OUTS == 4
    assert (plan.n_units, plan.max_outs, plan.n_distinct) == (60, 4, 600)
    assert np.all(np.diff(plan.first_out.numpy()) == 4)
    model = _occupation_model("assembias_zu15")
    fam = fused.OccupationFamily.of(model)
    params = {k: v.double() for k, v in
              _occupation_params(model, 8, 12, "cpu").items()}
    tables, weights = _float64_tables(_consts("bundle"))
    want = fused.occupation_density(tables[1], model, params)
    for dens in _unit_walk(plan, model, fam, params, weights[1:] * 2):
        assert bool(((dens.t() - want).abs() <= 1e-12 * want.abs()).all())


def test_plan_is_built_once_per_constants():
    c = _consts("grid64")[0]
    assert c.occupation_plan is c.occupation_plan
    assert c.occupation_plan.built_from([c])
    assert not c.occupation_plan.built_from(list(_consts("wp")))
    both = fused.occupation_plan(_consts("bundle"))
    assert not both.built_from(list(reversed(_consts("bundle"))))


def test_occupation_wrapper_refuses_a_plan_of_other_constants():
    fam = fused.OccupationFamily.of(_occupation_model("leauthaud11"))
    cols = torch.ones((16, 8))
    plan = fused.occupation_plan(_consts("wp"))
    with pytest.raises(ValueError, match="node plan was not built"):
        fused.occupation_launch(plan, fam, cols, consts=_consts("xi_ell"))
    with pytest.raises(ValueError, match="reads a node plan"):
        fused.occupation_launch(_consts("wp")[0], fam, cols)
    with pytest.raises(ValueError, match="1 to 4 tables"):
        fused.occupation_plan(_consts("bundle") * 3)


@pytest.mark.parametrize("n_units,batch", [(280, 262144), (60, 262144),
                                           (40, 32768), (30, 4133), (1, 1),
                                           (2800, 13), (300, 2 ** 22)])
def test_units_per_block_cover_the_plan(n_units, batch):
    per_block = fused.occupation_units_per_block(n_units, batch)
    row_blocks = -(-batch // fused._OCC_ROWS)
    unit_blocks = -(-n_units // per_block)
    assert 1 <= per_block <= n_units
    assert unit_blocks <= 65535
    assert (unit_blocks - 1) * per_block < n_units
    # Enough blocks to fill the card where the units allow it.
    assert (row_blocks * unit_blocks >= fused._OCC_TARGET_BLOCKS or
            per_block == 1)
