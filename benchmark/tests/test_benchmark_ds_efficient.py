"""CPU tests of the ds_efficient cell (the decorated Leauthaud11 HOD on
TabCorr's 'efficient' Delta Sigma grid): a whole run at 64 walkers, the
controls and planted faults it must catch, its three readers by hand on a
made-up traced run, and ``family_work``'s counts by hand.  The CPU runs
are of the fused engine's CPU version, held to the configuration's
``cpu_version_limits``.

Run from the root of the checkout:
``python -m pytest -q -p no:cacheprovider benchmark/tests``.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run  # noqa: E402
from benchlib import faults, family_work, manifest, roofline  # noqa: E402
from benchlib import window  # noqa: E402
from benchlib.cell import Run  # noqa: E402
from tabcorr_tpu_torch.utils import profiling  # noqa: E402

CELL = "ds_efficient.walkers262k"
NEW = ("occupation_kernel_roofline", "step_mfu_cross",
       "occupation.ns_per_abscissa", "grid_kernel_cross_roofline")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
T0 = 1_790_000_000_000_000_000   # the slice's start on the wall clock, ns
KERNEL = "void (anonymous namespace)::occupation_kernel<0, true>(OccArgs)"
GRID = "void (anonymous namespace)::grid_kernel<64, false, 2>(GridArgs)"


@pytest.fixture(autouse=True)
def cpu_version_limits(monkeypatch):
    """The runs here are of the fused engine's CPU version: the card's
    limits with the configuration's ``cpu_version_limits`` in their place
    (that version evaluates the occupation in float32, the kernel in
    float64)."""
    config = manifest.Manifest.config

    def on_the_cpu(self, name):
        cfg = config(self, name)
        cfg["limits"].update((k, v) for k, v in
                             cfg.get("cpu_version_limits", {}).items()
                             if k in cfg["limits"])
        return cfg

    monkeypatch.setattr(manifest.Manifest, "config", on_the_cpu)


def one_run(seed=2 ** 31 + 5, trace=0, **kwargs):
    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds",
                      "0.3", "--trace", str(trace)])
    return run.run(args, "cpu", walkers=64, **kwargs)


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 40 + 7])
def test_a_sound_run_of_the_cell_is_correct(seed):
    line, checks = one_run(seed)
    assert line["correct"], checks
    assert [c[0] for c in checks] == ["ngal_rel_err", "ds_rel_err",
                                      "nan_rows_mismatch", "logpost_err",
                                      "walker_err", "accept_flips"]
    assert set(line["metrics"]) == {"walker_steps_per_s", "step_ms_p95",
                                    "setup_s"}


@pytest.mark.parametrize("kwargs", [
    dict(step_wrap=faults.stale), dict(predictor_wrap=faults.half_batch),
    dict(predictor_wrap=faults.altered), dict(control="tf32"),
    dict(control="bf16")], ids=["stale", "half", "alter", "tf32", "bf16"])
def test_a_fault_or_a_lower_precision_is_not_correct(kwargs):
    line, checks = one_run(**kwargs)
    assert not line["correct"], checks


def test_a_port_that_predicts_outside_the_domain_is_refused(monkeypatch):
    # A port older than the domain: the central scatter taken as given.
    from tabcorr_tpu_torch.models import leauthaud11
    monkeypatch.setattr(leauthaud11, "positive", lambda scatter: scatter)
    with pytest.raises(SystemExit, match="central scatter below zero"):
        one_run()


def test_a_traced_run_of_the_cell_reports_its_readers_or_leaves_them_out():
    line, _ = one_run(31, trace=1)
    assert line["correct"] is True
    entries = {m["name"] for m in manifest.Manifest().cell(CELL).per_layer}
    assert set(NEW) <= entries
    assert set(line["metrics"]) <= entries
    # No device on the CPU: the device readers find nothing to read.
    for name in ("occupation_kernel_roofline", "occupation.ns_per_abscissa",
                 "grid_kernel_cross_roofline"):
        assert name not in line["metrics"]


def test_the_new_entries_are_as_the_cell_needs_them():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == [CELL]
        assert m["moves"] == "walker_steps_per_s"
    for name in ("occupation_kernel_roofline", "step_mfu_cross",
                 "grid_kernel_cross_roofline"):
        assert entries[name]["unit"] == "%"
    # The auto-mode shares would count a cross row ~460x too high.
    for name in ("step_mfu", "grid_kernel_roofline",
                 "bundle_kernel_roofline"):
        assert CELL not in entries[name]["workloads"]


# ---- family_work's counts, by hand ------------------------------------------
def test_the_cell_shapes_come_from_its_table_file():
    for name in ("occupation_kernel_roofline", "step_mfu_cross",
                 "grid_kernel_cross_roofline"):
        assert family_work.cell_shapes(name) == dict(
            n_bins=1104, n_gauss=10, n_params=18, n_nodes=4, n_xi=13)


def test_the_counts_for_ds_efficient_by_hand():
    # The quadrature: 2 x 1104 bins x 10 nodes = 22,080 a row.
    assert family_work.occupation_flop(131072, 1104, 10) == 131072 * 22080
    # 18 parameters and 1104 densities a row, 3 x 11,040 node floats.
    assert family_work.occupation_bytes(131072, 1104, 10, 18) == 4 * (
        131072 * 18 + 33120 + 131072 * 1104) == 588_383_616
    # 22,080 + 1,104 (sum n) + 2 x 4 x 13 x 1,105 = 138,104 a row; the
    # chi^2 of 13 points 2 x 169 + 39 = 377.
    assert family_work.cross_contraction_flop(1104, 4, 13) == 116024
    assert family_work.cross_grid_row_flop(1104, 10, 4, 13) == 138104
    # The densities, 4 matrices of 13 x 1104, 4 node weights and 14
    # outputs a row.
    assert family_work.cross_contraction_bytes(131072, 1104, 4, 13) == 4 * (
        131072 * 1104 + 57408 + 131072 * 18) == 588_480_768
    assert family_work.cross_grid_step_flop(262144, 1104, 10, 4, 13) == \
        262144 * 138481
    # roofline.grid_flop counts the row as an auto grid: ~460x as much.
    auto = roofline.grid_flop(1104, 10, 4, 13)
    assert 450 < auto / 138104 < 470


# ---- the readers over a made-up traced run ----------------------------------
def _span(sid, parent, name, start, end, **counts):
    return SimpleNamespace(id=sid, parent=parent, name=name,
                           start_ns=T0 + start, end_ns=T0 + end,
                           counts=counts)


SPANS = [
    _span(1, None, "predictor", 0, 400, rows=131072),
    _span(2, 1, "fused.occupation_launch", 10, 40, rows=131072,
          abscissae=2800),
    _span(3, 1, "fused.grid_launch", 50, 60),
    _span(4, None, "predictor", 500, 900, rows=131072),
    _span(5, 4, "fused.occupation_launch", 510, 540, rows=131072,
          abscissae=2800),
    _span(6, 4, "fused.grid_launch", 550, 560),
]


def _run(kernels):
    # One traced step, the profiler's stop (9 ms), then three of 30 ms.
    win = window.Window(seconds=2.0, steps=5,
                        step_ms=[30.0, 9.0, 30.0, 30.0, 30.0],
                        accepts=np.full(5, 0.3), traced_steps=(0, 1))
    return Run(window=win, spans=[], kernels=kernels,
               trace_window_ns=(T0, T0 + 10 ** 9), call_rows=131072)


def _read(name, run_):
    return manifest.load("metrics", name).read(run_)


def test_each_new_reader_by_hand(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: list(SPANS))
    kernels = [(KERNEL, T0 + 100, 12_000_000), (GRID, T0 + 200, 500_000),
               (KERNEL, T0 + 600, 11_000_000), (GRID, T0 + 700, 300_000)]
    run_ = _run(kernels)
    # Bytes bound: 588,383,616 B at 3.35 TB/s over the mean 11.5 ms.
    assert _read("occupation_kernel_roofline", run_) == pytest.approx(
        100 * 588_383_616 / 3.35e12 / 11.5e-3)
    # 262,144 x 138,481 FLOP over the mean untraced step, 30 ms.
    assert _read("step_mfu_cross", run_) == pytest.approx(
        100 * 262144 * 138481 / 30e-3 / 989e12)
    # Bytes bound: 588,480,768 B at 3.35 TB/s over the mean 0.4 ms.
    assert _read("grid_kernel_cross_roofline", run_) == pytest.approx(
        100 * 588_480_768 / 3.35e12 / 0.4e-3)
    # 23 ms of the kernel over 2 x 131,072 x 2,800 abscissae.
    assert _read("occupation.ns_per_abscissa", run_) == pytest.approx(
        23e6 / (2 * 131072 * 2800))


def test_the_readers_find_nothing_where_there_is_nothing(monkeypatch):
    # No occupation kernel in the trace (a zheng07 cell, or the CPU).
    monkeypatch.setattr(profiling, "recorded", lambda: list(SPANS))
    bare = _run([(GRID, T0 + 200, 500_000)])
    assert _read("occupation_kernel_roofline", bare) is None
    assert _read("occupation.ns_per_abscissa", bare) is None
    # A port whose occupation spans carry no counts (one older than
    # them), or that records no spans at all.
    monkeypatch.setattr(profiling, "recorded", lambda: [
        _span(s.id, s.parent, s.name, s.start_ns - T0, s.end_ns - T0)
        for s in SPANS])
    traced = _run([(KERNEL, T0 + 100, 12_000_000)])
    assert _read("occupation.ns_per_abscissa", traced) is None
    assert _read("grid_kernel_cross_roofline", traced) is None
    monkeypatch.delattr(profiling, "recorded")
    assert _read("occupation.ns_per_abscissa", traced) is None
    assert _read("occupation_kernel_roofline", traced) is not None
    # No step after the profiled slice.
    traced.window.step_ms = traced.window.step_ms[:2]
    assert _read("step_mfu_cross", traced) is None
