"""CPU tests of the readers of the port's own spans: each value by hand
from made-up kernels and spans, the idle split against ``device.idle_pct``,
and None where the port recorded nothing.

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

from benchlib import manifest, program_spans, window  # noqa: E402
from benchlib.cell import Run  # noqa: E402
from tabcorr_tpu_torch.utils import profiling  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("logpost.syncs_per_call", "device.idle_in_logpost_pct",
       "device.idle_in_predictor_pct", "device.idle_in_sampler_pct",
       "predictor.launch_us_per_call", "predictor.node_weights_us_per_call")
T0 = 1_790_000_000_000_000_000   # the slice's start on the wall clock, ns


def _span(sid, parent, name, start, end, **counts):
    return SimpleNamespace(id=sid, parent=parent, name=name,
                           start_ns=T0 + start, end_ns=T0 + end,
                           counts=counts)


# Two steps of one grid configuration in a slice of [0, 1000) ns; before it
# a span of the profiler's warm-up, which no reader counts.
SPANS = [
    _span(1, None, "sampler.step", -500, -100),
    _span(2, None, "sampler.step", 0, 480),
    _span(3, 2, "logpost", 40, 300),
    _span(4, 3, "logpost.params", 40, 100, syncs=8),
    _span(5, 3, "predictor", 100, 260, rows=4),
    _span(6, 5, "predictor.node_weights", 110, 150),
    _span(7, 5, "fused.grid_launch", 150, 170),
    _span(8, 2, "logpost", 320, 460),
    _span(9, 8, "logpost.params", 320, 360, syncs=8),
    _span(10, 8, "predictor", 360, 440, rows=4),
    _span(11, 10, "predictor.node_weights", 370, 390),
    _span(12, 10, "fused.grid_launch", 390, 400),
    _span(13, None, "sampler.step", 500, 900),
]
# Device busy in [60, 90), [170, 330), [400, 700): idle [0, 60), [90, 170),
# [330, 400), [700, 1000), 510 ns of 1000.
KERNELS = [("Memcpy HtoD (Pageable -> Device)", T0 + 60, 30),
           ("void grid_kernel<64, true, 0>(A)", T0 + 170, 160),
           ("void grid_kernel<64, true, 0>(A)", T0 + 400, 300)]


def _run(kernels=KERNELS):
    win = window.Window(seconds=1.0, steps=2, step_ms=[1.0, 1.0],
                        accepts=np.full(2, 0.3), traced_steps=(0, 2))
    return Run(window=win, spans=[], kernels=kernels,
               trace_window_ns=(T0, T0 + 1000))


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: list(SPANS))


def _read(name, run_):
    return manifest.load("metrics", name).read(run_)


def test_each_new_reader_by_hand(recorded):
    run_ = _run()
    # Two logpost calls, 8 syncs under each.
    assert _read("logpost.syncs_per_call", run_) == 8.0
    # Idle ns by the innermost layer open on the host:
    #   sampler.step: [0, 40) 40, [300, 320) and [460, 480) busy,
    #     [500, 900) 200 ([700, 900)) = 240;
    #   logpost: [40, 100) 20 + 10 ([40, 60), [90, 100)), [260, 300) busy,
    #     [320, 360) 30 ([330, 360)), [440, 460) busy = 60;
    #   predictor: [100, 260) 70 ([100, 170)), [360, 440) 40 = 110.
    assert _read("device.idle_in_sampler_pct", run_) == pytest.approx(24.0)
    assert _read("device.idle_in_logpost_pct", run_) == pytest.approx(6.0)
    assert _read("device.idle_in_predictor_pct", run_) == pytest.approx(
        11.0)
    # Two predictor calls: launches 20 + 10 ns, node weights 40 + 20 ns.
    assert _read("predictor.launch_us_per_call", run_) == pytest.approx(
        0.015)
    assert _read("predictor.node_weights_us_per_call",
                 run_) == pytest.approx(0.03)


def test_the_idle_split_adds_up_to_the_idle_share(recorded):
    run_ = _run()
    idle = program_spans.idle_by_layer(run_)
    # Outside every span: [480, 500), busy, and [900, 1000), idle.
    assert idle[None] == 100
    assert sum(idle.values()) == 510
    shares = [_read(f"device.idle_in_{k}_pct", run_)
              for k in ("logpost", "predictor", "sampler")]
    assert sum(shares) + 100.0 * idle[None] / 1000 == pytest.approx(
        _read("device.idle_pct", run_), abs=1e-9)


def test_a_joint_predictor_counts_once_with_its_members(monkeypatch):
    spans = [_span(1, None, "predictor", 0, 100, rows=4),
             _span(2, 1, "predictor", 10, 40, rows=4),
             _span(3, 2, "fused.contraction_launch", 20, 30),
             _span(4, 1, "predictor", 50, 90, rows=4),
             _span(5, 4, "fused.grid_launch", 60, 80)]
    monkeypatch.setattr(profiling, "recorded", lambda: spans)
    run_ = _run()
    assert [s.id for s in program_spans.calls(spans, "predictor")] == [1]
    assert _read("predictor.launch_us_per_call", run_) == pytest.approx(
        0.03)
    assert program_spans.innermost(spans) == [
        ("predictor", T0 + 0, T0 + 10), ("predictor", T0 + 10, T0 + 40),
        ("predictor", T0 + 40, T0 + 50), ("predictor", T0 + 50, T0 + 90),
        ("predictor", T0 + 90, T0 + 100)]


def test_every_new_reader_finds_nothing_on_the_harness_run():
    """The made-up traced run of test_benchmark_harness.py: the
    benchmark's spans, no program spans in its slice."""
    win = window.Window(seconds=2.0, steps=5,
                        step_ms=[5.0, 9.0, 1.0, 2.0, 3.0],
                        accepts=np.full(5, 0.3), traced_steps=(0, 1))
    records = [("sampler", 0, 1000), ("logpost", 100, 600),
               ("predictor", 200, 400), ("sampler", 2000, 2600),
               ("logpost", 2100, 2400), ("predictor", 2150, 2250)]
    kernels = [("void (anonymous namespace)::grid_kernel<64, true, 0>(A)",
                100, 500), ("Memcpy HtoD (Pageable -> Device)", 700, 100)]
    run_ = Run(window=win, spans=records, kernels=kernels,
               trace_window_ns=(0, 1000), call_rows=4,
               call_work=lambda rows: (rows * 989e3, 0), step_flop=8 * 989e6)
    for name in NEW:
        assert _read(name, run_) is None


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_a_trace_or_without_spans(
        name, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: [])
    assert _read(name, _run()) is None
    monkeypatch.setattr(profiling, "recorded", lambda: list(SPANS))
    untraced = _run()
    untraced.trace_window_ns = None
    assert _read(name, untraced) is None
    # A port older than its spans has no recorder at all.
    monkeypatch.delattr(profiling, "recorded")
    assert _read(name, _run()) is None


def test_the_new_metrics_are_in_the_manifest_as_asked():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    both = ["wp_xiell.walkers262k", "grid64.walkers262k"]
    for name in NEW:
        m = entries[name]
        assert m["moves"] == "walker_steps_per_s" and m["better"] == "lower"
        assert m["workloads"] == (["grid64.walkers262k"] if "node_weights"
                                  in name else both)
        assert m["source"] == ("program_counter" if "syncs" in name
                               else "program_span")
    assert list(entries)[-len(NEW):] == list(NEW)
