"""``correct`` comes out false when the timed path is broken underneath,
and when a lower precision takes the program's place.

Each test drives a whole run past the look for a card (on the CPU, at a
size a test run holds: 64 walkers, a short window) with one fault planted
from ``benchlib.faults``, or with a control.  The card's test runs the
controls at a larger size on the chip; it skips without one.
"""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run  # noqa: E402
from benchlib import faults  # noqa: E402

CELLS = ["wp_xiell.walkers262k", "grid64.walkers262k"]


def one_run(cell, device="cpu", walkers=64, seconds=0.3, seed=2 ** 31 + 5,
            **kwargs):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", "0"])
    line, checks = run.run(args, device, walkers=walkers, **kwargs)
    return line["correct"], {name: value for name, value, _ in checks}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    correct, numbers = one_run(cell)
    assert correct, numbers


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_caught(cell):
    correct, numbers = one_run(cell, step_wrap=faults.stale)
    assert not correct
    assert numbers["walker_err"] > 1e-3 or numbers["accept_flips"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_batch_left_out_is_caught(cell):
    correct, numbers = one_run(cell, predictor_wrap=faults.half_batch)
    assert not correct


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_made_is_caught(cell):
    correct, numbers = one_run(cell, predictor_wrap=faults.altered)
    assert not correct


@pytest.mark.parametrize("control", ["bf16", "tf32"])
@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_controls_are_not_correct(cell, control):
    correct, numbers = one_run(cell, control=control)
    assert not correct, numbers


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_controls_fail_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (11, 12, 13):
        assert one_run(cell, "cuda", 4096, 1.0, seed)[0]
        assert not one_run(cell, "cuda", 4096, 1.0, seed, control="bf16")[0]
        assert not one_run(cell, "cuda", 4096, 1.0, seed, control="tf32")[0]
