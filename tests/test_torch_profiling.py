"""The port's profiling utilities: ``Timer`` as tests/test_profiling.py
checks tabcorr_tpu's, and ``device_trace`` on the CPU writing a Chrome
trace of the work in its block."""

import json
import time

import pytest
import torch

from tabcorr_tpu_torch.utils.profiling import Timer, device_trace


def test_timer_collects_phases():
    timer = Timer()
    with timer("phase_a"):
        time.sleep(0.01)
    with timer("phase_a"):
        time.sleep(0.01)
    with timer("phase_b"):
        pass
    assert timer.total("phase_a") >= 0.02
    assert timer.total() >= timer.total("phase_a")
    assert "phase_b" in timer.summary()
    assert [n for n, _ in timer.records] == ["phase_a", "phase_a", "phase_b"]


def test_timer_records_a_phase_that_raises():
    timer = Timer()
    with pytest.raises(KeyError):
        with timer("failing"):
            raise KeyError("x")
    assert timer.total("failing") >= 0.0 and len(timer.records) == 1


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "traces"
    with device_trace(log_dir, device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.trace_path.parent == log_dir and prof.trace_path.exists()
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_trace_needs_the_device_it_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with device_trace(tmp_path):
            pass
