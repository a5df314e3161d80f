"""The port's profiling utilities: ``Timer`` as tests/test_profiling.py
checks tabcorr_tpu's, ``device_trace`` on the CPU writing a Chrome
trace of the work in its block, and the port's spans: recorded only under
a profiler, nested by parent ids, on the profiler's clock.

The tests marked ``gpu`` need a CUDA device and skip without one; the file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_profiling.py
"""

import collections
import json
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import tabcorr_tpu_torch as tt
from tabcorr_tpu_torch import mcmc
from tabcorr_tpu_torch.utils import profiling
from tabcorr_tpu_torch.utils.profiling import Timer, device_trace

DATA = Path(tt.__file__).parent / "data"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _between(start_ns, end_ns):
    return [s for s in profiling.recorded()
            if start_ns <= s.start_ns and s.end_ns <= end_ns]


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    """``fn()`` under a profiler; returns (its spans, the profiler)."""
    start = time.time_ns()
    with profile(activities=list(activities)) as prof:
        fn()
    return _between(start, time.time_ns()), prof


def _posterior(predict, model, names, device, n_walkers=8):
    """A batched log posterior over ``predict`` at the model's fiducial
    point, its walkers around it and their log-probs."""
    base = dict(model.param_dict)
    fid = {k: torch.full((1,), v, device=device) for k, v in base.items()}
    data = [xi[0].double().cpu().numpy().ravel() for _, xi in predict(fid)]
    log_prob = mcmc.make_gaussian_logpost_batched(
        predict, names, base, data, [np.eye(d.size) for d in data],
        device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    walkers = torch.tensor([[base[k] for k in names]], device=device) * (
        1.0 + 1e-3 * torch.randn(n_walkers, len(names), generator=gen,
                                 device=device))
    return log_prob, gen, walkers, log_prob(walkers)


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


def test_no_span_is_recorded_without_a_profiler():
    start = time.time_ns()
    site = profiling.span("outside", rows=3)
    with site:
        torch.ones(4) + 1
    decorated = profiling.spanned("outside.call")(lambda x: x + 1)
    assert decorated(1) == 2
    assert not site and site is profiling.span("other")
    assert _between(start, time.time_ns()) == []


def test_an_ensemble_step_records_its_layers_by_parent():
    model = tt.Zheng07Model(threshold=-20, redshift=0.0)
    predict = tt.make_multi_predictor(
        [tt.TabCorr.read(DATA / "bolplanck_wp.npz")], model, engine="plain",
        device="cpu")
    names = ["logMmin", "alpha"]
    log_prob, gen, walkers, lp = _posterior(predict, model, names, "cpu")
    spans, _ = _profiled(lambda: mcmc.ensemble_step(
        gen, walkers, lp, log_prob, vectorized=True))
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    [step] = by_name["sampler.step"]
    assert step.parent is None
    posts = by_name["logpost"]
    assert len(posts) == 2 and {p.parent for p in posts} == {step.id}
    for child in ("logpost.params", "predictor"):
        assert sorted(s.parent for s in by_name[child]) == sorted(
            p.id for p in posts)
    assert [s.counts for s in by_name["logpost.params"]] == [{"syncs": 0}] * 2
    assert [s.counts for s in by_name["predictor"]] == [{"rows": 4}] * 2
    for s in spans:
        if s.parent is not None:
            outer = next(p for p in spans if p.id == s.parent)
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns


def test_nuts_records_each_host_read_of_its_leaf_loop():
    def log_prob(q):
        return -0.5 * (q ** 2).sum(dim=-1)

    gen = torch.Generator().manual_seed(3)
    q = torch.randn(4, 2, dtype=torch.float64, generator=gen)
    spans, _ = _profiled(lambda: mcmc.nuts_step(gen, q, log_prob, 0.3,
                                                max_depth=3))
    reads = [s for s in spans if s.name == "mcmc.nuts_leaf_read"]
    assert reads and all(s.counts == {"syncs": 0} for s in reads)


def test_a_span_contains_a_profiler_range_opened_inside_it():
    def work():
        with profiling.span("outer"):
            with record_function("inner range"):
                torch.ones(32, 32) @ torch.ones(32, 32)

    [outer], prof = _profiled(work)
    [inner] = [e for e in prof.profiler.kineto_results.events()
               if e.name() == "inner range"]
    assert outer.start_ns <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= outer.end_ns


def test_device_trace_holds_the_spans_around_the_ops_they_wrap(tmp_path):
    with device_trace(tmp_path, device="cpu") as prof:
        with profiling.span("around mm", rows=64):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    [mine] = [e for e in events if e.get("name") == "around mm"]
    assert mine["ph"] == "X" and mine["args"]["rows"] == 64
    mms = [e for e in events if e.get("name") == "aten::mm"]
    assert mms and all(e["pid"] != mine["pid"] for e in mms)
    assert any(mine["ts"] <= e["ts"] and
               e["ts"] + e["dur"] <= mine["ts"] + mine["dur"] for e in mms)


def test_the_ring_keeps_the_newest_spans_up_to_its_bound(monkeypatch):
    assert profiling._RING.maxlen == profiling.RING_SPANS
    monkeypatch.setattr(profiling, "_RING", collections.deque(maxlen=5))

    @profiling.spanned("bounded")
    def call():
        pass

    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(12):
            call()
    kept = profiling.recorded()
    assert len(kept) == 5 and all(s.name == "bounded" for s in kept)
    assert [s.id for s in kept] == sorted(s.id for s in kept)
    assert kept[-1].id - kept[0].id == 4


def _wp_xiell(device):
    """The wp + xi_ell configuration's predictor: one bundle launch."""
    model = tt.Zheng07Model(threshold=-18, redshift=0.0)
    tabs = [tt.TabCorr.read(DATA / f) for f in ("bolplanck_wp.npz",
                                                 "synthetic_xi_ell.npz")]
    return tt.make_multi_predictor(tabs, model, accuracy=(
        "elementwise", "scaled"), device=device), model


def _grid64(device):
    """The 64-node grid configuration's predictor: the grid kernel."""
    from tabcorr_tpu_torch.utils.synthetic import grid64_interpolator
    model = tt.Zheng07Model(threshold=-20, redshift=0.0)
    model.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    predict = tt.make_predictor(grid64_interpolator(), model,
                                engine="fused", accuracy="scaled",
                                device=device)
    return (lambda params: [predict(params)]), model


@pytest.mark.gpu
@pytest.mark.parametrize("config", [_wp_xiell, _grid64],
                         ids=["wp_xiell", "grid64"])
def test_recorded_syncs_are_the_streams_syncs(cuda, config):
    predict, model = config(cuda)
    names = list(model.param_dict)
    log_prob, gen, walkers, lp = _posterior(predict, model, names, cuda,
                                            n_walkers=1024)
    mcmc.ensemble_step(gen, walkers, lp, log_prob, vectorized=True)
    torch.cuda.synchronize()

    def step():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                mcmc.ensemble_step(gen, walkers, lp, log_prob,
                                   vectorized=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        step.syncs = sum("called a synchronizing CUDA operation" in
                         str(w.message) for w in caught)
        torch.cuda.synchronize()

    spans, _ = _profiled(step)
    recorded = sum(s.counts.get("syncs", 0) for s in spans)
    assert (recorded, step.syncs) == (2 * len(names), 2 * len(names))
    assert any(s.name.startswith("fused.") for s in spans)


@pytest.mark.gpu
def test_a_span_holds_the_kernel_it_launches_and_waits_for(cuda):
    x = torch.ones(1024, 1024, device=cuda)

    def work(cycles):
        for _ in range(4):
            x @ x
        with profiling.span("sleep"):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
        for _ in range(4):
            x @ x
        torch.cuda.synchronize()

    # The first profiler session of a process starts CUPTI: a throwaway.
    _profiled(lambda: work(1000), (ProfilerActivity.CUDA,))
    [mine], prof = _profiled(lambda: work(20_000_000),
                             (ProfilerActivity.CUDA,))
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert kernels, [e.name() for e in prof.profiler.kineto_results.events()]
    sleep = max(kernels, key=lambda e: e.duration_ns())
    assert sleep.duration_ns() > 1_000_000, [
        (e.name(), e.duration_ns()) for e in kernels]
    # The span waits for the whole kernel, so it lasts longer; and the
    # kernel sits inside it on the same clock.  The card's timestamps are
    # mapped to the host's clock with an error seen up to ~0.45 ms (in 5
    # of 60 sessions; typically launch and sync latencies of 20-110 us
    # separate the two ends), so the test holds the kernel's middle, not
    # its ends, inside the 10 ms span.
    middle = sleep.start_ns() + sleep.duration_ns() // 2
    assert sleep.duration_ns() <= mine.end_ns - mine.start_ns
    assert mine.start_ns < middle < mine.end_ns, (
        sleep.start_ns() - mine.start_ns,
        mine.end_ns - sleep.start_ns() - sleep.duration_ns())
