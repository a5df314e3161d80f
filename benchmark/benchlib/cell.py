"""One run of one cell: set-up, the window, the metrics and the check.

The entry the window drives is the port's public sampler,
``mcmc.ensemble_step(generator, walkers, log_prob, log_prob_fn,
vectorized=True)`` back to back, whose ``log_prob_fn`` is
``mcmc.make_gaussian_logpost_batched`` over the configuration's
predictor.  The benchmark wraps the predictor it hands to the log
posterior, the log posterior it hands to the sampler, and its own call of
the sampler: spans in a traced run, and the first step's calls kept for
the check in every run.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, roofline, spans, traffic, window
from .inputs import hod_model
from .manifest import load
from .trace import busy_ns, idle_gaps, top_ops


@dataclass
class Run:
    """What a per-layer metric's reader reads."""

    window: window.Window
    spans: list
    slice_spans: list = field(default_factory=list)
    kernels: list = field(default_factory=list)
    trace_window_ns: tuple | None = None
    wall_minus_perf_ns: int = 0
    call_rows: int = 0
    call_work: object = None      # rows -> (flop, bytes) of a predictor call
    step_flop: float = 0.0

    def span_summary(self):
        return spans.summary(self.spans)

    def untraced_step_ms(self):
        """The window's step intervals (CUDA events) after the profiled
        slice, less the first of them, which holds the profiler's stop."""
        return self.window.step_ms[self.window.traced_steps[1] + 1:]


def _params_per_row(config):
    return len(config["fiducial"])


def work_of(ref, config):
    """(``call_work(rows)``, the FLOP of one ensemble step) from the
    reference's table shapes, by the frozen counts of ``roofline``."""
    shapes = ref.shapes()

    def row_flop():
        total = 0
        for n_bins, n_gauss, n_xi, auto, n_nodes in shapes:
            if n_nodes > 1:
                total += roofline.grid_flop(n_bins, n_gauss, n_nodes, n_xi)
            else:
                total += (roofline.quadrature_flop(n_bins, n_gauss) +
                          roofline.contraction_flop(n_bins, n_xi, auto))
        return total

    def call_work(rows):
        flop = rows * row_flop()
        n_bytes = (rows * _params_per_row(config) * roofline.FLOAT +
                   sum(roofline.table_bytes(b, g, x, a, k)
                       for b, g, x, a, k in shapes) +
                   rows * sum(1 + x for _, _, x, _, _ in shapes) *
                   roofline.FLOAT)
        return flop, n_bytes

    chi2 = sum(roofline.chi2_flop(x) for _, _, x, _, _ in shapes)
    return call_work, lambda walkers: walkers * (row_flop() + chi2)


def _diag_inv_cov(xi, frac, floor):
    return np.diag(1.0 / (frac * np.abs(xi) + floor) ** 2)


class CellRun:
    """Builds the system of a cell and runs it.

    ``control`` puts a lower precision in the program's place: ``"bf16"``
    the port's bfloat16 route, ``"tf32"`` the reference in float32 with
    TF32 products.  ``predictor_wrap`` and ``step_wrap`` wrap the
    program's predictor and sampler step (planted faults,
    ``benchlib.faults``).
    """

    def __init__(self, cell, seed, device, control=None,
                 predictor_wrap=None, step_wrap=None):
        from tabcorr_tpu_torch import mcmc
        self.config = cfg = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        system = load("systems", cfg["system"])
        raw = system.inputs(cfg, self.seed, self.device)
        refmod = load("reference", cfg["reference"])
        self.ref = refmod.Reference(raw, cfg, self.device)
        self.ens = load("reference", "ensemble")
        # The data vector: the reference at the fiducial point.
        fid = {k: torch.tensor([float(v)], dtype=torch.float64,
                               device=self.device)
               for k, v in cfg["fiducial"].items()}
        data = [x[0].cpu().numpy().ravel() for _, x in self.ref.predict(fid)]
        inv_covs = [_diag_inv_cov(d, cfg["data"]["sigma_frac"],
                                  cfg["data"]["sigma_floor"]) for d in data]
        self.judge = check.Judge(
            self.ref, self.ens, cfg,
            [torch.as_tensor(d, device=self.device) for d in data],
            [torch.as_tensor(c, device=self.device) for c in inv_covs])
        if control == "tf32":
            ctl = refmod.Reference(raw, cfg, self.device, precision="tf32")
            shapes = [r.tpcf_shape for r in raw]

            def predict(params):
                return [(n.float(), x.float().reshape((n.shape[0],) + s))
                        for (n, x), s in zip(ctl.predict(params), shapes)]

            base = dict(hod_model(cfg, raw[0].redshift).param_dict)
        else:
            predict, base = system.program(cfg, raw, self.device,
                                           control or "float32")
        if predictor_wrap is not None:
            predict = predictor_wrap(predict)
        self.spans = spans.Spans()
        self.pred_calls = check.Capture(
            self.spans.wrap("predictor", predict), 2)
        log_prob = mcmc.make_gaussian_logpost_batched(
            self.pred_calls, cfg["sampled"], base, data, inv_covs,
            bounds={k: tuple(v) for k, v in cfg["bounds"].items()},
            device=self.device)
        self.lp_calls = check.Capture(self.spans.wrap("logpost", log_prob), 2)
        step = mcmc.ensemble_step
        if step_wrap is not None:
            step = step_wrap(step)
        self.step_fn = self.spans.wrap("sampler", step)
        self.generator = traffic.generator(self.seed, "sampler", self.device)
        center = [cfg["fiducial"][k] for k in cfg["sampled"]]
        self.walkers = traffic.walkers_around(center, self.traffic,
                                              self.seed, self.device)
        self.a = float(self.traffic["stretch_a"])
        self.first = None
        self.call_work, step_flop = work_of(self.ref, cfg)
        self.step_flop = step_flop(self.walkers.shape[0])
        self.counter = cfg.get("kernel", {}).get("counter")

    def step(self):
        w, lp, acc = self.step_fn(self.generator, self.walkers, self.lp,
                                  self.lp_calls, a=self.a, vectorized=True)
        if self.first is None:
            self.first = (w, lp)
        self.walkers, self.lp = w, lp
        return acc

    def setup(self, tracer=None):
        """The full batch's log-prob and the warm-up steps (every shape the
        window uses); a traced run also starts the profiler once."""
        self.lp = self.lp_calls(self.walkers)
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step()
        if tracer is not None:
            tracer.warm(self.step)
        window.synchronize(self.device)
        self.first = None

    def launches(self):
        if not self.counter:
            return None
        from tabcorr_tpu_torch.ops import fused
        return getattr(fused, self.counter)

    def measure(self, seconds, tracer=None):
        """The window; returns it and what the per-layer readers read."""
        start = (self.walkers, self.lp)
        gen_state = self.generator.get_state()
        self.pred_calls.armed = self.lp_calls.armed = True
        self.spans.on = tracer is not None
        launches0 = self.launches()
        win = window.run_window(self.step, seconds, self.device, tracer)
        self.spans.on = False
        self.pred_calls.armed = self.lp_calls.armed = False
        self.launches_per_step = (
            None if launches0 is None else
            (self.launches() - launches0) / win.steps)
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)
        self.start, self.gen_state = start, gen_state
        return win, self._run(win, tracer)

    def _run(self, win, tracer):
        run = Run(window=win, spans=[], call_rows=self.walkers.shape[0] // 2,
                  call_work=self.call_work, step_flop=self.step_flop)
        if tracer is None:
            return run
        lo, hi = tracer.window_ns
        end_perf = hi - tracer.wall_minus_perf_ns
        # Host spans after the profiled slice carry no profiler cost.
        run.spans = [r for r in self.spans.records if r[1] >= end_perf]
        run.slice_spans = [r for r in self.spans.records if r[1] < end_perf]
        run.kernels = tracer.kernels
        run.trace_window_ns = (lo, hi)
        run.wall_minus_perf_ns = tracer.wall_minus_perf_ns
        return run

    def compare(self):
        """Free the program's state but what is judged, then judge."""
        first = self.first
        final = (self.walkers, self.lp)
        preds, lps = self.pred_calls.calls, self.lp_calls.calls
        gen = torch.Generator(device=self.device)
        gen.set_state(self.gen_state)
        self.pred_calls.calls, self.lp_calls.calls = [], []
        self.pred_calls.fn = self.lp_calls.fn = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if len(preds) < 2 or len(lps) < 2 or first is None:
            return {"calls_captured": len(preds)}
        return self.judge.judge(self.start, first, final, preds, lps, gen,
                                self.a)


def end_to_end(cellrun, win, setup_s):
    """Every end-to-end metric a cell may report; the manifest says which
    of them this cell does."""
    return {
        "walker_steps_per_s": window.rate(cellrun.walkers.shape[0],
                                          win.steps, win.seconds),
        "step_ms_p95": window.p95(win.step_ms),
        "setup_s": setup_s,
    }


def per_layer(cell, run):
    """Each per-layer metric's reader over ``run``; a reader that finds
    nothing returns None and its metric is left out."""
    out = {}
    for metric in cell.per_layer:
        value = load("metrics", metric["name"]).read(run)
        if value is not None:
            out[metric["name"]] = value
    return out


def breakdown(run):
    """The device ops that took most time, and the longest idle gaps
    named by the benchmark span the host was in."""
    lo, hi = run.trace_window_ns
    gaps = sorted(idle_gaps(run.kernels, lo, hi), key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:10]:
        mid = (s + e) // 2 - run.wall_minus_perf_ns
        where = spans.innermost(run.slice_spans, mid) or "window loop"
        named.append([where, (e - s) / 1e9])
    return {"device_ops": top_ops(run.kernels), "idle_gaps": named}


def device_trace(run):
    lo, hi = run.trace_window_ns
    return {"busy_s": busy_ns(run.kernels, lo, hi) / 1e9,
            "window_s": (hi - lo) / 1e9}


def attempted_failed(win):
    acc = win.accepts
    bad = ~np.isfinite(acc) | (acc < 0) | (acc > 1)
    return int(acc.size), int(bad.sum())

