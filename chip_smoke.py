"""Drive the PyTorch port's paths once on one CUDA card and check them.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels (tabcorr_tpu_torch/csrc: the
bundle and contraction kernels in bundle.cu, the grid kernels in grid.cu,
the slab kernels in slab.cu, the occupation kernel of the HOD families in
occupation.cu, the labeled pair counter in paircount.cu, one nvcc each,
in parallel) and drives
``tabcorr_tpu_torch`` through the entry points a user calls, at real
shapes, 262,144 parameter vectors each unless said otherwise:

1. Bundle: ``make_multi_predictor`` on the bolplanck wp table (60 halo
   bins, 19 rp rows) and the synthetic xi_ell table (120 bins, 3 x 14
   rows) under ``accuracy=("elementwise", "scaled")`` (the bundle kernel,
   FP32 under both contracts), zheng07 at threshold -18; then
   ``make_gaussian_logpost_batched`` over it and five ``ensemble_step``s
   with 262,144 walkers.
2. Decorated bundle: the same tables with ``AssembiasZheng07Model``
   (threshold -18, assembly-bias strengths drawn in [-1, 1]); three
   ensemble steps over its 7 parameters.
3. Grid: ``make_predictor(interp, engine="fused", accuracy="scaled")``
   (the grid kernel, float64 on the tensor cores, as under both
   contracts) on the 64-node 'default'-geometry Interpolator (4 x 4 x 4
   nodes over alpha_c, alpha_s, log_eta; 60 bins; 42 rows), zheng07 at
   threshold -20, with a few rows pushed outside the grid; then the same
   with ``accuracy="elementwise"``.
4. Grid: the same entry points on the 'efficient' Delta Sigma Interpolator
   (cross mode, 1104 bins, 4 log_eta nodes), zheng07 at threshold -21,
   z = 0.5; then again with the decorated model.  Beside each grid path
   the grid kernel and grid_tc (3xTF32 on the tensor cores) run on the
   same inputs, timed in turns.
5. Grid sampler: the Gaussian log posterior over the 64-node grid
   predictor on all 8 parameters, three ensemble steps, 262,144 walkers.
6. Contraction: ``make_predictor(tab, engine="fused")`` on both bundle
   tables, and on xi_ell with the decorated model.
7. Wide grid (slab_tc kernel): ``make_predictor(interp, engine="fused",
   accuracy="scaled")`` on the 64-node grid of 160 bins (40 mass x 2
   secondary-percentile bins x 2 galaxy types), too wide for the grid
   kernels' packed layout; the decorated model at threshold -20, 32,768
   rows, a few outside the grid; then two ensemble steps over its 10
   parameters; then the 'elementwise' route (the FP32 slab kernel, from
   the same constants).

8. The other HOD families, whose densities the occupation kernel
   computes and the kernels read (model code 2): the bundle on the wp +
   xi_ell tables for Leauthaud11 and ZuMandelbaum15 (threshold 10.5;
   log10 M1 +- 0.1, the central scatter +-25%, alphasat 0.8-1.2, bsat and
   bcut +-10%; three ensemble steps over those five); the grid kernel on
   the 64-node grid for Leauthaud11 (three sampler steps) and on the
   'efficient' Delta Sigma grid for AssembiasLeauthaud11 at z = 0.5 under
   both contracts; the contraction kernel for Cacciato09 on wp and
   Tinker13 (quiescent) on xi_ell; slab_tc and slab on the wide grid for
   AssembiasZuMandelbaum15 at 32,768 rows (two sampler steps).  The
   bundle's densities come from one occupation launch per call over both
   tables' node plan.  Each path prints the occupation kernel and the
   kernel it feeds separately, beside the occupation's plain version
   (tensor ops), and the occupation kernel's bound on its inputs
   (``occupation_bound``: its pieces at their SASS instruction counts, at
   the distinct nodes of the node plan) with its share and the plan's
   distinct and evaluated (bin, node) abscissae; the occupation kernel
   against its plain version (tabcorr_tpu's fused-against-XLA bar) and
   against float64 (1e-6), the kernel against the plain contraction of
   the same densities, and the path and the port's plain float32 engine
   against float64 at 16 probes (the path within max(1e-6, twice the
   plain engine's error)).  Then code 2 fed zheng07's tensor-op densities
   against codes 0 / 1 on the same rows: the bundle, the 64-node grid,
   both slab tiers.

9. Tabulation: ``TabCorr.tabulate`` on a synthetic catalog of 200,000
   host halos in a 250 Mpc/h box (Bolshoi-Planck's; the JAX package's
   bench-fixture mass function, ``utils.synthetic.synthetic_halocat``),
   one projection a sweep (project_xyz=False), RSD on: (a) wp and (b)
   xi(s, mu) in the 'default' configuration (auto, 30 mass bins x the 0.5
   percentile split x 2 galaxy types = 120 labels, AP stretch to
   Planck15; ~1.2 million tracers), xi_0/2/4 from (b) stacked as the
   bench fixture stacks them; (c) Delta Sigma in the 'efficient' one
   (cross, 300 mass bins, downsampled by M / 1e13) against 1,000,000
   uniform particles, the annulus mean's two channels from one sweep;
   (d) wp again on a clustered catalog of the same hosts (around 4,000
   centres).  Each sweep is one launch of the pair counter; it is held
   against its plain version on 65,536 random tracers a side (unit
   counts equal, weighted cells within 1e-7) and, at full size, on the
   histogram rows of three i-labels (that label's tracers against every
   j-tracer); full-size auto counts must be symmetric, and 5,000 tracers
   are held against float64 binning cell by cell (a cell may differ only
   by the pairs that four float32 ulp would move into it).  Printed: the
   kernel's ms, candidate pairs and their rate, kept pairs, the bound
   (``bound_ops``: what the function needs over the z-window's
   candidates, at 33.5 T lane-ops/s) and the share, the plain version's
   ms on the subsample, the stages' wall time.  Then the tables of
   (a)-(c) predict: wp + xi_ell through ``make_multi_predictor`` (B1,
   262,144 rows, 'scaled'), Delta Sigma through
   ``make_predictor(engine="fused")`` (B3), each against the float64
   host path at 16 probes (ngal 1e-6 relative, the statistics 1e-6
   scaled) and the bundle against its plain engine.

Paths 3-5 and 7 run the 'scaled' contract: the grid kernel and slab_tc;
the 'elementwise' passes run the grid kernel and the FP32 slab kernel,
held against the same plain versions.  No contract routes to grid_tc
(``fused.grid_kernel_for``), so one direct pass through its wrapper holds
it against the plain version and times it.

Every launch counter is set to 0 right before each path and read right
after it.  Then each kernel's results are held against its plain PyTorch
version on the same inputs and against the float64 host path at 16
probes, and both versions are timed with CUDA events, beside the least
time the card could take (``bound_ms``) and, where one PyTorch call
computes the same function, that call's time (``library_ms``); the bundle
kernel is also timed on each table alone and on both tables cut to one
statistic (the occupation's share).  Any failed check raises (non-zero exit).  On success the line before the
last lists the kernels as JSON, and the last line is one JSON object
naming the device.
"""

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

BATCH = 262144
SLAB_BATCH = 32768
N_PROBE = 16
N_STEPS = 5
N_GRID_STEPS = 3
N_SLAB_STEPS = 2
SEED = 7
# Rows pushed outside the grid (none among the probes).
OUT_ROWS = (17, 4099, BATCH - 1)
SLAB_OUT_ROWS = (17, 4099, SLAB_BATCH - 1)
# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): FP32 on
# the CUDA cores (and FP64 on the tensor cores: the same rate), dense TF32
# on the tensor cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# FP64 on the CUDA cores (the same data sheet).
PEAK_FP64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12
STRENGTHS = ("mean_occupation_centrals_assembias_param1",
             "mean_occupation_satellites_assembias_param1")
CSRC = "tabcorr_tpu_torch/csrc/"
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "bundle": (CSRC + "bundle.cu", "tabcorr_tpu/ops/fused.py:600"),
    "contraction": (CSRC + "bundle.cu", "tabcorr_tpu/ops/fused.py:125"),
    "grid": (CSRC + "grid.cu", "tabcorr_tpu/ops/fused.py:1485"),
    "grid_tc": (CSRC + "grid.cu", "tabcorr_tpu/ops/fused.py:1485"),
    "slab": (CSRC + "slab.cu", "tabcorr_tpu/ops/fused.py:1162"),
    "slab_tc": (CSRC + "slab.cu", "tabcorr_tpu/ops/fused.py:1162"),
    # The occupation phase the Pallas kernels B1, B4 and B2 trace in their
    # bodies for the SHMR, CLF and quiescent/active families.
    "occupation": (CSRC + "occupation.cu",
                   "tabcorr_tpu/ops/fused.py:985, 1373, 1941"),
    # The z-windowed XLA sweep of the tabulation (not a Pallas kernel).
    "paircount": (CSRC + "paircount.cu",
                  "tabcorr_tpu/ops/paircount.py:130, 276"),
}
# name -> (module of ctx, launch counter)
COUNTERS = {"bundle": ("fused", "BUNDLE_LAUNCHES"),
            "contraction": ("fused", "CONTRACTION_LAUNCHES"),
            "grid": ("fused", "GRID_LAUNCHES"),
            "grid_tc": ("fused", "GRID_TC_LAUNCHES"),
            "slab": ("fused", "SLAB_LAUNCHES"),
            "slab_tc": ("fused", "SLAB_TC_LAUNCHES"),
            "occupation": ("fused", "OCCUPATION_LAUNCHES"),
            "paircount": ("paircount", "PAIRCOUNT_LAUNCHES")}


def check(ok, message):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def card_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing was run.",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    ctx = make_context()
    kernels = {}
    bundle_phase(ctx, kernels)
    bundle_phase(ctx, kernels, decorated=True)
    grid_phases(ctx, kernels)
    contraction_phase(ctx, kernels)
    slab_phase(ctx, kernels)
    family_phases(ctx, kernels)
    tabulation_phase(ctx, kernels)

    for name in KERNELS:
        check(kernels[name]["launches"] > 0,
              f"{name} never launched on its path")
    print(f"whole run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], **kernels[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def make_context():
    """Build every kernel library from the checkout, print the card, and
    return the helpers the phases share."""
    import torch
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np

    import tabcorr_tpu_torch  # noqa: F401  (fails outside a checkout)
    from tabcorr_tpu_torch.ops import fused, paircount
    from tabcorr_tpu_torch.utils.build import build_libraries, library_path

    card = card_name_and_power()
    print(f"card (name, power limit): {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    sources = {**fused.KERNEL_SOURCES, **paircount.KERNEL_SOURCES}
    build_libraries(sources)
    fused.load_kernels()
    paircount.load_kernels()
    print(f"kernel builds (parallel) + load: "
          f"{time.perf_counter() - t_start:.2f} s")
    for name in sources:
        log = library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else ():
            if "registers" in line or "spill" in line or (
                    name in ("occupation", "paircount") and
                    "entry function" in line):
                print(f"ptxas ({name}): {line.strip()}")
    modules = {"fused": fused, "paircount": paircount}

    def reset():
        for module, attr in COUNTERS.values():
            setattr(modules[module], attr, 0)

    def counts():
        return {k: getattr(modules[module], attr)
                for k, (module, attr) in COUNTERS.items()}

    def expect(what, **launches):
        """The counts since reset(): ``launches`` and 0 for every other
        kernel."""
        got = counts()
        check(got == {k: launches.get(k, 0) for k in COUNTERS},
              f"{what}: launches {got}")
        return got

    def window_ms(fn, n_iter):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n_iter

    def alternate(kernel, plain, n_kernel, n_plain, rounds=3):
        """Median ms of kernel and plain windows, plain-kernel-kernel-plain."""
        k_ms, p_ms = [], []
        for _ in range(rounds):
            p_ms.append(window_ms(plain, n_plain))
            k_ms.append(window_ms(kernel, n_kernel))
            k_ms.append(window_ms(kernel, n_kernel))
            p_ms.append(window_ms(plain, n_plain))
        return float(np.median(k_ms)), float(np.median(p_ms)), k_ms, p_ms

    def library_ms(fn, n_iter=2):
        """ms of one PyTorch call with TF32 off (full float32, or
        float64), an einsum contracted left to right (the outer product n
        n^T first, then one GEMM)."""
        einsum_opt = torch.backends.opt_einsum.enabled
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.opt_einsum.enabled = False
        try:
            fn()
            return window_ms(fn, n_iter)
        finally:
            torch.backends.opt_einsum.enabled = einsum_opt
            torch.backends.cuda.matmul.allow_tf32 = tf32

    return dict(torch=torch, np=np, fused=fused, paircount=paircount,
                card=card, reset=reset,
                expect=expect, window_ms=window_ms, alternate=alternate,
                library_ms=library_ms)


def record(kernels, name, launches, **numbers):
    """Add a path's launches to kernel ``name``; ``numbers`` (its errors
    and times) come from the path that the kernels line reports."""
    entry = kernels.setdefault(name, {"launches": 0})
    entry["launches"] += launches
    entry.update(numbers)


def rel(a, b):
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def scaled(a, b):
    """Max over rows of max |a - b| / max |b|."""
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    return float(((a - b).abs().amax(1) / b.abs().amax(1)).max())


def max_abs(*pairs):
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flop, n_bytes, tensor_flop=None):
    """The least time the card could take: the larger of the operations
    over their peak and the bytes over the HBM rate.  FP32 kernels, and
    the grid kernel on the FP64 tensor cores: all ``flop`` at 67 TFLOP/s,
    the FP32 CUDA-core peak, which is also the FP64 tensor-core peak.
    3xTF32 kernels (``tensor_flop``, the contraction's FLOP): three TF32
    products each at the dense TF32 peak, and ``bound_fp32_ms`` keeps the
    FP32 CUDA-core figure."""
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    fp32_ms = flop / PEAK_FP32_FLOPS * 1e3
    ops_ms = (fp32_ms if tensor_flop is None else
              3 * tensor_flop / PEAK_TF32_FLOPS * 1e3)
    out = {"bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    if tensor_flop is not None:
        out["bound_fp32_ms"] = max(fp32_ms, bytes_ms)
    return out


def contraction_flop(n_bins, n_xi, auto):
    """FP32 operations of one row's statistics from its densities, at the
    least: the symmetric form over the n_bins (n_bins + 1) / 2 pairs (one
    product for each pair's weight, one multiply-add per pair and row of
    the statistic) in auto mode, the matrix-vector product in cross
    mode."""
    if not auto:
        return 2 * n_xi * n_bins
    npair = n_bins * (n_bins + 1) // 2
    return npair + 2 * n_xi * npair


def quadrature_flop(n_bins, n_gauss):
    """One row's quadrature sums (a multiply-add per node); the occupation
    functions themselves are not counted."""
    return 2 * n_bins * n_gauss


def bench_params(model, rng, batch, device):
    """bench.py's zheng07 parameter distribution around the model's
    values, and assembly-bias strengths uniform in [-1, 1] for the
    decorated model; row 0 at the model's values."""
    from tabcorr_tpu_torch import params_batch
    p = model.param_dict
    overrides = {
        "logMmin": p["logMmin"] + 0.1 * rng.normal(size=batch),
        "sigma_logM": p["sigma_logM"] + 0.01 * rng.normal(size=batch),
        "logM0": p["logM0"] + 0.1 * rng.normal(size=batch),
        "logM1": p["logM1"] + 0.1 * rng.normal(size=batch),
        "alpha": p["alpha"] + 0.02 * rng.normal(size=batch),
    }
    for name in STRENGTHS:
        if name in p:
            overrides[name] = rng.uniform(-1.0, 1.0, batch)
    for key in overrides:
        overrides[key][0] = p[key]
    return params_batch(model, overrides, (batch,), device=device)


def host_model(model, params, i):
    """A copy of ``model`` at row ``i`` of the float32 batch."""
    m = copy.copy(model)
    m.param_dict = dict(model.param_dict)
    for k, v in params.items():
        m.param_dict[k] = float(v[i])
    return m


def run_sampler(ctx, log_prob, walkers, n_steps, counter, seed):
    """``n_steps`` ensemble steps from ``walkers``; returns the accept
    fractions, per-step host-clock seconds and final log-probabilities,
    after checking that each step launched ``counter`` twice."""
    torch, fused = ctx["torch"], ctx["fused"]
    from tabcorr_tpu_torch.mcmc import ensemble_step
    generator = torch.Generator(device="cuda").manual_seed(seed)
    lp = log_prob(walkers)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lp).all()), "non-finite initial log-prob")
    accepts, grew, step_s = [], [], []
    for _ in range(n_steps):
        before = getattr(fused, counter)
        t0 = time.perf_counter()
        walkers, lp, accept = ensemble_step(generator, walkers, lp, log_prob,
                                            vectorized=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        grew.append(getattr(fused, counter) - before)
        accepts.append(float(accept))
    check(grew == [2] * n_steps, f"launches per step {grew}")
    check(bool(torch.isfinite(lp).all()), "non-finite log-prob after steps")
    check(all(0.0 < a < 1.0 for a in accepts), f"accept fractions {accepts}")
    return accepts, step_s, lp


def walkers_around(ctx, model, names, batch, seed):
    torch, np = ctx["torch"], ctx["np"]
    rng = np.random.default_rng(seed)
    return torch.tensor(
        np.array([model.param_dict[k] for k in names])[None, :] +
        0.02 * rng.normal(size=(batch, len(names))),
        dtype=torch.float32, device="cuda")


# ----------------------------------------------------------------------
def bundle_phase(ctx, kernels, decorated=False):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (AssembiasZheng07Model, TabCorr,
                                   Zheng07Model, make_multi_predictor)
    from tabcorr_tpu_torch.mcmc import make_gaussian_logpost_batched

    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    wp_tab = TabCorr.read(data / "bolplanck_wp.npz")
    xi_tab = TabCorr.read(data / "synthetic_xi_ell.npz")
    kind = AssembiasZheng07Model if decorated else Zheng07Model
    label = "decorated bundle" if decorated else "bundle"
    model = kind(threshold=-18, redshift=wp_tab.attrs["redshift"])
    names = kind.kernel_param_names
    n_steps = N_GRID_STEPS if decorated else N_STEPS
    rng = np.random.default_rng(SEED + 10 * decorated)
    params = bench_params(model, rng, BATCH, "cuda")
    accuracy = ("elementwise", "scaled")
    predict = make_multi_predictor([wp_tab, xi_tab], model, device="cuda",
                                   accuracy=accuracy)
    predict_plain = make_multi_predictor([wp_tab, xi_tab], model,
                                         device="cuda", engine="plain",
                                         accuracy=accuracy)

    # ---- path: predict, then the MCMC ensemble ------------------------
    ctx["reset"]()
    outs = predict(params)
    torch.cuda.synchronize()
    check(fused.BUNDLE_LAUNCHES == 1, f"{label}: predict did not launch")
    (ngal, wp), (_, xi) = outs
    shapes = (tuple(wp.shape), tuple(xi.shape))
    check(shapes == ((BATCH, 19), (BATCH, 3, 14)), f"shapes {shapes}")

    data_wp = wp[0].double().cpu().numpy().ravel()
    data_xi = xi[0].double().cpu().numpy().ravel()
    log_prob = make_gaussian_logpost_batched(
        predict, names, model.param_dict, [data_wp, data_xi],
        [np.diag(1.0 / (0.05 * np.abs(data_wp) + 1e-3) ** 2),
         np.diag(1.0 / (0.05 * np.abs(data_xi) + 1e-3) ** 2)],
        device="cuda")
    walkers = walkers_around(ctx, model, names, BATCH, SEED)
    accepts, step_s, lp = run_sampler(ctx, log_prob, walkers, n_steps,
                                      "BUNDLE_LAUNCHES", SEED)
    launched = ctx["expect"](label, bundle=2 + 2 * n_steps)["bundle"]
    print(f"{label} path: {launched} bundle kernel launches "
          f"(1 predict, 1 initial log-prob, 2 per ensemble step x "
          f"{n_steps}), {len(names)} sampled parameters")
    print(f"{label} mcmc: {n_steps} ensemble steps x {BATCH} walkers, "
          f"accept fractions {accepts}, log-prob range "
          f"[{float(lp.min()):.6g}, {float(lp.max()):.6g}]")
    # Median over the steps: the first one also pays one-time set-up.
    print(f"{label} mcmc: {BATCH / float(np.median(step_s)):.6g} "
          f"walker-steps/s (median of per-step host-clock times {step_s} s) "
          f"on {ctx['card']}")

    # ---- the kernel against the plain version (same inputs) and the ----
    # ---- float64 host path at the float32 parameters --------------------
    plain = predict_plain(params)
    torch.cuda.synchronize()
    for name, out in (("ngal", ngal), ("wp", wp), ("xi", xi)):
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite {name}")
    pairs = [(outs[0][0], plain[0][0]), (outs[1][0], plain[1][0]),
             (wp, plain[0][1]), (xi, plain[1][1])]
    ngal_err = max(rel(*pairs[0]), rel(*pairs[1]))
    wp_err = rel(*pairs[2])
    xi_err = scaled(*pairs[3])
    err = max_abs(*pairs)
    print(f"{label} kernel vs plain (B={BATCH}): ngal max rel "
          f"{ngal_err:.3e} (<= 1e-6), wp max rel {wp_err:.3e} (<= 2e-6), "
          f"xi max scaled {xi_err:.3e} (<= 1e-6), max abs {err:.3e}")
    check(ngal_err <= 1e-6, f"{label}: ngal kernel vs plain {ngal_err}")
    check(wp_err <= 2e-6, f"{label}: wp kernel vs plain {wp_err}")
    check(xi_err <= 1e-6, f"{label}: xi kernel vs plain {xi_err}")
    err_wp = err_xi = 0.0
    for i in range(N_PROBE):
        m = host_model(model, params, i)
        want_wp = wp_tab.predict(m, check_consistency=False)[1].ravel()
        want_xi = xi_tab.predict(m, check_consistency=False)[1].ravel()
        got_wp = wp[i].double().cpu().numpy().ravel()
        got_xi = xi[i].double().cpu().numpy().ravel()
        err_wp = max(err_wp, float(np.max(np.abs(got_wp / want_wp - 1))))
        err_xi = max(err_xi, float(np.max(np.abs(got_xi - want_xi)) /
                                   np.max(np.abs(want_xi))))
    print(f"{label} kernel vs float64 host at {N_PROBE} probes: wp max rel "
          f"{err_wp:.3e} (<= 1e-6), xi_ell max scaled {err_xi:.3e} (<= 1e-6)")
    check(err_wp <= 1e-6, f"{label}: wp vs float64 {err_wp}")
    check(err_xi <= 1e-6, f"{label}: xi_ell vs float64 {err_xi}")

    if decorated:
        # ---- the decoration moves xi_ell ------------------------------
        moved = {}
        for strength in (0.0, 0.8):
            p = {k: v[:4096].clone() for k, v in params.items()}
            for name in STRENGTHS:
                p[name].fill_(strength)
            moved[strength] = predict(p)[1][1]
        shift = scaled(moved[0.8], moved[0.0])
        least = float(((moved[0.8] - moved[0.0]).double().reshape(4096, -1)
                       .abs().amax(1) / moved[0.0].double().reshape(
                           4096, -1).abs().amax(1)).min())
        print(f"{label}: strength 0.8 against 0 moves xi_ell by {least:.3e} "
              f"to {shift:.3e} scaled over 4096 rows (> 1e-4)")
        check(least > 1e-4, f"{label}: the decoration does not move xi_ell")

    # ---- timing: plain, kernel, kernel, plain --------------------------
    k_ms, p_ms, k_w, p_w = ctx["alternate"](
        lambda: predict(params), lambda: predict_plain(params), 10, 2)
    print(f"timing ({label}): bundle kernel {k_ms:.4f} ms per "
          f"{BATCH}-vector batch ({BATCH / k_ms * 1e3:.6g} predictions/s; "
          f"windows {k_w}) on {ctx['card']}")
    print(f"timing ({label}): bundle plain PyTorch {p_ms:.4f} ms per "
          f"{BATCH}-vector batch ({BATCH / p_ms * 1e3:.6g} predictions/s; "
          f"windows {p_w}) on {ctx['card']}")
    if decorated:
        record(kernels, "bundle", launched)
        return
    datas = [t.table_data(device="cuda") for t in (wp_tab, xi_tab)]
    tables = [fused.slab_tc_table_constants(d, 1) for d in datas]
    # One PyTorch call per table for the contraction alone (no library
    # call evaluates the occupation quadrature): n n^T, then one GEMM
    # against the dense matrices, over this batch's densities.
    lib_ms = 0.0
    for d in datas:
        dens = fused.occupation_density(d, model, params)
        lib_ms += ctx["library_ms"](
            lambda: torch.einsum("bi,bj,kij->bk", dens, dens, d.tpcf_dense))
        del dens
    print(f"timing ({label}): one torch.einsum('bi,bj,kij->bk') per table "
          f"(contraction only), wp + xi_ell {lib_ms:.4f} ms on {ctx['card']}")
    # Where a launch's time goes: each table alone, and both cut to one
    # statistic (the occupation quadrature and little else).
    hod = fused.KernelModel.of(model)
    pmat = torch.stack([params[k] for k in hod.param_names], dim=1)
    cut = [fused.slab_tc_table_constants(dataclasses.replace(
        d, tpcf_dense=d.tpcf_dense[:1], tpcf_shape=(1,)), 1) for d in datas]
    for what, consts in (("wp alone", tables[:1]),
                         ("xi_ell alone", tables[1:]),
                         ("both tables cut to one statistic", cut)):
        part_ms = ctx["window_ms"](
            lambda: fused.bundle_launch(consts, pmat, hod), 10)
        print(f"phases ({label}): {what}: bundle {part_ms:.4f} ms on "
              f"{ctx['card']}")
    flop = BATCH * sum(quadrature_flop(c.n_bins, c.n_gauss) +
                       contraction_flop(c.n_bins, c.n_xi, c.auto)
                       for c in tables)
    n_bytes = BATCH * len(names) * 4 + sum(
        nbytes(c.logm, c.logm_res, c.sec, c.weight, c.b) +
        BATCH * (1 + c.n_xi) * 4 for c in tables)
    record(kernels, "bundle", launched, max_abs_err=err, ms=k_ms,
           plain_ms=p_ms, **bound(flop, n_bytes), library_ms=lib_ms)


# ----------------------------------------------------------------------
def grid_phases(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (AssembiasZheng07Model, Interpolator,
                                   Zheng07Model, make_predictor,
                                   occupation_functions)
    from tabcorr_tpu_torch.mcmc import make_gaussian_logpost_batched
    from tabcorr_tpu_torch.predictor import grid_node_weights, stacked_grid
    from tabcorr_tpu_torch.utils.synthetic import grid64_interpolator

    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    cases = []
    # grid64: bench config #4, alpha_s varied too.
    interp = grid64_interpolator()
    model = Zheng07Model(threshold=-20, redshift=0.0)
    model.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    rng = np.random.default_rng(11)
    params = bench_params(model, rng, BATCH, "cuda")
    for key, lo, hi in (("alpha_c", 0.05, 0.35), ("alpha_s", 0.85, 1.15),
                        ("log_eta", -0.3, 0.3)):
        v = rng.uniform(lo, hi, BATCH)
        v[0] = model.param_dict[key]
        params[key] = torch.tensor(v, dtype=torch.float32, device="cuda")
    params["alpha_c"][list(OUT_ROWS)] = 0.5
    cases.append(("grid64", interp, model, params))
    # ds_efficient: the test fixture's model, log_eta inside its grid;
    # then the decorated model (tabcorr_tpu's tests/
    # test_assembias_predict.py configuration).
    interp_ds = Interpolator.read(data / "ds_efficient.npz")
    for kind in (Zheng07Model, AssembiasZheng07Model):
        model_ds = kind(threshold=-21, redshift=0.5,
                        prim_haloprop_key="halo_m258m")
        model_ds.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
        params_ds = bench_params(model_ds, rng, BATCH, "cuda")
        v = rng.uniform(-0.45, 0.45, BATCH)
        v[0] = 0.0
        v[list(OUT_ROWS)] = 0.6
        params_ds["log_eta"] = torch.tensor(v, dtype=torch.float32,
                                            device="cuda")
        name = ("ds_efficient" if kind is Zheng07Model else
                "ds_efficient decorated")
        cases.append((name, interp_ds, model_ds, params_ds))

    # The kernel the 'scaled' contract routes to (fused.grid_kernel_for).
    kname = fused.grid_kernel_for("packed", "scaled")
    launch = {"grid": fused.grid_launch, "grid_tc": fused.grid_tc_launch}[
        kname]
    launches = grid_launches = 0
    for name, interp, model, params in cases:
        predict = make_predictor(interp, model, engine="fused",
                                 accuracy="scaled", device="cuda")
        # ---- path ------------------------------------------------------
        ctx["reset"]()
        t0 = time.perf_counter()
        ngal, xi = predict(params)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launched = ctx["expect"](name, **{kname: 1})
        launches += launched[kname]
        xi = xi.reshape(BATCH, -1)
        out = torch.zeros(BATCH, dtype=torch.bool, device="cuda")
        out[list(OUT_ROWS)] = True
        check(bool(torch.isnan(ngal[out]).all() and
                   torch.isnan(xi[out]).all()),
              f"{name}: out-of-grid rows are not all NaN")
        check(bool(torch.isfinite(ngal[~out]).all() and
                   torch.isfinite(xi[~out]).all()),
              f"{name}: NaN or inf in rows inside the grid")
        print(f"{name}: 'scaled', {launched[kname]} {kname} kernel launch, "
              f"xi {tuple(xi.shape)}, rows {OUT_ROWS} outside the grid all "
              f"NaN, the rest finite; first call {first_s:.3f} s")

        # ---- kernel against its plain version, same inputs -------------
        stacked, n_nodes, _ = stacked_grid(interp, device="cuda")
        g = fused.grid_table_constants(stacked, n_nodes)
        occ = occupation_functions(model)
        nw = grid_node_weights(interp, params)
        ngal_p, xi_p = fused.grid_predict_plain(g, params, nw, *occ)
        torch.cuda.synchronize()
        check(bool(torch.isnan(xi_p[out]).all()),
              f"{name}: plain version not NaN outside the grid")
        ngal_err = rel(ngal[~out], ngal_p[~out])
        xi_err = scaled(xi[~out], xi_p[~out])
        err = max_abs((ngal[~out], ngal_p[~out]), (xi[~out], xi_p[~out]))
        print(f"{name}: {kname} kernel vs plain (B={BATCH}): ngal max rel "
              f"{ngal_err:.3e} (<= 1e-6), xi max scaled {xi_err:.3e} "
              f"(<= 1e-6), max abs {err:.3e}")
        check(ngal_err <= 1e-6, f"{name}: ngal kernel vs plain {ngal_err}")
        check(xi_err <= 1e-6, f"{name}: xi kernel vs plain {xi_err}")

        # ---- against the float64 host Interpolator.predict ------------
        err_host = err_ngal = 0.0
        for i in range(N_PROBE):
            ng64, xi64 = interp.predict(host_model(model, params, i),
                                        check_consistency=False)
            got = xi[i].double().cpu().numpy()
            err_host = max(err_host, float(np.max(np.abs(got - xi64.ravel()))
                                           / np.max(np.abs(xi64))))
            err_ngal = max(err_ngal, abs(float(ngal[i]) / ng64 - 1))
        print(f"{name}: {kname} kernel vs float64 Interpolator.predict at "
              f"{N_PROBE} probes: xi max scaled {err_host:.3e} (<= 1e-6), "
              f"ngal max rel {err_ngal:.3e} (<= 1e-6)")
        check(err_host <= 1e-6, f"{name}: xi vs float64 {err_host}")
        check(err_ngal <= 1e-6, f"{name}: ngal vs float64 {err_ngal}")

        # ---- timing: the kernel's wrapper against its plain version ----
        hod = fused.KernelModel.of(model)
        pmat = torch.stack([params[k] for k in hod.param_names], dim=1)
        k_ms, p_ms, k_w, p_w = ctx["alternate"](
            lambda: launch(g, pmat, nw, hod),
            lambda: fused.grid_predict_plain(g, params, nw, *occ), 3, 2)
        e2e_ms = ctx["window_ms"](lambda: predict(params), 3)
        print(f"timing ({name}): {kname} kernel {k_ms:.4f} ms per "
              f"{BATCH}-vector batch (windows {k_w}), plain PyTorch "
              f"{p_ms:.4f} ms (windows {p_w}); whole predictor "
              f"{e2e_ms:.4f} ms ({BATCH / e2e_ms * 1e3:.6g} predictions/s) "
              f"on {ctx['card']}")
        tier_comparison(ctx, name, g, pmat, nw, hod)
        if name != "grid64":
            grid_launches += grid_elementwise_cross_pass(
                ctx, name, interp, model, params, out, ngal_p, xi_p)
        if name == "grid64":
            dense = 2.0 * g.npair * g.n_nodes * g.n_xi * BATCH
            print(f"grid64: {dense:.4g} FLOP of packed contraction per "
                  f"batch (2 x {g.npair} x {g.n_nodes * g.n_xi} per "
                  f"sample): {dense / k_ms / 1e9:.4g} TFLOP/s in {kname}")
            flop = BATCH * (quadrature_flop(g.n_bins, g.n_gauss) + g.npair +
                            2 * g.n_nodes * g.n_xi * (g.npair + 1))
            n_bytes = (nbytes(pmat, nw, g.logm, g.logm_res, g.sec, g.weight,
                              g.pair_i, g.pair_j, g.fp) +
                       BATCH * (1 + g.n_xi) * 4)
            # One PyTorch call for the contraction alone (no library call
            # evaluates the occupation or folds the spline): n n^T, then
            # one GEMM against every node's dense matrices.
            dens = fused.occupation_density(stacked, model, params)
            lib_ms = ctx["library_ms"](lambda: torch.einsum(
                "bi,bj,kij->bk", dens, dens, stacked.tpcf_dense))
            del dens
            print(f"timing (grid64): one torch.einsum('bi,bj,kij->bk') over "
                  f"all {g.n_nodes} nodes (contraction only) {lib_ms:.4f} ms "
                  f"on {ctx['card']}")
            # The kernels line carries the 64-node grid's numbers (the
            # Delta Sigma values are ~1e13, so their absolute errors are
            # not comparable).
            grid_numbers = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                **bound(flop, n_bytes, tensor_flop=dense),
                                library_ms=lib_ms)
            grid64 = (interp, model, params, stacked, g, nw, occ, hod, pmat,
                      out, flop, n_bytes)

    grid_elementwise_pass(ctx, kernels, *grid64, grid_launches)
    if kname == "grid":
        # grid_tc is on no path: one direct pass keeps it built, launched
        # and held against the plain version.
        grid_tc_direct_pass(ctx, kernels, *grid64[2:3], *grid64[4:], dense,
                            grid_numbers["library_ms"])

    # ---- path: the ensemble sampler over the 64-node grid -------------
    _, interp, model, params = cases[0]
    predict = make_predictor(interp, model, engine="fused", accuracy="scaled",
                             device="cuda")
    names = Zheng07Model.param_names + ("alpha_c", "alpha_s", "log_eta")
    fiducial = {k: v[:1] for k, v in params.items()}
    data_xi = predict(fiducial)[1][0].double().cpu().numpy().ravel()
    log_prob = make_gaussian_logpost_batched(
        lambda p: [predict(p)], names, model.param_dict, [data_xi],
        [np.diag(1.0 / (0.05 * np.abs(data_xi) + 1e-3) ** 2)], device="cuda")
    walkers = walkers_around(ctx, model, names, BATCH, SEED + 1)
    ctx["reset"]()
    accepts, step_s, _ = run_sampler(ctx, log_prob, walkers, N_GRID_STEPS,
                                     COUNTERS[kname][1], SEED + 1)
    launched = ctx["expect"]("grid sampler", **{kname: 1 + 2 * N_GRID_STEPS})
    launches += launched[kname]
    print(f"grid sampler: {launched[kname]} {kname} kernel launches (1 "
          f"initial log-prob, 2 per step x {N_GRID_STEPS}), accept fractions "
          f"{accepts}, {BATCH / float(np.median(step_s)):.6g} walker-steps/s "
          f"(median of per-step host-clock times {step_s} s) on "
          f"{ctx['card']}")
    # The grid kernel's numbers come from its 'elementwise' pass.
    record(kernels, kname, launches,
           **(grid_numbers if kname == "grid_tc" else {}))


def grid_tc_direct_pass(ctx, kernels, params, g, nw, occ, hod, pmat, out,
                        flop, n_bytes, dense, lib_ms):
    """grid_tc on the 64-node grid through its wrapper, where no contract
    routes to it: held against the plain version, timed."""
    torch, fused = ctx["torch"], ctx["fused"]
    ctx["reset"]()
    ngal, xi = fused.grid_tc_launch(g, pmat, nw, hod)
    torch.cuda.synchronize()
    launched = ctx["expect"]("grid_tc direct", grid_tc=1)
    # The node weights make xi NaN outside the grid; ngal is the kernel's
    # occupation, finite (the predictor masks it).
    check(bool(torch.isnan(xi[out]).all() and torch.isfinite(ngal).all() and
               torch.isfinite(xi[~out]).all()), "grid_tc direct: NaN rows")
    ngal_p, xi_p = fused.grid_predict_plain(g, params, nw, *occ)
    ngal_err = rel(ngal[~out], ngal_p[~out])
    xi_err = scaled(xi[~out], xi_p[~out])
    err = max_abs((ngal[~out], ngal_p[~out]), (xi[~out], xi_p[~out]))
    print(f"grid64 grid_tc (direct, on no path): vs plain (B={BATCH}): ngal "
          f"max rel {ngal_err:.3e} (<= 1e-6), xi max scaled {xi_err:.3e} "
          f"(<= 1e-6), max abs {err:.3e}")
    check(ngal_err <= 1e-6, f"grid_tc direct: ngal vs plain {ngal_err}")
    check(xi_err <= 1e-6, f"grid_tc direct: xi vs plain {xi_err}")
    k_ms, p_ms, k_w, p_w = ctx["alternate"](
        lambda: fused.grid_tc_launch(g, pmat, nw, hod),
        lambda: fused.grid_predict_plain(g, params, nw, *occ), 3, 2)
    print(f"timing (grid64 grid_tc direct): {k_ms:.4f} ms per {BATCH}-vector "
          f"batch (windows {k_w}), plain PyTorch {p_ms:.4f} ms (windows "
          f"{p_w}) on {ctx['card']}")
    record(kernels, "grid_tc", launched["grid_tc"], max_abs_err=err,
           ms=k_ms, plain_ms=p_ms, **bound(flop, n_bytes, tensor_flop=dense),
           library_ms=lib_ms)


def tier_comparison(ctx, name, g, pmat, nw, hod):
    """The grid kernel (FP64 tensor cores) and grid_tc (3xTF32) on the same
    inputs: the same occupation bit for bit, and their times in turns."""
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    ngal_grid = fused.grid_launch(g, pmat, nw, hod)[0]
    ngal_tc = fused.grid_tc_launch(g, pmat, nw, hod)[0]
    torch.cuda.synchronize()
    check(bool(torch.equal(ngal_grid, ngal_tc)),
          f"{name}: ngal of the grid kernel and grid_tc differ")
    g_w, tc_w = [], []
    for _ in range(2):
        tc_w.append(ctx["window_ms"](
            lambda: fused.grid_tc_launch(g, pmat, nw, hod), 3))
        g_w += [ctx["window_ms"](lambda: fused.grid_launch(g, pmat, nw, hod),
                                 3) for _ in range(2)]
        tc_w.append(ctx["window_ms"](
            lambda: fused.grid_tc_launch(g, pmat, nw, hod), 3))
    print(f"tiers ({name}): ngal of grid and grid_tc bit-identical; grid "
          f"(FP64 tensor cores) {float(np.median(g_w)):.4f} ms (windows "
          f"{g_w}), grid_tc (3xTF32) {float(np.median(tc_w)):.4f} ms "
          f"(windows {tc_w}) per {BATCH}-vector batch on {ctx['card']}")


def grid_elementwise_cross_pass(ctx, name, interp, model, params, out,
                                ngal_p, xi_p):
    """A Delta Sigma grid under the 'elementwise' contract: the grid kernel
    (1104 cross bins, 32-row blocks) on a path, held against the plain
    version (``ngal_p``, ``xi_p``, same inputs).  Returns its launches."""
    torch = ctx["torch"]
    from tabcorr_tpu_torch import make_predictor
    predict = make_predictor(interp, model, engine="fused",
                             accuracy="elementwise", device="cuda")
    ctx["reset"]()
    ngal, xi = predict(params)
    torch.cuda.synchronize()
    launched = ctx["expect"](f"{name} elementwise", grid=1)
    xi = xi.reshape(BATCH, -1)
    check(bool(torch.isnan(ngal[out]).all() and torch.isnan(xi[out]).all()
               and torch.isfinite(ngal[~out]).all() and
               torch.isfinite(xi[~out]).all()),
          f"{name} elementwise: NaN rows")
    ngal_err = rel(ngal[~out], ngal_p[~out])
    xi_err = scaled(xi[~out], xi_p[~out])
    print(f"{name} elementwise: {launched['grid']} grid kernel launch, "
          f"{interp.tabcorr_list[0].n_bins} cross bins; grid kernel vs plain "
          f"(B={BATCH}): ngal max rel {ngal_err:.3e} (<= 1e-6), xi max "
          f"scaled {xi_err:.3e} (<= 1e-6)")
    check(ngal_err <= 1e-6, f"{name} elementwise: ngal vs plain {ngal_err}")
    check(xi_err <= 1e-6, f"{name} elementwise: xi vs plain {xi_err}")
    return launched["grid"]


def grid_elementwise_pass(ctx, kernels, interp, model, params, stacked, g,
                          nw, occ, hod, pmat, out, flop, n_bytes,
                          other_launches):
    """The 64-node grid under the 'elementwise' contract: the grid kernel
    (FP64 tensor cores) on a path, held against the plain version and the
    float64 host path, timed beside the plain version and beside one
    float64 PyTorch product of the same contraction."""
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import make_predictor
    predict = make_predictor(interp, model, engine="fused",
                             accuracy="elementwise", device="cuda")
    ctx["reset"]()
    ngal, xi = predict(params)
    torch.cuda.synchronize()
    launched = ctx["expect"]("grid64 elementwise", grid=1)
    xi = xi.reshape(BATCH, -1)
    check(bool(torch.isnan(ngal[out]).all() and torch.isnan(xi[out]).all()
               and torch.isfinite(ngal[~out]).all() and
               torch.isfinite(xi[~out]).all()),
          "grid64 elementwise: NaN rows")
    ngal_p, xi_p = fused.grid_predict_plain(g, params, nw, *occ)
    ngal_err = rel(ngal[~out], ngal_p[~out])
    xi_err = scaled(xi[~out], xi_p[~out])
    err = max_abs((ngal[~out], ngal_p[~out]), (xi[~out], xi_p[~out]))
    print(f"grid64 elementwise: {launched['grid']} grid kernel launch; grid "
          f"kernel vs plain (B={BATCH}): ngal max rel {ngal_err:.3e} (<= "
          f"1e-6), xi max scaled {xi_err:.3e} (<= 1e-6), max abs {err:.3e}")
    check(ngal_err <= 1e-6, f"grid64 elementwise: ngal vs plain {ngal_err}")
    check(xi_err <= 1e-6, f"grid64 elementwise: xi vs plain {xi_err}")
    err_host = err_ngal = 0.0
    for i in range(N_PROBE):
        ng64, xi64 = interp.predict(host_model(model, params, i),
                                    check_consistency=False)
        got = xi[i].double().cpu().numpy()
        err_host = max(err_host, float(np.max(np.abs(got - xi64.ravel())) /
                                       np.max(np.abs(xi64))))
        err_ngal = max(err_ngal, abs(float(ngal[i]) / ng64 - 1))
    print(f"grid64 elementwise: grid kernel vs float64 Interpolator.predict "
          f"at {N_PROBE} probes: xi max scaled {err_host:.3e} (<= 1e-6), "
          f"ngal max rel {err_ngal:.3e} (<= 1e-6)")
    check(err_host <= 1e-6, f"grid64 elementwise: xi vs float64 {err_host}")
    check(err_ngal <= 1e-6, f"grid64 elementwise: ngal vs float64 {err_ngal}")
    k_ms, p_ms, k_w, p_w = ctx["alternate"](
        lambda: fused.grid_launch(g, pmat, nw, hod),
        lambda: fused.grid_predict_plain(g, params, nw, *occ), 3, 2)
    print(f"timing (grid64 elementwise): grid kernel {k_ms:.4f} ms per "
          f"{BATCH}-vector batch (windows {k_w}), plain PyTorch {p_ms:.4f} "
          f"ms (windows {p_w}) on {ctx['card']}")
    # One float64 PyTorch product for the contraction alone, over the
    # packed pair weights of the whole batch (the float32 products n_i n_j
    # widened, as the kernel forms them): (B, npair) x (npair, columns).
    dens = fused.occupation_density(stacked, model, params)
    w64 = (dens[:, g.pair_i.long()] * dens[:, g.pair_j.long()]).double()
    del dens
    fp64 = g.fp[:g.npair, :g.n_nodes * g.nxp].double()
    lib_ms = ctx["library_ms"](lambda: torch.matmul(w64, fp64))
    print(f"timing (grid64): one float64 torch.matmul {tuple(w64.shape)} x "
          f"{tuple(fp64.shape)} (contraction only) {lib_ms:.4f} ms, "
          f"{2.0 * w64.shape[0] * g.npair * fp64.shape[1] / lib_ms / 1e9:.4g}"
          f" TFLOP/s, on {ctx['card']}")
    del w64, fp64
    record(kernels, "grid", launched["grid"] + other_launches,
           max_abs_err=err, ms=k_ms, plain_ms=p_ms, **bound(flop, n_bytes),
           library_ms=lib_ms)


# ----------------------------------------------------------------------
def contraction_phase(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (AssembiasZheng07Model, TabCorr,
                                   Zheng07Model, make_predictor)

    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    wp_tab = TabCorr.read(data / "bolplanck_wp.npz")
    xi_tab = TabCorr.read(data / "synthetic_xi_ell.npz")
    redshift = wp_tab.attrs["redshift"]
    model = Zheng07Model(threshold=-18, redshift=redshift)
    decorated = AssembiasZheng07Model(threshold=-18, redshift=redshift)
    rng = np.random.default_rng(SEED + 2)
    params = bench_params(model, rng, BATCH, "cuda")
    params_dec = bench_params(decorated, rng, BATCH, "cuda")
    cases = [("wp", wp_tab, model, params), ("xi_ell", xi_tab, model, params),
             ("xi_ell decorated", xi_tab, decorated, params_dec)]
    predictors = [make_predictor(tab, m, engine="fused", device="cuda")
                  for _, tab, m, _ in cases]

    # ---- path -----------------------------------------------------------
    ctx["reset"]()
    outs = [predict(p) for predict, (*_, p) in zip(predictors, cases)]
    torch.cuda.synchronize()
    launched = ctx["expect"]("contraction", contraction=len(cases))
    print(f"contraction path: {launched['contraction']} contraction kernel "
          "launches (make_predictor(engine='fused') on wp, xi_ell, and "
          "xi_ell with the decorated model)")

    max_err = k_total = p_total = lib_total = flop = n_bytes = 0.0
    for (name, tab, m, p), (ngal, xi) in zip(cases, outs):
        check(bool(torch.isfinite(xi).all()), f"{name}: non-finite xi")
        table = tab.table_data(device="cuda")
        c = fused.slab_tc_table_constants(table, 1)
        c_plain = fused.bundle_table_constants(table)
        dens = fused.occupation_density(table, m, p)
        ngal_p, xi_p = fused.contraction_plain(c_plain, dens)
        xi_p = xi_p.reshape(xi.shape)
        ngal_err = rel(ngal, ngal_p)
        is_wp = name == "wp"
        xi_err = rel(xi, xi_p) if is_wp else scaled(xi, xi_p)
        limit = 2e-6 if is_wp else 1e-6
        err = max_abs((ngal, ngal_p), (xi, xi_p))
        print(f"{name}: contraction kernel vs plain (B={BATCH}): ngal max "
              f"rel {ngal_err:.3e} (<= 1e-6), xi max "
              f"{'rel' if is_wp else 'scaled'} {xi_err:.3e} "
              f"(<= {limit:g}), max abs {err:.3e}")
        check(ngal_err <= 1e-6, f"{name}: ngal kernel vs plain {ngal_err}")
        check(xi_err <= limit, f"{name}: xi kernel vs plain {xi_err}")

        err_host = 0.0
        for i in range(N_PROBE):
            want = tab.predict(host_model(m, p, i),
                               check_consistency=False)[1].ravel()
            got = xi[i].double().cpu().numpy().ravel()
            err_host = max(err_host, float(
                np.max(np.abs(got / want - 1)) if is_wp else
                np.max(np.abs(got - want)) / np.max(np.abs(want))))
        print(f"{name}: contraction kernel vs float64 host at {N_PROBE} "
              f"probes: max {'rel' if is_wp else 'scaled'} "
              f"{err_host:.3e} (<= 1e-6)")
        check(err_host <= 1e-6, f"{name}: xi vs float64 {err_host}")

        k_ms, p_ms, k_w, p_w = ctx["alternate"](
            lambda: fused.contraction_launch(c, dens),
            lambda: fused.contraction_plain(c_plain, dens), 10, 2)
        print(f"timing ({name}): contraction kernel {k_ms:.4f} ms per "
              f"{BATCH}-vector batch (windows {k_w}), plain PyTorch "
              f"{p_ms:.4f} ms (windows {p_w}) on {ctx['card']}")
        if m is decorated:
            continue   # the kernels line reports the zheng07 bench tables
        # One PyTorch call for the same quadratic forms: n n^T, then one
        # GEMM against the dense matrices.
        dense = table.tpcf_dense
        lib_ms = ctx["library_ms"](
            lambda: torch.einsum("bi,bj,kij->bk", dens, dens, dense))
        print(f"timing ({name}): one torch.einsum('bi,bj,kij->bk') "
              f"{lib_ms:.4f} ms on {ctx['card']}")
        max_err = max(max_err, err)
        k_total, p_total, lib_total = (k_total + k_ms, p_total + p_ms,
                                       lib_total + lib_ms)
        flop += BATCH * contraction_flop(c.n_bins, c.n_xi, c.auto)
        n_bytes += nbytes(dens, c.b) + BATCH * (1 + c.n_xi) * 4
    record(kernels, "contraction", launched["contraction"],
           max_abs_err=max_err, ms=k_total, plain_ms=p_total,
           **bound(flop, n_bytes), library_ms=lib_total)


# ----------------------------------------------------------------------
def slab_phase(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (AssembiasZheng07Model, make_predictor,
                                   occupation_functions)
    from tabcorr_tpu_torch.mcmc import make_gaussian_logpost_batched
    from tabcorr_tpu_torch.predictor import stacked_grid
    from tabcorr_tpu_torch.utils.synthetic import wide_grid_interpolator

    t0 = time.perf_counter()
    interp = wide_grid_interpolator()
    model = AssembiasZheng07Model(threshold=-20, redshift=0.0)
    model.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    rng = np.random.default_rng(13)
    params = bench_params(model, rng, SLAB_BATCH, "cuda")
    for key, lo, hi in (("alpha_c", 0.05, 0.35), ("alpha_s", 0.85, 1.15),
                        ("log_eta", -0.3, 0.3)):
        v = rng.uniform(lo, hi, SLAB_BATCH)
        v[0] = model.param_dict[key]
        params[key] = torch.tensor(v, dtype=torch.float32, device="cuda")
    params["alpha_c"][list(SLAB_OUT_ROWS)] = 0.5
    predict = make_predictor(interp, model, engine="fused",
                             accuracy="scaled", device="cuda")
    print(f"wide grid: {interp.tabcorr_list[0].n_bins} bins, "
          f"{len(interp.tabcorr_list)} nodes, built and on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- path ------------------------------------------------------------
    ctx["reset"]()
    t0 = time.perf_counter()
    ngal, xi = predict(params)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = ctx["expect"]("wide grid", slab_tc=1)
    launches = launched["slab_tc"]
    xi = xi.reshape(SLAB_BATCH, -1)
    out = torch.zeros(SLAB_BATCH, dtype=torch.bool, device="cuda")
    out[list(SLAB_OUT_ROWS)] = True
    check(bool(torch.isnan(ngal[out]).all() and torch.isnan(xi[out]).all()),
          "wide grid: out-of-grid rows are not all NaN")
    check(bool(torch.isfinite(ngal[~out]).all() and
               torch.isfinite(xi[~out]).all()),
          "wide grid: NaN or inf in rows inside the grid")
    print(f"wide grid: {launches} slab_tc kernel launch, xi {tuple(xi.shape)}, "
          f"rows {SLAB_OUT_ROWS} outside the grid all NaN, the rest finite; "
          f"first call {first_s:.3f} s")

    # ---- kernel against its plain version, per node, same inputs -------
    stacked, n_nodes, _ = stacked_grid(interp, device="cuda")
    s = fused.slab_table_constants(stacked, n_nodes)
    s_tc = fused.slab_tc_table_constants(stacked, n_nodes)
    occ = occupation_functions(model)
    hod = fused.KernelModel.of(model)
    pmat = torch.stack([params[k] for k in hod.param_names], dim=1)
    total_k, nodes_k = fused.slab_tc_launch(s_tc, pmat, hod)
    total_p, nodes_p = fused.slab_predict_plain(s, params, *occ)
    torch.cuda.synchronize()
    ngal_err = rel(total_k, total_p)
    node_err = scaled(nodes_k.reshape(-1, s.n_xi), nodes_p.reshape(-1, s.n_xi))
    err = max_abs((total_k, total_p), (nodes_k, nodes_p))
    print(f"wide grid: slab_tc kernel vs plain (B={SLAB_BATCH}, {n_nodes} "
          f"nodes): ngal max rel {ngal_err:.3e} (<= 1e-6), per-node xi max "
          f"scaled {node_err:.3e} (<= 1e-6), max abs {err:.3e}")
    check(ngal_err <= 1e-6, f"wide grid: ngal kernel vs plain {ngal_err}")
    check(node_err <= 1e-6, f"wide grid: xi kernel vs plain {node_err}")

    # ---- against the float64 host Interpolator.predict ----------------
    err_host = err_ngal = 0.0
    for i in range(N_PROBE):
        ng64, xi64 = interp.predict(host_model(model, params, i),
                                    check_consistency=False)
        got = xi[i].double().cpu().numpy()
        err_host = max(err_host, float(np.max(np.abs(got - xi64.ravel())) /
                                       np.max(np.abs(xi64))))
        err_ngal = max(err_ngal, abs(float(ngal[i]) / ng64 - 1))
    print(f"wide grid: slab route vs float64 Interpolator.predict at "
          f"{N_PROBE} probes: xi max scaled {err_host:.3e} (<= 1e-6), ngal "
          f"max rel {err_ngal:.3e} (<= 1e-6)")
    check(err_host <= 1e-6, f"wide grid: xi vs float64 {err_host}")
    check(err_ngal <= 1e-6, f"wide grid: ngal vs float64 {err_ngal}")

    # ---- timing ----------------------------------------------------------
    k_ms, p_ms, k_w, p_w = ctx["alternate"](
        lambda: fused.slab_tc_launch(s_tc, pmat, hod),
        lambda: fused.slab_predict_plain(s, params, *occ), 3, 1)
    e2e_ms = ctx["window_ms"](lambda: predict(params), 3)
    dense_flop = 2.0 * n_nodes * s.n_xi * s.n_bins ** 2 * SLAB_BATCH
    print(f"timing (wide grid): slab_tc kernel {k_ms:.4f} ms per "
          f"{SLAB_BATCH}-vector batch (windows {k_w}), plain PyTorch "
          f"{p_ms:.4f} ms (windows {p_w}); whole predictor {e2e_ms:.4f} ms "
          f"({SLAB_BATCH / e2e_ms * 1e3:.6g} predictions/s) on {ctx['card']}")
    print(f"wide grid: {dense_flop:.4g} FLOP of dense contraction per batch "
          f"(2 x {n_nodes} x {s.n_xi} x {s.n_bins}^2 per sample): "
          f"{dense_flop / k_ms / 1e9:.4g} TFLOP/s-equivalent in slab_tc "
          f"({s_tc.n_ct} column tiles, {nbytes(s_tc.b) / 1e6:.1f} MB of "
          f"node matrices)")
    dens = fused.occupation_density(stacked, model, params)
    dense = stacked.tpcf_dense
    lib_ms = ctx["library_ms"](
        lambda: torch.einsum("bi,bj,kij->bk", dens, dens, dense))
    print(f"timing (wide grid): one torch.einsum('bi,bj,kij->bk') over all "
          f"{n_nodes} nodes {lib_ms:.4f} ms on {ctx['card']}")
    del dens

    # ---- path: the ensemble sampler over the wide grid ----------------
    names = hod.param_names + ("alpha_c", "alpha_s", "log_eta")
    fiducial = {k: v[:1] for k, v in params.items()}
    data_xi = predict(fiducial)[1][0].double().cpu().numpy().ravel()
    log_prob = make_gaussian_logpost_batched(
        lambda p: [predict(p)], names, model.param_dict, [data_xi],
        [np.diag(1.0 / (0.05 * np.abs(data_xi) + 1e-3) ** 2)], device="cuda")
    walkers = walkers_around(ctx, model, names, SLAB_BATCH, SEED + 3)
    ctx["reset"]()
    accepts, step_s, _ = run_sampler(ctx, log_prob, walkers, N_SLAB_STEPS,
                                     "SLAB_TC_LAUNCHES", SEED + 3)
    launched = ctx["expect"]("wide grid sampler",
                             slab_tc=1 + 2 * N_SLAB_STEPS)
    launches += launched["slab_tc"]
    print(f"wide grid sampler: {launched['slab_tc']} slab_tc kernel launches (1 "
          f"initial log-prob, 2 per step x {N_SLAB_STEPS}), {len(names)} "
          f"sampled parameters, accept fractions {accepts}, "
          f"{SLAB_BATCH / float(np.median(step_s)):.6g} walker-steps/s "
          f"(median of per-step host-clock times {step_s} s) on "
          f"{ctx['card']}")

    flop = SLAB_BATCH * (quadrature_flop(s.n_bins, s.n_gauss) +
                         n_nodes * contraction_flop(s.n_bins, s.n_xi, s.auto)
                         - (n_nodes - 1) * s.n_bins * (s.n_bins + 1) // 2)
    npair = s.n_bins * (s.n_bins + 1) // 2
    tensor_flop = 2.0 * n_nodes * s.n_xi * npair * SLAB_BATCH
    quad = nbytes(pmat, s.logm, s.logm_res, s.sec, s.weight)
    out_bytes = nbytes(total_k, nodes_k)
    record(kernels, "slab_tc", launches, max_abs_err=err, ms=k_ms,
           plain_ms=p_ms, **bound(flop, quad + nbytes(s_tc.b) + out_bytes,
                                  tensor_flop=tensor_flop),
           library_ms=lib_ms)
    del total_k, nodes_k

    # ---- the 'elementwise' route: the FP32 slab kernel -----------------
    predict = make_predictor(interp, model, engine="fused",
                             accuracy="elementwise", device="cuda")
    ctx["reset"]()
    ngal_e, xi_e = predict(params)
    torch.cuda.synchronize()
    launched = ctx["expect"]("wide grid elementwise", slab=1)
    xi_e = xi_e.reshape(SLAB_BATCH, -1)
    check(bool(torch.isnan(xi_e[out]).all() and
               torch.isfinite(xi_e[~out]).all()),
          "wide grid elementwise: NaN rows")
    total_k, nodes_k = fused.slab_launch(s_tc, pmat, hod)
    ngal_err = rel(total_k, total_p)
    node_err = scaled(nodes_k.reshape(-1, s.n_xi), nodes_p.reshape(-1, s.n_xi))
    err = max_abs((total_k, total_p), (nodes_k, nodes_p))
    print(f"wide grid elementwise: {launched['slab']} slab kernel launch; "
          f"slab kernel vs plain (B={SLAB_BATCH}): ngal max rel "
          f"{ngal_err:.3e} (<= 1e-6), per-node xi max scaled {node_err:.3e} "
          f"(<= 1e-6), max abs {err:.3e}")
    check(ngal_err <= 1e-6, f"wide grid elementwise: ngal {ngal_err}")
    check(node_err <= 1e-6, f"wide grid elementwise: xi {node_err}")
    k_w = [ctx["window_ms"](lambda: fused.slab_launch(s_tc, pmat, hod), 2)
           for _ in range(3)]
    k_ms = float(np.median(k_w))
    print(f"timing (wide grid elementwise): slab kernel {k_ms:.4f} ms per "
          f"{SLAB_BATCH}-vector batch (windows {k_w}) on {ctx['card']}")
    record(kernels, "slab", launched["slab"], max_abs_err=err, ms=k_ms,
           plain_ms=p_ms, **bound(flop, quad + nbytes(s_tc.b) + out_bytes),
           library_ms=lib_ms)


# ----------------------------------------------------------------------
# The other HOD families: model code 2 (densities in)
# ----------------------------------------------------------------------
SHMR_SAMPLED = {"Leauthaud11Model": ("smhm_m1_0", "scatter_model_param1",
                                     "alphasat", "bsat", "bcut"),
                "ZuMandelbaum15Model": ("smhm_m1", "smhm_sigma", "alphasat",
                                        "bsat", "bcut")}


def family_params(model, rng, batch):
    """Parameters around an SHMR family's values: log10 M1 +- 0.1, the
    central scatter within +-25% (Leauthaud11 0.15-0.25), alphasat
    0.8-1.2, bsat and bcut +-10%; assembly-bias strengths uniform in
    [-1, 1]; row 0 at the model's values."""
    from tabcorr_tpu_torch import params_batch
    p = model.param_dict
    o = {"alphasat": rng.uniform(0.8, 1.2, batch),
         "bsat": p["bsat"] * rng.uniform(0.9, 1.1, batch),
         "bcut": p["bcut"] * rng.uniform(0.9, 1.1, batch)}
    if "smhm_m1_0" in p:
        o["smhm_m1_0"] = p["smhm_m1_0"] + rng.uniform(-0.1, 0.1, batch)
        o["scatter_model_param1"] = rng.uniform(0.15, 0.25, batch)
    else:
        o["smhm_m1"] = p["smhm_m1"] * 10.0 ** rng.uniform(-0.1, 0.1, batch)
        o["smhm_sigma"] = p["smhm_sigma"] * rng.uniform(0.75, 1.25, batch)
    for name in STRENGTHS:
        if name in p:
            o[name] = rng.uniform(-1.0, 1.0, batch)
    for key in o:
        o[key][0] = p[key]
    return params_batch(model, o, (batch,), device="cuda")


def family_walkers(ctx, model, names, batch, seed):
    """Walkers within 2% of the model's values."""
    torch, np = ctx["torch"], ctx["np"]
    rng = np.random.default_rng(seed)
    v = np.array([model.param_dict[k] for k in names])
    return torch.tensor(v[None, :] * (1.0 + 0.02 * rng.normal(
        size=(batch, len(names)))), dtype=torch.float32, device="cuda")


def median_ms(ctx, fn, n_windows=3, n_iter=1):
    return float(ctx["np"].median([ctx["window_ms"](fn, n_iter)
                                   for _ in range(n_windows)]))


def probe_check(label, got, plain, host, per_element):
    """Errors of the kernel path (``got``) and of the port's plain float32
    engine (``plain``) against the float64 host path (``host(i) -> [(ngal,
    xi), ...]``) at N_PROBE rows; each at most max(1e-6, twice the plain
    engine's).  ``per_element`` flags the tables read per element (wp)."""
    import numpy as np
    errs = {}
    for what, outs in (("kernel", got), ("plain f32", plain)):
        e_ng = e_xi = 0.0
        for i in range(N_PROBE):
            for t, (ng64, xi64) in enumerate(host(i)):
                ng, xi = outs[t]
                x = xi[i].double().cpu().numpy().ravel()
                want = np.ravel(xi64)
                e_ng = max(e_ng, abs(float(ng[i]) / float(ng64) - 1))
                e_xi = max(e_xi, float(
                    np.max(np.abs(x / want - 1)) if per_element[t] else
                    np.max(np.abs(x - want)) / np.max(np.abs(want))))
        errs[what] = (e_ng, e_xi)
    (k_ng, k_xi), (p_ng, p_xi) = errs["kernel"], errs["plain f32"]
    print(f"{label} vs float64 host at {N_PROBE} probes: kernel ngal rel "
          f"{k_ng:.3e}, xi {k_xi:.3e}; plain float32 engine ngal rel "
          f"{p_ng:.3e}, xi {p_xi:.3e} (kernel <= max(1e-6, 2 x plain))")
    check(k_ng <= max(1e-6, 2 * p_ng), f"{label}: ngal vs float64 {k_ng}")
    check(k_xi <= max(1e-6, 2 * p_xi), f"{label}: xi vs float64 {k_xi}")


def kernel_vs_plain(label, got, want, per_element):
    """The kernels' limits on the same densities: ngal 1e-6 relative, wp
    2e-6 relative per element, xi 1e-6 scaled; returns max |error|."""
    ng_err = max(rel(g[0], w[0]) for g, w in zip(got, want))
    xi_err = max((rel if pe else scaled)(g[1], w[1])
                 for g, w, pe in zip(got, want, per_element))
    limit = 2e-6 if any(per_element) else 1e-6
    print(f"{label}: ngal max rel {ng_err:.3e} (<= 1e-6), xi max "
          f"{xi_err:.3e} (<= {limit:g}; wp per element, xi_ell scaled)")
    check(ng_err <= 1e-6, f"{label}: ngal kernel vs plain {ng_err}")
    if len(per_element) > 1:
        for g, w, pe in zip(got, want, per_element):
            err = (rel if pe else scaled)(g[1], w[1])
            check(err <= (2e-6 if pe else 1e-6),
                  f"{label}: xi kernel vs plain {err}")
    else:
        check(xi_err <= limit, f"{label}: xi kernel vs plain {xi_err}")
    return max_abs(*[(g[k], w[k]) for g, w in zip(got, want)
                     for k in (0, 1)])


# Instructions of the occupation kernel's pieces as (FP64 pipe, FP32),
# counted in their SASS by scripts/torch_occupation_sass.py (one probe per
# piece including csrc/occupation.cu, the port's nvcc flags, sm_90a; the
# common line from the entry to the EXIT, less a probe that only loads and
# stores; CUDA 12.8 on the card): the libm calls at their instruction
# counts, not as one operation each.  A float32 Newton step (two exp10f,
# three divisions), the float64 Newton step (two exp10, a division), the
# centrals' erfc, the satellites' power law (exp, exp10), Cacciato09's
# median luminosity (exp10, log1p) and satellite terms (atan, two exp10),
# Gamma(a, x)'s entry, ends and terms (series: a division; continued
# fraction: a division and a reciprocal), the decoration and the
# quadrature FMA.  Tinker13's quiescent fraction is counted from its loops:
# a compare per segment break, an FMA per ordinate and coefficient, the
# Horner FMA, the clip.
OCC_SASS = {
    "node_abscissa": (3, 0), "bisection_step": (0, 21),
    "newton_f32_step": (0, 50), "newton_f64_step": (71, 10),
    "leauthaud11_erfc": (68, 0), "zu15_erfc": (83, 3),
    "satellite_power": (42, 4), "multiply": (1, 0), "tinker13_mix": (3, 0),
    "decorate_bounded": (9, 0), "decorate_unbounded": (5, 0),
    "quadrature_fma": (2, 0), "cacciato09_luminosity": (91, 11),
    "cacciato09_central_erfc": (68, 0),
    "cacciato09_satellite_terms": (86, 4), "gamma_entry": (2, 0),
    "gamma_series_term": (14, 3), "gamma_series_ends": (312, 26),
    "gamma_fraction_term": (28, 4), "gamma_fraction_ends": (61, 4),
    "gamma_negative_a": (62, 6)}
# One H100 SXM at 1.98 GHz: the FP64 pipe, 132 SMs x 64 lanes (34 TFLOP/s
# with an FMA as two operations), and the issue of one warp instruction
# per sub-partition per clock (132 x 4 x 32 lanes), which FP32 and FP64
# instructions share.
PEAK_FP64_INSTR = 17e12
PEAK_ISSUE_INSTR = 33.5e12
BISECT_STEPS = 15
NEWTON_F32_STEPS = 3
GAMMA_TOL = 1e-5          # csrc/occupation.cu kGammaTol


def gamma_instructions(ctx, pcols, y, threshold, chunk=8192):
    """(FP64, FP32) instructions of Gamma(a, x) at the satellites' nodes
    ``y`` (float64, on the card) for every row of the Cacciato09 parameter
    columns ``pcols``: a and x as the kernel forms them, then each call of
    gamma_upper_positive's series or continued fraction run to the
    kernel's stopping rule in float64 tensor ops, its terms counted."""
    torch, np = ctx["torch"], ctx["np"]
    c = {k: np.array(v, np.float64) for k, v in OCC_SASS.items()}
    total = np.zeros(2)
    for lo in range(0, pcols.shape[1], chunk):
        p = pcols[:13, lo:lo + chunk].double()[..., None]
        (log_l0, log_m1, g1, g2, _, a1, a2, log_m2, _, _, _, d1, d2) = p
        t = y - log_m1
        log_lc = log_l0 + g1 * t - (g1 - g2) * (
            t.clamp(min=0.0) + torch.log1p(10.0 ** -t.abs()) / np.log(10.0))
        alpha = -2.0 + a1 * (1.0 - (2.0 / np.pi) * torch.atan(
            a2 * (y - log_m2)))
        log_delta = d1 + d2 * (y - 12.0)
        a = 0.5 * (alpha + 1.0)
        x = (10.0 ** (log_delta + 2.0 * (threshold - (
            log_lc + np.log10(0.562))))).clamp(min=1e-35)
        positive = a >= GAMMA_TOL
        below = ~positive
        blend = below & (a > -GAMMA_TOL)
        calls = [torch.where(positive, a, torch.clamp(a, max=-GAMMA_TOL) +
                             1.0)]
        total += a.numel() * c["gamma_entry"]
        total += int(below.sum()) * c["gamma_negative_a"]
        if bool(blend.any()):
            calls.append(torch.full_like(a[blend], GAMMA_TOL))
        xs = [x, x[blend]]
        for s, xx in zip(calls, xs):
            series = xx < s + 1.0
            total += int(series.sum()) * c["gamma_series_ends"]
            total += int((~series).sum()) * c["gamma_fraction_ends"]
            total += gamma_terms(ctx, s, xx, series)
    return total


def gamma_terms(ctx, s, x, series):
    """(FP64, FP32) instructions of the series' and the continued
    fraction's terms (csrc/occupation.cu gamma_upper_positive) until each
    stops."""
    torch, np = ctx["torch"], ctx["np"]
    c_series = np.array(OCC_SASS["gamma_series_term"], np.float64)
    c_frac = np.array(OCC_SASS["gamma_fraction_term"], np.float64)
    total = np.zeros(2)
    # The series below x = s + 1.
    ap, term = s.clone(), 1.0 / s
    acc, live = term.clone(), series.clone()
    for _ in range(300):
        if not bool(live.any()):
            break
        total += int(live.sum()) * c_series
        ap = ap + 1.0
        term = term * (x / ap)
        acc = acc + term
        live &= ~(term.abs() < acc.abs() * 1e-17)
    # The modified-Lentz continued fraction above it.
    tiny = 1e-300
    bn = x + 1.0 - s
    cc, d = torch.full_like(x, 1.0 / tiny), 1.0 / bn
    live = ~series
    for n in range(1, 300):
        if not bool(live.any()):
            break
        total += int(live.sum()) * c_frac
        an = -n * (n - s)
        bn = bn + 2.0
        d = an * d + bn
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        cc = bn + an / cc
        cc = torch.where(cc.abs() < tiny, torch.full_like(cc, tiny), cc)
        d = 1.0 / d
        live &= ~((d * cc - 1.0).abs() < 1e-16)
    return total


def occupation_bound(ctx, fam, plan, pcols):
    """The least time of the occupation kernel on these inputs: the work
    the node plan needs (each distinct node evaluated once, then per
    output bin and node the decoration and the quadrature FMA; a bisection
    per row, population and block of units), each piece at its SASS count
    (OCC_SASS), the FP64 instructions against the FP64 pipe and the FP64
    and FP32 ones against the issue rate, against the bytes (the
    parameters read once, the densities written once).  Returns the bound
    and the instruction counts."""
    np, fused = ctx["np"], ctx["fused"]
    batch = pcols.shape[1]
    c = {k: np.array(v, np.float64) for k, v in OCC_SASS.items()}
    ng = plan.n_gauss
    first = plan.first_out.cpu().numpy()
    out_table = plan.out_table.cpu().numpy()
    central = plan.out_bin.cpu().numpy() < np.array(plan.n_centrals)[
        out_table]
    unit = np.repeat(np.arange(plan.n_units), np.diff(first))
    cen_u = np.bincount(unit, central, plan.n_units) > 0
    sat_u = np.bincount(unit, ~central, plan.n_units) > 0
    n_cen, n_sat = ng * int(cen_u.sum()), ng * int(sat_u.sum())
    per_row = plan.n_distinct * c["node_abscissa"]
    per_row += ng * (central.sum() * (c["quadrature_fma"] + (
        c["decorate_bounded"] if fam.decorated else 0)) + (~central).sum() * (
        c["quadrature_fma"] + (c["decorate_unbounded"] if fam.decorated
                               else 0)))
    blocks = -(-plan.n_units // fused.occupation_units_per_block(
        plan.n_units, batch))
    inversion = NEWTON_F32_STEPS * c["newton_f32_step"] + c["newton_f64_step"]
    seeds = blocks * BISECT_STEPS * c["bisection_step"]
    extra = np.zeros(2)
    if fam.family in (0, 1):
        erfc = c["leauthaud11_erfc" if fam.family == 0 else "zu15_erfc"]
        n_inv = ng * int((cen_u | (sat_u & fam.modulate)).sum())
        per_row += n_inv * (inversion + erfc) + seeds
        per_row += n_sat * (c["satellite_power"] + (
            c["multiply"] if fam.modulate else 0))
    elif fam.family == 2:
        pops = 1 if fam.sfr else 2
        _, (n_seg, n_coef, n_pts) = fused._spline_on(fam.abscissa,
                                                      pcols.device)
        fq = np.array([n_seg + 2 + n_coef * (n_pts + 1), 0.0])
        per_row += n_cen * (fq + pops * (inversion + c["leauthaud11_erfc"])
                            + c["tinker13_mix" if pops == 2 else "multiply"])
        per_row += pops * seeds
        per_row += n_sat * (pops * c["satellite_power"] +
                            np.array([pops - 1, 0.0]))
    else:
        per_row += plan.n_distinct * c["cacciato09_luminosity"]
        per_row += n_cen * c["cacciato09_central_erfc"]
        per_row += n_sat * c["cacciato09_satellite_terms"]
        y = (plan.node.double() + plan.res.double())[
            ctx["torch"].from_numpy(sat_u).to(plan.node.device)].reshape(-1)
        extra = gamma_instructions(ctx, pcols, y, fam.threshold)
    fp64 = float(per_row[0]) * batch + float(extra[0])
    fp32 = float(per_row[1]) * batch + float(extra[1])
    ops_ms = max(fp64 / PEAK_FP64_INSTR,
                 (fp64 + fp32) / PEAK_ISSUE_INSTR) * 1e3
    n_bytes = 4 * batch * (pcols.shape[0] + sum(plan.n_bins))
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "fp64_instr": fp64, "fp32_instr": fp32}


def occupation_report(ctx, label, fam, plan, pcols, occ_ms):
    """Print the occupation kernel's bound on this path, its share, and
    the plan's distinct and evaluated nodes; returns the bound."""
    b = occupation_bound(ctx, fam, plan, pcols)
    print(f"bound ({label} occupation kernel): {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}; {b['fp64_instr'] / 1e9:.4g} G FP64 and "
          f"{b['fp32_instr'] / 1e9:.4g} G FP32 instructions); kernel "
          f"{occ_ms:.4f} ms at {b['bound_ms'] / occ_ms:.3f} of it; "
          f"{plan.n_distinct} distinct of {plan.n_evaluated} (bin, node) "
          f"abscissae evaluated per row, {plan.n_units} units; "
          f"{pcols.shape[1]} rows on {ctx['card']}")
    return b


def density_errors(got, want):
    """Per element |got - want| / (|want| + 1e-6 of the row's largest
    |want|)."""
    got, want = got.double(), want.double()
    floor = 1e-6 * want.abs().amax(1, keepdim=True)
    return float(((got - want).abs() / (want.abs() + floor)).max())


def occupation_check(ctx, label, plan, consts, tables, tables64, model,
                     params, n_f64=4096):
    """One launch of the occupation kernel over ``plan`` (built from
    ``consts``), each table's densities against its plain version (the
    model's occupation in tensor ops) over the batch, at tabcorr_tpu's
    fused-against-XLA bar (1e-4 relative + 2e-6 of the row's largest
    density), and with the plain version against the float64 tensor path
    on the first ``n_f64`` rows (kernel within 1e-6 there).  Returns the
    kernel's (n_bins, B) densities per table and max |kernel - plain|."""
    torch, fused = ctx["torch"], ctx["fused"]
    fam = fused.OccupationFamily.of(model)
    check(fam is not None, f"{label}: the occupation kernel does not "
          "evaluate the model")
    dens = fused.occupation_launch(plan, fam, fused.family_columns(
        params, fam), consts=consts)
    p64 = {k: v[:n_f64].double() for k, v in params.items()}
    err = 0.0
    for t, (d, table, table64) in enumerate(zip(dens, tables, tables64)):
        plain = fused.occupation_density(table, model, params)
        k_rows = d.t()
        check(bool(torch.isfinite(d).all()),
              f"{label}: non-finite densities")
        diff = (k_rows.double() - plain.double()).abs()
        ratio = float((diff / (1e-4 * plain.double().abs() + 2e-6 *
                               plain.double().abs().amax(1, keepdim=True))
                       ).max())
        want64 = fused.occupation_density(table64, model, p64)
        k_err = density_errors(k_rows[:n_f64], want64)
        p_err = density_errors(plain[:n_f64], want64)
        name = f"{label} table {t}" if len(dens) > 1 else label
        print(f"{name} occupation kernel: against plain {ratio:.3e} of the "
              f"bar (<= 1); against float64 ({n_f64} rows) kernel "
              f"{k_err:.3e} (<= 1e-6), plain float32 {p_err:.3e} (relative, "
              f"floored at 1e-6 of the row's largest)")
        check(ratio <= 1.0, f"{name}: occupation kernel vs plain {ratio}")
        check(k_err <= 1e-6, f"{name}: occupation kernel vs float64 {k_err}")
        err = max(err, float(diff.max()))
        del plain, diff
    return dens, err


def family_phases(ctx, kernels):
    """The SHMR, CLF and quiescent/active families through B1, B2, B3 and
    B4 by model code 2, and code 2 against codes 0/1 on zheng07."""
    t0 = time.perf_counter()
    bundle_family_phase(ctx, kernels)
    grid_family_phase(ctx, kernels)
    contraction_family_phase(ctx, kernels)
    slab_family_phase(ctx, kernels)
    density_in_cross_check(ctx)
    print(f"family phases: {time.perf_counter() - t0:.1f} s")


def bundle_family_phase(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (Leauthaud11Model, TabCorr,
                                   ZuMandelbaum15Model, make_multi_predictor)
    from tabcorr_tpu_torch.mcmc import make_gaussian_logpost_batched

    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    wp_tab = TabCorr.read(data / "bolplanck_wp.npz")
    xi_tab = TabCorr.read(data / "synthetic_xi_ell.npz")
    tabs = (wp_tab, xi_tab)
    tables = [t.table_data(device="cuda") for t in tabs]
    tables64 = [t.table_data(device="cuda", dtype=torch.float64)
                for t in tabs]
    consts = [fused.slab_tc_table_constants(t, 1) for t in tables]
    plain_consts = [fused.bundle_table_constants(t) for t in tables]
    code2 = fused.KernelModel(code=fused.DENSITY_IN)
    models = [Leauthaud11Model(threshold=10.5,
                               redshift=wp_tab.attrs["redshift"]),
              ZuMandelbaum15Model(threshold=10.5, prim_haloprop_key=str(
                  wp_tab.attrs["prim_haloprop_key"]))]
    launches = occ_launches = 0
    for j, model in enumerate(models):
        label = f"bundle {type(model).__name__}"
        params = family_params(model, np.random.default_rng(SEED + 20 + j),
                               BATCH)
        predict = make_multi_predictor(list(tabs), model, device="cuda")
        # ---- path: predict, then the ensemble sampler -------------------
        ctx["reset"]()
        outs = predict(params)
        torch.cuda.synchronize()
        check(fused.BUNDLE_LAUNCHES == 1 and fused.OCCUPATION_LAUNCHES == 1,
              f"{label}: predict did not launch the occupation kernel (once "
              "for both tables) and the bundle kernel")
        for ng, xi in outs:
            check(bool(torch.isfinite(ng).all() and torch.isfinite(xi).all()),
                  f"{label}: non-finite output")
        names = SHMR_SAMPLED[type(model).__name__]
        data_wp = outs[0][1][0].double().cpu().numpy().ravel()
        data_xi = outs[1][1][0].double().cpu().numpy().ravel()
        log_prob = make_gaussian_logpost_batched(
            predict, names, model.param_dict, [data_wp, data_xi],
            [np.diag(1.0 / (0.05 * np.abs(data_wp) + 1e-3) ** 2),
             np.diag(1.0 / (0.05 * np.abs(data_xi) + 1e-3) ** 2)],
            device="cuda")
        walkers = family_walkers(ctx, model, names, BATCH, SEED + 20 + j)
        accepts, step_s, _ = run_sampler(ctx, log_prob, walkers,
                                         N_GRID_STEPS, "BUNDLE_LAUNCHES",
                                         SEED + 20 + j)
        got = ctx["expect"](label, bundle=2 + 2 * N_GRID_STEPS,
                            occupation=2 + 2 * N_GRID_STEPS)
        launches += got["bundle"]
        occ_launches += got["occupation"]
        print(f"{label} path: {got['bundle']} bundle kernel launches (model "
              f"code 2) fed by {got['occupation']} occupation kernel "
              f"launches, {N_GRID_STEPS} ensemble steps x {BATCH} walkers "
              f"over {names}, accept fractions {accepts}, "
              f"{BATCH / float(np.median(step_s)):.6g} walker-steps/s "
              f"(median of per-step host-clock times {step_s} s) on "
              f"{ctx['card']}")
        # ---- the occupation kernel against its plain version: one launch
        # over both tables' node plan (table 0 wp, 1 xi_ell) ---------------
        plan = fused.occupation_plan(consts)
        dens = occupation_check(ctx, label, plan, consts, tables, tables64,
                                model, params)[0]
        # ---- the bundle kernel against its plain version, same densities -
        got_k = fused.bundle_launch(consts, dens, code2)
        want = [fused.contraction_plain(c, d.t())
                for c, d in zip(plain_consts, dens)]
        kernel_vs_plain(f"{label} kernel vs plain (same densities)", got_k,
                        want, (True, False))
        # ---- against float64 at 16 probes, beside the plain engine -------
        plain_engine = make_multi_predictor(list(tabs), model,
                                            device="cuda", engine="plain")
        probe = {k: v[:N_PROBE] for k, v in params.items()}
        probe_check(label, predict(probe), plain_engine(probe),
                    lambda i: [t.predict(host_model(model, params, i),
                                         check_consistency=False)
                               for t in tabs], (True, False))
        # ---- timing: the occupation kernel and its plain version, then
        # the bundle kernel ------------------------------------------------
        fam = fused.OccupationFamily.of(model)
        pcols = fused.family_columns(params, fam)
        occ_ms, plain_occ_ms, occ_w, _ = ctx["alternate"](
            lambda: fused.occupation_launch(plan, fam, pcols),
            lambda: [fused.occupation_density(t, model, params)
                     for t in tables], 3, 1, rounds=2)
        k_ms, p_ms, k_w, p_w = ctx["alternate"](
            lambda: fused.bundle_launch(consts, dens, code2),
            lambda: [fused.contraction_plain(c, d.t())
                     for c, d in zip(plain_consts, dens)], 10, 2)
        e2e_ms = median_ms(ctx, lambda: predict(params))
        print(f"timing ({label}): occupation kernel (both tables, one "
              f"launch) {occ_ms:.4f} ms (windows {occ_w}), its plain version "
              f"(tensor ops) {plain_occ_ms:.4f} ms; bundle kernel (code 2) "
              f"{k_ms:.4f} ms (windows {k_w}), plain contraction "
              f"{p_ms:.4f} ms (windows {p_w}); whole predictor "
              f"{e2e_ms:.4f} ms ({BATCH / e2e_ms * 1e3:.6g} predictions/s) "
              f"per {BATCH}-vector batch on {ctx['card']}")
        occupation_report(ctx, label, fam, plan, pcols, occ_ms)
        del dens, outs
    record(kernels, "bundle", launches)
    record(kernels, "occupation", occ_launches)


def grid_family_phase(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (AssembiasLeauthaud11Model, Interpolator,
                                   Leauthaud11Model, make_predictor)
    from tabcorr_tpu_torch.mcmc import make_gaussian_logpost_batched
    from tabcorr_tpu_torch.predictor import grid_node_weights, stacked_grid
    from tabcorr_tpu_torch.utils.synthetic import grid64_interpolator

    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    code2 = fused.KernelModel(code=fused.DENSITY_IN)
    launches = occ_launches = 0
    interp64 = grid64_interpolator()
    model64 = Leauthaud11Model(threshold=10.5, redshift=float(
        interp64.tabcorr_list[0].attrs["redshift"]))
    model64.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    rng = np.random.default_rng(SEED + 30)
    params64 = family_params(model64, rng, BATCH)
    for key, lo, hi in (("alpha_c", 0.05, 0.35), ("alpha_s", 0.85, 1.15),
                        ("log_eta", -0.3, 0.3)):
        v = rng.uniform(lo, hi, BATCH)
        v[0] = model64.param_dict[key]
        params64[key] = torch.tensor(v, dtype=torch.float32, device="cuda")
    params64["alpha_c"][list(OUT_ROWS)] = 0.5
    interp_ds = Interpolator.read(data / "ds_efficient.npz")
    model_ds = AssembiasLeauthaud11Model(
        threshold=10.5, redshift=0.5, prim_haloprop_key="halo_m258m")
    model_ds.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
    params_ds = family_params(model_ds, rng, BATCH)
    v = rng.uniform(-0.45, 0.45, BATCH)
    v[0] = 0.0
    v[list(OUT_ROWS)] = 0.6
    params_ds["log_eta"] = torch.tensor(v, dtype=torch.float32,
                                        device="cuda")
    out = torch.zeros(BATCH, dtype=torch.bool, device="cuda")
    out[list(OUT_ROWS)] = True
    cases = [("grid64 Leauthaud11", interp64, model64, params64,
              ("scaled",)),
             ("ds_efficient AssembiasLeauthaud11", interp_ds, model_ds,
              params_ds, ("scaled", "elementwise"))]
    for name, interp, model, params, contracts in cases:
        for accuracy in contracts:
            label = f"{name} '{accuracy}'"
            predict = make_predictor(interp, model, engine="fused",
                                     accuracy=accuracy, device="cuda")
            ctx["reset"]()
            ngal, xi = predict(params)
            torch.cuda.synchronize()
            got = ctx["expect"](label, grid=1, occupation=1)
            launches += got["grid"]
            occ_launches += got["occupation"]
            xi = xi.reshape(BATCH, -1)
            check(bool(torch.isnan(ngal[out]).all() and
                       torch.isnan(xi[out]).all() and
                       torch.isfinite(ngal[~out]).all() and
                       torch.isfinite(xi[~out]).all()),
                  f"{label}: NaN rows are not exactly the out-of-grid rows")
            print(f"{label}: 1 occupation kernel and 1 grid kernel launch "
                  f"(model code 2), rows {OUT_ROWS} outside the grid all "
                  f"NaN, the rest finite")
        # ---- the occupation kernel against its plain version ------------
        stacked, n_nodes, _ = stacked_grid(interp, device="cuda")
        g = fused.grid_table_constants(stacked, n_nodes)
        nw = grid_node_weights(interp, params)
        table64 = interp.tabcorr_list[0].table_data(device="cuda",
                                                    dtype=torch.float64)
        (dens,), occ_err = occupation_check(
            ctx, name, g.occupation_plan, [g], [stacked], [table64], model,
            params)
        # ---- the grid kernel against its plain version, same densities --
        total_k, xi_k = fused.grid_launch(g, dens, nw, code2)
        total_p, xi_p = fused.grid_contract_plain(g, dens.t(), nw)
        kernel_vs_plain(f"{name} kernel vs plain (same densities)",
                        [(total_k[~out], xi_k[~out])],
                        [(total_p[~out], xi_p[~out])], (False,))
        # ---- against float64 at 16 probes, beside the plain engine ------
        plain_engine = make_predictor(interp, model, engine="plain",
                                      device="cuda")
        probe = {k: v[:N_PROBE] for k, v in params.items()}
        probe_check(name, [predict(probe)], [plain_engine(probe)],
                    lambda i: [interp.predict(host_model(model, params, i),
                                              check_consistency=False)],
                    (False,))
        # ---- timing -------------------------------------------------------
        hod = fused.KernelModel.of(model)
        occ_ms, plain_occ_ms, occ_w, _ = ctx["alternate"](
            lambda: fused.kernel_densities(g, stacked, model, hod, params),
            lambda: fused.occupation_density(stacked, model, params), 3, 1,
            rounds=2)
        k_ms = median_ms(ctx, lambda: fused.grid_launch(g, dens, nw, code2),
                         n_iter=3)
        e2e_ms = median_ms(ctx, lambda: predict(params))
        print(f"timing ({name}): occupation kernel ({g.n_bins} bins, "
              f"{BATCH} rows) {occ_ms:.4f} ms (windows {occ_w}), its plain "
              f"version (tensor ops, chunks of {fused._OCC_CHUNK} rows) "
              f"{plain_occ_ms:.4f} ms; grid kernel (code 2) {k_ms:.4f} ms, "
              f"whole predictor {e2e_ms:.4f} ms "
              f"({BATCH / e2e_ms * 1e3:.6g} predictions/s) on {ctx['card']}")
        occ_bound = occupation_report(
            ctx, name, hod.family, g.occupation_plan,
            fused.family_columns(params, hod.family), occ_ms)
        if interp is interp_ds:
            occ_numbers = dict(
                max_abs_err=occ_err, ms=occ_ms, plain_ms=plain_occ_ms,
                bound_ms=occ_bound["bound_ms"],
                bound_by=occ_bound["bound_by"], library_ms=None)
            # ---- the decoration moves Delta Sigma -----------------------
            p = {k: v[:4096].clone() for k, v in params.items()}
            p["log_eta"].fill_(0.0)
            moved = {}
            for strength in (0.0, 0.8):
                for key in STRENGTHS:
                    p[key].fill_(strength)
                moved[strength] = predict(p)[1].reshape(4096, -1)
            d = (moved[0.8] - moved[0.0]).double().abs().amax(1) / \
                moved[0.0].double().abs().amax(1)
            print(f"{name}: strength 0.8 against 0 moves Delta Sigma by "
                  f"{float(d.min()):.3e} to {float(d.max()):.3e} scaled over "
                  f"4096 rows (> 1e-4)")
            check(float(d.min()) > 1e-4,
                  f"{name}: the decoration does not move Delta Sigma")
        del dens, xi_k, xi_p
    # ---- path: the ensemble sampler over the 64-node grid ---------------
    predict = make_predictor(interp64, model64, engine="fused",
                             accuracy="scaled", device="cuda")
    names = SHMR_SAMPLED["Leauthaud11Model"] + ("alpha_c", "alpha_s")
    fiducial = {k: v[:1] for k, v in params64.items()}
    data_xi = predict(fiducial)[1][0].double().cpu().numpy().ravel()
    log_prob = make_gaussian_logpost_batched(
        lambda p: [predict(p)], names, model64.param_dict, [data_xi],
        [np.diag(1.0 / (0.05 * np.abs(data_xi) + 1e-3) ** 2)], device="cuda")
    walkers = family_walkers(ctx, model64, names, BATCH, SEED + 31)
    ctx["reset"]()
    accepts, step_s, _ = run_sampler(ctx, log_prob, walkers, N_GRID_STEPS,
                                     "GRID_LAUNCHES", SEED + 31)
    got = ctx["expect"]("grid64 Leauthaud11 sampler",
                        grid=1 + 2 * N_GRID_STEPS,
                        occupation=1 + 2 * N_GRID_STEPS)
    occ_launches += got["occupation"]
    got = got["grid"]
    launches += got
    print(f"grid64 Leauthaud11 sampler: {got} grid kernel launches, "
          f"{len(names)} sampled parameters, accept fractions {accepts}, "
          f"{BATCH / float(np.median(step_s)):.6g} walker-steps/s (median of "
          f"per-step host-clock times {step_s} s) on {ctx['card']}")
    record(kernels, "grid", launches)
    record(kernels, "occupation", occ_launches, **occ_numbers)


def contraction_family_phase(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (Cacciato09Model, TabCorr, Tinker13Model,
                                   make_predictor, params_batch)

    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    wp_tab = TabCorr.read(data / "bolplanck_wp.npz")
    xi_tab = TabCorr.read(data / "synthetic_xi_ell.npz")
    cases = [
        ("wp Cacciato09", wp_tab, Cacciato09Model(
            threshold=10.0,
            prim_haloprop_key=str(wp_tab.attrs["prim_haloprop_key"]))),
        ("xi_ell Tinker13 quiescent", xi_tab, Tinker13Model(
            threshold=10.5, sfr_designation="quiescent",
            redshift=xi_tab.attrs["redshift"]))]
    rng = np.random.default_rng(SEED + 40)
    inputs = []
    for name, tab, model in cases:
        # Every parameter within ~1% of its value; row 0 at the values.
        o = {k: v + 0.01 * abs(v) * rng.normal(size=BATCH)
             for k, v in model.param_dict.items()}
        for k, v in model.param_dict.items():
            o[k][0] = v
        inputs.append((name, tab, model,
                       params_batch(model, o, (BATCH,), device="cuda"),
                       make_predictor(tab, model, engine="fused",
                                      device="cuda")))
    # ---- path ---------------------------------------------------------------
    ctx["reset"]()
    outs = [predict(p) for *_, p, predict in inputs]
    torch.cuda.synchronize()
    got = ctx["expect"]("contraction families", contraction=len(cases),
                        occupation=len(cases))
    launched = got["contraction"]
    print(f"contraction families path: {launched} contraction kernel "
          f"launches fed by {got['occupation']} occupation kernel launches "
          f"(make_predictor(engine='fused'): Cacciato09 on wp, Tinker13 on "
          f"xi_ell)")
    for (name, tab, model, params, predict), (ngal, xi) in zip(inputs, outs):
        check(bool(torch.isfinite(ngal).all() and torch.isfinite(xi).all()),
              f"{name}: non-finite output")
        is_wp = tab is wp_tab
        table = tab.table_data(device="cuda")
        c = fused.slab_tc_table_constants(table, 1)
        c_plain = fused.bundle_table_constants(table)
        table64 = tab.table_data(device="cuda", dtype=torch.float64)
        dens = occupation_check(ctx, name, c.occupation_plan, [c], [table],
                                [table64], model, params)[0][0].t(
                                ).contiguous()
        kernel_vs_plain(f"{name} kernel vs plain (same densities)",
                        [fused.contraction_launch(c, dens)],
                        [fused.contraction_plain(c_plain, dens)], (is_wp,))
        plain_engine = make_predictor(tab, model, engine="plain",
                                      device="cuda")
        probe = {k: v[:N_PROBE] for k, v in params.items()}
        probe_check(name, [predict(probe)], [plain_engine(probe)],
                    lambda i: [tab.predict(host_model(model, params, i),
                                           check_consistency=False)],
                    (is_wp,))
        hod = fused.KernelModel.of(model)
        occ_ms, plain_occ_ms, _, _ = ctx["alternate"](
            lambda: fused.kernel_densities(c, table, model, hod, params,
                                           bin_major=False),
            lambda: fused.occupation_density(table, model, params), 3, 1,
            rounds=1)
        k_ms = median_ms(ctx, lambda: fused.contraction_launch(c, dens),
                         n_iter=10)
        print(f"timing ({name}): occupation kernel {occ_ms:.4f} ms, its "
              f"plain version (tensor ops) {plain_occ_ms:.4f} ms, "
              f"contraction kernel {k_ms:.4f} ms per {BATCH}-vector batch "
              f"on {ctx['card']}")
        occupation_report(ctx, name, hod.family, c.occupation_plan,
                          fused.family_columns(params, hod.family), occ_ms)
        del dens
    record(kernels, "contraction", launched)
    record(kernels, "occupation", got["occupation"])


def slab_family_phase(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (AssembiasZuMandelbaum15Model,
                                   make_predictor)
    from tabcorr_tpu_torch.mcmc import make_gaussian_logpost_batched
    from tabcorr_tpu_torch.predictor import stacked_grid
    from tabcorr_tpu_torch.utils.synthetic import wide_grid_interpolator

    interp = wide_grid_interpolator()
    model = AssembiasZuMandelbaum15Model(threshold=10.5, redshift=0.0)
    model.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    rng = np.random.default_rng(SEED + 50)
    params = family_params(model, rng, SLAB_BATCH)
    for key, lo, hi in (("alpha_c", 0.05, 0.35), ("alpha_s", 0.85, 1.15),
                        ("log_eta", -0.3, 0.3)):
        v = rng.uniform(lo, hi, SLAB_BATCH)
        v[0] = model.param_dict[key]
        params[key] = torch.tensor(v, dtype=torch.float32, device="cuda")
    params["alpha_c"][list(SLAB_OUT_ROWS)] = 0.5
    out = torch.zeros(SLAB_BATCH, dtype=torch.bool, device="cuda")
    out[list(SLAB_OUT_ROWS)] = True
    label = "wide grid AssembiasZuMandelbaum15"
    code2 = fused.KernelModel(code=fused.DENSITY_IN)
    predict = make_predictor(interp, model, engine="fused",
                             accuracy="scaled", device="cuda")
    # ---- path: 'scaled' (slab_tc), then the sampler ------------------------
    ctx["reset"]()
    ngal, xi = predict(params)
    torch.cuda.synchronize()
    launches = ctx["expect"](label, slab_tc=1, occupation=1)["slab_tc"]
    occ_launches = 1
    xi = xi.reshape(SLAB_BATCH, -1)
    check(bool(torch.isnan(ngal[out]).all() and torch.isnan(xi[out]).all()
               and torch.isfinite(ngal[~out]).all() and
               torch.isfinite(xi[~out]).all()),
          f"{label}: NaN rows are not exactly the out-of-grid rows")
    names = SHMR_SAMPLED["ZuMandelbaum15Model"] + STRENGTHS
    fiducial = {k: v[:1] for k, v in params.items()}
    data_xi = predict(fiducial)[1][0].double().cpu().numpy().ravel()
    log_prob = make_gaussian_logpost_batched(
        lambda p: [predict(p)], names, model.param_dict, [data_xi],
        [np.diag(1.0 / (0.05 * np.abs(data_xi) + 1e-3) ** 2)], device="cuda")
    walkers = family_walkers(ctx, model, names, SLAB_BATCH, SEED + 51)
    walkers[:, -2:] = torch.rand_like(walkers[:, -2:]) * 1.6 - 0.8
    ctx["reset"]()
    accepts, step_s, _ = run_sampler(ctx, log_prob, walkers, N_SLAB_STEPS,
                                     "SLAB_TC_LAUNCHES", SEED + 51)
    got = ctx["expect"](f"{label} sampler", slab_tc=1 + 2 * N_SLAB_STEPS,
                        occupation=1 + 2 * N_SLAB_STEPS)
    occ_launches += got["occupation"]
    got = got["slab_tc"]
    launches += got
    print(f"{label}: 'scaled' path 1 slab_tc launch (model code 2), rows "
          f"{SLAB_OUT_ROWS} NaN; sampler {got} slab_tc launches, "
          f"{len(names)} sampled parameters, accept fractions {accepts}, "
          f"{SLAB_BATCH / float(np.median(step_s)):.6g} walker-steps/s "
          f"(median of per-step host-clock times {step_s} s) on "
          f"{ctx['card']}")
    # ---- path: one 'elementwise' pass (slab) -------------------------------
    predict_e = make_predictor(interp, model, engine="fused",
                               accuracy="elementwise", device="cuda")
    ctx["reset"]()
    ngal_e, xi_e = predict_e(params)
    torch.cuda.synchronize()
    slab_launches = ctx["expect"](f"{label} elementwise", slab=1,
                                  occupation=1)["slab"]
    occ_launches += 1
    xi_e = xi_e.reshape(SLAB_BATCH, -1)
    check(bool(torch.isnan(xi_e[out]).all() and
               torch.isfinite(xi_e[~out]).all()),
          f"{label} elementwise: NaN rows")
    # ---- both tiers against the plain version, same densities ---------------
    stacked, n_nodes, _ = stacked_grid(interp, device="cuda")
    s_tc = fused.slab_tc_table_constants(stacked, n_nodes)
    s = fused.slab_table_constants(stacked, n_nodes)
    table64 = interp.tabcorr_list[0].table_data(device="cuda",
                                                dtype=torch.float64)
    (dens,), _ = occupation_check(ctx, label, s_tc.occupation_plan, [s_tc],
                                  [stacked], [table64], model, params)
    want = fused.slab_contract_plain(s, dens.t())
    for tier, launch in (("slab_tc", fused.slab_tc_launch),
                         ("slab", fused.slab_launch)):
        total, nodes = launch(s_tc, dens, code2)
        kernel_vs_plain(f"{label} {tier} vs plain (same densities)",
                        [(total, nodes.reshape(-1, s.n_xi))],
                        [(want[0], want[1].reshape(-1, s.n_xi))], (False,))
    plain_engine = make_predictor(interp, model, engine="plain",
                                  device="cuda")
    probe = {k: v[:N_PROBE] for k, v in params.items()}
    probe_check(label, [predict(probe)], [plain_engine(probe)],
                lambda i: [interp.predict(host_model(model, params, i),
                                          check_consistency=False)],
                (False,))
    hod = fused.KernelModel.of(model)
    occ_ms, plain_occ_ms, _, _ = ctx["alternate"](
        lambda: fused.kernel_densities(s_tc, stacked, model, hod, params),
        lambda: fused.occupation_density(stacked, model, params), 3, 1,
        rounds=2)
    tc_ms = median_ms(ctx, lambda: fused.slab_tc_launch(s_tc, dens, code2))
    fp32_ms = median_ms(ctx, lambda: fused.slab_launch(s_tc, dens, code2))
    e2e_ms = median_ms(ctx, lambda: predict(params))
    print(f"timing ({label}): occupation kernel {occ_ms:.4f} ms, its plain "
          f"version (tensor ops) {plain_occ_ms:.4f} ms, slab_tc (code 2) "
          f"{tc_ms:.4f} ms, slab (code 2) {fp32_ms:.4f} ms, whole 'scaled' "
          f"predictor {e2e_ms:.4f} ms "
          f"({SLAB_BATCH / e2e_ms * 1e3:.6g} predictions/s) per "
          f"{SLAB_BATCH}-vector batch on {ctx['card']}")
    occupation_report(ctx, label, hod.family, s_tc.occupation_plan,
                      fused.family_columns(params, hod.family), occ_ms)
    record(kernels, "slab_tc", launches)
    record(kernels, "slab", slab_launches)
    record(kernels, "occupation", occ_launches)


def density_in_cross_check(ctx):
    """Model code 2 fed zheng07's tensor-op densities against code 0 (and
    the decorated model's against code 1) on the same rows: the bundle on
    the wp + xi_ell tables, the grid kernel on the 64-node grid with the
    fold, both slab tiers on the wide grid.  Limits: ngal 1e-6 relative,
    wp 2e-6 per element, xi 1e-6 scaled."""
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (AssembiasZheng07Model, TabCorr,
                                   Zheng07Model)
    from tabcorr_tpu_torch.predictor import grid_node_weights, stacked_grid
    from tabcorr_tpu_torch.utils.synthetic import (grid64_interpolator,
                                                   wide_grid_interpolator)

    code2 = fused.KernelModel(code=fused.DENSITY_IN)
    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    tabs = [TabCorr.read(data / f) for f in ("bolplanck_wp.npz",
                                             "synthetic_xi_ell.npz")]
    tables = [t.table_data(device="cuda") for t in tabs]
    model = Zheng07Model(threshold=-18, redshift=tabs[0].attrs["redshift"])
    params = bench_params(model, np.random.default_rng(SEED + 60), BATCH,
                          "cuda")
    hod = fused.KernelModel.of(model)
    pmat = torch.stack([params[k] for k in hod.param_names], dim=1)
    consts = [fused.slab_tc_table_constants(t, 1) for t in tables]
    dens = [fused.occupation_density(t, model, params).t().contiguous()
            for t in tables]
    kernel_vs_plain("cross-check bundle: code 2 against code 0",
                    fused.bundle_launch(consts, dens, code2),
                    fused.bundle_launch(consts, pmat, hod), (True, False))
    del dens

    interp = grid64_interpolator()
    model = Zheng07Model(threshold=-20, redshift=0.0)
    model.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    rng = np.random.default_rng(SEED + 61)
    params = bench_params(model, rng, BATCH, "cuda")
    for key, lo, hi in (("alpha_c", 0.05, 0.35), ("alpha_s", 0.85, 1.15),
                        ("log_eta", -0.3, 0.3)):
        params[key] = torch.tensor(rng.uniform(lo, hi, BATCH),
                                   dtype=torch.float32, device="cuda")
    stacked, n_nodes, _ = stacked_grid(interp, device="cuda")
    g = fused.grid_table_constants(stacked, n_nodes)
    nw = grid_node_weights(interp, params)
    pmat = torch.stack([params[k] for k in hod.param_names], dim=1)
    dens = fused.occupation_density(stacked, model, params).t().contiguous()
    kernel_vs_plain("cross-check grid64: code 2 against code 0",
                    [fused.grid_launch(g, dens, nw, code2)],
                    [fused.grid_launch(g, pmat, nw, hod)], (False,))
    del dens

    interp = wide_grid_interpolator()
    model = AssembiasZheng07Model(threshold=-20, redshift=0.0)
    params = bench_params(model, np.random.default_rng(SEED + 62),
                          SLAB_BATCH, "cuda")
    hod = fused.KernelModel.of(model)
    pmat = torch.stack([params[k] for k in hod.param_names], dim=1)
    stacked, n_nodes, _ = stacked_grid(interp, device="cuda")
    s_tc = fused.slab_tc_table_constants(stacked, n_nodes)
    dens = fused.occupation_density(stacked, model, params).t().contiguous()
    for tier, launch in (("slab_tc", fused.slab_tc_launch),
                         ("slab", fused.slab_launch)):
        a = launch(s_tc, dens, code2)
        b = launch(s_tc, pmat, hod)
        kernel_vs_plain(f"cross-check wide grid {tier}: code 2 against "
                        f"code 1", [(a[0], a[1].reshape(-1, s_tc.n_xi))],
                        [(b[0], b[1].reshape(-1, s_tc.n_xi))], (False,))


# ----------------------------------------------------------------------
# Tabulation: TabCorr.tabulate through the CUDA pair counter
# ----------------------------------------------------------------------
TAB_HALOS = 200_000
TAB_LBOX = 250.0           # Bolshoi-Planck's box [Mpc/h]
TAB_PARTICLES = 1_000_000
TAB_SUBSAMPLE = 65_536
TAB_BRUTE = 5_000
# The clustered catalog: the same hosts around 4,000 uniform centres
# (utils.synthetic.synthetic_halocat, offsets of CLUMP_RADIUS).
TAB_CLUMPS = 4_000
# i-labels whose histogram rows are held against the plain version at
# full size: the first, the middle and the last label with tracers.
TAB_SLICES = 3
# Instruction throughput of one H100 SXM (132 SMs x 4 schedulers x 32
# lanes x 1.98 GHz): FP32 and integer lane operations alike.
PEAK_LANE_OPS = 33.5e12


def bound_ops(sweep):
    """Lane operations (FP32 and integer alike) the sweep needs, counted
    for the function over the z-window's candidate pairs, not as
    tabcorr_tpu's ``_tile_geometry`` writes it (a compare and an add for
    every edge on every pair).  Returns (a, b, c): a for every candidate,
    b more for a candidate within pi_max (rppi), c more for a kept pair.

    An axis costs 3: the difference and the minimum image as a compare
    and a conditional subtract.  Every candidate: the self test (auto, 1)
    and its rejection path -- rppi: the z axis and |dz| < pi_max (4),
    then, within pi_max, x, y, rp^2 (two products, a sum) and its two
    range tests (11); smu: three axes, rp^2, s^2 (a product, a sum) and
    its two range tests (16); proj: x, y, rp^2 and its range tests (11).
    A kept pair: its radial bin by a branch-free binary search over the
    edges (a compare and a select a halving); for smu also the root, the
    guarded division (2), the mu search, its clip (2) and the flat
    sub-bin; then the cell's address and one add a channel, and ln(rp)
    for a log_rp channel (the clamp, the log, two products)."""
    def search(n_edges):
        return 2 * math.ceil(math.log2(n_edges + 1))

    a = (1 if sweep.auto else 0) + {"rppi": 4, "smu": 16,
                                    "proj": 11}[sweep.kind]
    b = 11 if sweep.kind == "rppi" else 0
    c = search(sweep.n_r + 1) + 1 + sweep.n_channels
    if sweep.kind == "smu":
        c += 1 + 2 + search(sweep.n_mu + 1) + 2 + 1
    if sweep.pair_weight != "unit":
        c += 4
    return a, b, c


def within_pi_max(sweep, layout):
    """rppi: the candidate pairs with |dz| < pi_max (periodic, counted in
    float64 on the layout's z).  Every ordered pair of distinct labeled
    tracers that close in z is a candidate of the z-window."""
    if sweep.kind != "rppi":
        return 0
    if sweep.z_cut is None:     # 2 pi_max >= period_z: all of them
        return layout.candidates
    import torch
    pz = sweep.period[2]
    z1 = layout.pos1[:, 2].double()
    z2 = torch.sort(layout.pos2[:, 2].double()).values
    zz = torch.cat([z2 - pz, z2, z2 + pz])
    n = (torch.searchsorted(zz, z1 + sweep.pi_max) -
         torch.searchsorted(zz, z1 - sweep.pi_max, right=True)).sum()
    return int(n) - (len(z1) if sweep.auto else 0)


def valid_pairs(sweep, hist):
    """The kept pairs of a sweep: its unit counts, or its weight channel
    where every weight is 1 (float64 sums of ones are exact)."""
    check(sweep.unit_counts or (sweep.pair_weight != "log_rp" and
                                bool((sweep.j_side()[2] == 1).all())),
          "kept pairs of a sweep with unequal weights")
    return int(hist[:sweep.n_hist].sum())


def paircount_bound(sweep, layout, valid):
    """The least time for a sweep: :func:`bound_ops` over its candidates,
    those within pi_max and its kept pairs, at PEAK_LANE_OPS, against the
    bytes (each tracer's 16-byte record and label read once, the
    histogram written once); returns (bound dict, ops, bytes)."""
    a, b, c = bound_ops(sweep)
    ops = (a * layout.candidates + b * within_pi_max(sweep, layout) +
           c * valid)
    n2 = 0 if sweep.auto else len(sweep.pos2)
    n_bytes = (20 * (len(sweep.pos1) + n2) +
               8 * sweep.n_channels * sweep.n_hist)
    ops_ms = ops / PEAK_LANE_OPS * 1e3
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    return ({"bound_ms": max(ops_ms, bytes_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"},
            ops, n_bytes)


def subsample(ctx, sweep, n, seed):
    """``sweep`` on ``n`` random tracers of each side (all labels kept)."""
    torch = ctx["torch"]
    g = torch.Generator(device=sweep.device).manual_seed(seed)

    def pick(m):
        return torch.randperm(m, generator=g, device=sweep.device)[:n]

    i1 = pick(len(sweep.pos1))
    out = dataclasses.replace(sweep, pos1=sweep.pos1[i1].contiguous(),
                              labels1=sweep.labels1[i1].contiguous())
    if sweep.auto:
        if sweep.weights2 is not None:
            out = dataclasses.replace(
                out, weights2=sweep.weights2[i1].contiguous())
        return out
    i2 = pick(len(sweep.pos2))
    return dataclasses.replace(
        out, pos2=sweep.pos2[i2].contiguous(),
        labels2=sweep.labels2[i2].contiguous(),
        weights2=None if sweep.weights2 is None else
        sweep.weights2[i2].contiguous())


def hist_errors(got, want, unit_counts):
    """Unit counts: the number of unequal cells.  Weighted: the largest
    |got - want| / max(|want|, 1e-7 max |want|)."""
    if unit_counts:
        return int((got != want).sum())
    floor = 1e-7 * float(want.abs().max())
    return float(((got - want).abs() /
                  want.abs().clamp(min=floor)).max())


def label_slices(ctx, label, sweep, hist):
    """Hold the main path's own histogram against the plain version at
    full size: for TAB_SLICES i-labels (the first, the middle and the last
    with tracers), the plain version in cross mode with that label's
    tracers against every j-tracer must give that label's rows (unit
    counts equal, weighted cells within 1e-7).  An auto sweep's
    self-pairs fall out of the cross sweep because its smallest edge is
    above 0."""
    torch, np, pc = ctx["torch"], ctx["np"], ctx["paircount"]
    check(not sweep.auto or float(sweep.edges_sq[0]) > 0,
          f"{label}: an auto sweep with an edge at 0")
    pos2, labels2, _ = sweep.j_side()
    sizes = torch.bincount(sweep.labels1[sweep.labels1 >= 0].long(),
                           minlength=sweep.n_labels_1).cpu().numpy()
    full = np.flatnonzero(sizes)
    picks = sorted({int(full[k]) for k in
                    np.linspace(0, len(full) - 1, TAB_SLICES).round()
                    .astype(int)})
    rows = hist.reshape(sweep.n_channels, sweep.n_labels_1, -1)
    errs = []
    t0 = time.perf_counter()
    for l1 in picks:
        keep = sweep.labels1 == l1
        one = dataclasses.replace(
            sweep, pos1=sweep.pos1[keep].contiguous(),
            labels1=torch.zeros(int(keep.sum()), dtype=torch.int32,
                                device=sweep.device),
            n_labels_1=1, pos2=pos2, labels2=labels2,
            weights2=sweep.weights2)
        want = pc.paircount_plain(one).reshape(sweep.n_channels, -1)
        errs.append(hist_errors(rows[:, l1], want, sweep.unit_counts))
    torch.cuda.synchronize()
    print(f"tabulation {label}: full-size rows of i-labels {picks} "
          f"({[int(sizes[k]) for k in picks]} tracers) against the plain "
          f"version, each label's tracers x all {len(pos2)} j-tracers: "
          f"{errs} {'cells unequal' if sweep.unit_counts else 'max rel'} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(all(e == 0 if sweep.unit_counts else e <= 1e-7 for e in errs),
          f"{label}: full-size rows vs plain {errs}")


def brute_force_check(ctx, label, sweep):
    """The kernel against float64 binning on TAB_BRUTE tracers (one side,
    auto), cell by cell: a cell may differ only by the pairs that lie near
    an edge and could fall into it.  A pair is near when moving one of its
    binned quantities (rp^2 or s^2, |dz| against pi_max, mu) by n float32
    ulp changes its cell.  The allowance takes n = 4: float32 rp^2 carries
    up to ~3.5 ulp of rounding against float64 (the difference, the
    minimum image, two squares and a sum), mu a little more.  Returns
    (differing pair counts, pairs near at one ulp, at four)."""
    np, pc = ctx["np"], ctx["paircount"]
    import itertools
    sub = subsample(ctx, sweep, TAB_BRUTE, SEED + 90)
    got = pc.paircount_launch(sub).cpu().numpy()
    p = sub.pos1.double().cpu().numpy()
    lab = sub.labels1.cpu().numpy().astype(np.int64)
    per = np.array(sub.period)
    d = p[:, None, :] - p[None, :, :]
    d -= per * np.round(d / per)
    rp_sq = d[..., 0] ** 2 + d[..., 1] ** 2
    dz = np.abs(d[..., 2])
    # The sweep bins against its float32 squared edges (rounded once from
    # float64): the same values, in float64.
    e_sq = sub.edges_sq.astype(np.float64)
    ok = (lab[:, None] >= 0) & (lab[None, :] >= 0)
    np.fill_diagonal(ok, False)
    pair_cell = (lab[:, None] * sub.n_labels_2 + lab[None, :]) * sub.n_hist_r
    if sub.kind == "smu":
        s_sq = rp_sq + dz ** 2
        s = np.sqrt(s_sq)
        mu_e = sub.mu_edges.astype(np.float64)
        qs = [s_sq, np.where(s > 0, dz / np.maximum(s, 1e-300), 0.0)]
        edges = [e_sq, mu_e]

        def cell(q, base):
            r_bin = np.searchsorted(e_sq, q[0], side="right") - 1
            mu_bin = np.clip(np.searchsorted(mu_e, q[1], side="right") - 1,
                             0, sub.n_mu - 1)
            keep = (r_bin >= 0) & (r_bin < sub.n_r) & (q[0] > 0)
            return np.where(keep, base + r_bin * sub.n_mu + mu_bin, -1)
    else:
        qs = [rp_sq, dz]
        edges = [e_sq, np.array([sub.pi_max], dtype=np.float64)]

        def cell(q, base):
            r_bin = np.searchsorted(e_sq, q[0], side="right") - 1
            keep = (r_bin >= 0) & (r_bin < sub.n_r) & (q[1] < sub.pi_max)
            return np.where(keep, base + r_bin, -1)

    want_cell = np.where(ok, cell(qs, pair_cell), -1)
    want = np.bincount(want_cell[want_cell >= 0], minlength=sub.n_hist)
    # Pairs that might move: within ten ulp (at the edge) of an edge.
    maybe = np.zeros(rp_sq.shape, dtype=bool)
    for q, es in zip(qs, edges):
        for e in es:
            maybe |= np.abs(q - e) <= 10 * float(np.spacing(np.float32(e)))
    maybe &= ok
    q_m = [q[maybe] for q in qs]
    base_m, want_m = pair_cell[maybe], want_cell[maybe]
    ulp_m = [np.spacing(q.astype(np.float32)).astype(np.float64)
             for q in q_m]
    near, reach = {}, None
    for n_ulp in (1, 4):
        moved = np.zeros(len(base_m), dtype=bool)
        cells = [want_m]
        for ks in itertools.product((-1, 0, 1), repeat=len(qs)):
            c = cell([q + k * n_ulp * u for q, k, u in zip(q_m, ks, ulp_m)],
                     base_m)
            moved |= c != want_m
            cells.append(c)
        near[n_ulp] = int(moved.sum())
        reach = np.stack(cells)[:, moved]
    # Each near pair allows one count of difference in every cell it
    # could fall into.
    allow = np.zeros(sub.n_hist, dtype=np.int64)
    for col in range(reach.shape[1]):
        cs = np.unique(reach[:, col])
        allow[cs[cs >= 0]] += 1
    off = np.abs(got - want)
    diff = int(off.sum())
    print(f"tabulation {label}: kernel vs float64 brute force on "
          f"{TAB_BRUTE} tracers ({int(want.sum())} pairs): {diff} pair "
          f"counts differ, in {int((off > 0).sum())} cells; {near[1]} "
          f"ordered pairs lie within one float32 ulp of a cell's edge, "
          f"{near[4]} within four (each cell differs by no more than the "
          f"four-ulp pairs that could fall into it)")
    check(bool((off <= allow).all()), f"{label}: brute force differs by "
          f"{int((off - allow).max())} beyond its near-edge pairs in a cell")
    return diff, near[1]


def tabulation_sweep_report(ctx, label, rec):
    """Print one sweep's numbers and hold the kernel against its plain
    version on a TAB_SUBSAMPLE subsample; returns the subsample's kernel
    and plain ms, its bound and its error, and the main path's kernel ms
    and bound."""
    torch, pc = ctx["torch"], ctx["paircount"]
    sweep, layout = rec["sweep"], rec["layout"]
    kernel_ms = rec["sweep_s"] * 1e3
    valid = valid_pairs(sweep, rec["hist"])
    near = within_pi_max(sweep, layout)
    b, ops, n_bytes = paircount_bound(sweep, layout, valid)
    a, bz, c = bound_ops(sweep)
    print(f"tabulation {label}: {len(sweep.pos1)} i-tracers x "
          f"{len(sweep.pos1 if sweep.auto else sweep.pos2)} j-tracers, "
          f"{sweep.n_labels_1} x {sweep.n_labels_2} labels, kind "
          f"{sweep.kind}, {sweep.pair_weight}"
          f"{'' if sweep.unit_counts else ' (weighted)'}, z window "
          f"{sweep.z_cut}, {layout.n_tiles} tiles")
    print(f"tabulation {label}: paircount kernel {kernel_ms:.2f} ms "
          f"(with the wrapper's input checks; layout "
          f"{rec['layout_s'] * 1e3:.2f} ms), 1 launch; "
          f"{layout.candidates} candidate pairs "
          f"({layout.candidates / rec['sweep_s']:.4g}/s)"
          f"{f', {near} within pi_max' if sweep.kind == 'rppi' else ''}, "
          f"{valid} kept ({valid / layout.candidates:.3f}); bound "
          f"{b['bound_ms']:.2f} ms ({b['bound_by']}: {ops:.4g} ops = {a} a "
          f"candidate{f' + {bz} within pi_max' if bz else ''} + {c} a kept "
          f"pair, at 33.5 T lane-ops/s, over the z-window's candidates; "
          f"{n_bytes / 1e6:.1f} MB), share {b['bound_ms'] / kernel_ms:.3f} "
          f"on {ctx['card']}")
    print(f"tabulation {label}: stages (s) " + ", ".join(
        f"{k} {rec[k + '_s']:.3f}"
        for k in ("mock", "layout", "sweep", "estimator")) +
        " (mock: everything before the sweep's call -- binning, the dense "
        "mock, RSD, the AP stretch, tensors to the card; estimator: "
        "everything after it)")
    sub = subsample(ctx, sweep, TAB_SUBSAMPLE, SEED + 91)
    sub_layout = pc.bucket_layout(sub)
    got = pc.paircount_launch(sub, layout=sub_layout)
    want = pc.paircount_plain(sub)
    torch.cuda.synchronize()
    err = hist_errors(got, want, sub.unit_counts)
    what = ("cells unequal" if sub.unit_counts else
            "max relative error per cell (floored at 1e-7 of the largest)")
    print(f"tabulation {label}: kernel vs plain on {TAB_SUBSAMPLE} tracers "
          f"a side: {err} {what} (unit counts: 0; weighted: <= 1e-7)")
    check(err == 0 if sub.unit_counts else err <= 1e-7,
          f"{label}: kernel vs plain {err}")
    k_ms, p_ms, _, _ = ctx["alternate"](
        lambda: pc.paircount_launch(sub, layout=sub_layout),
        lambda: pc.paircount_plain(sub), 5, 1, rounds=1)
    sb, _, _ = paircount_bound(sub, sub_layout, valid_pairs(sub, want))
    print(f"tabulation {label}: subsample kernel {k_ms:.3f} ms, plain "
          f"PyTorch {p_ms:.1f} ms, bound {sb['bound_ms']:.3f} ms "
          f"({sub_layout.candidates} candidates) on {ctx['card']}")
    max_abs_err = float((got.double() - want.double()).abs().max())
    return dict(ms=k_ms, plain_ms=p_ms, max_abs_err=max_abs_err, **sb,
                main_path_ms=kernel_ms, main_path_bound_ms=b["bound_ms"])


def tabulation_phase(ctx, kernels):
    """TabCorr.tabulate on a Bolshoi-Planck-sized synthetic catalog: wp
    and xi(s, mu) in the 'default' configuration, Delta Sigma in the
    'efficient' one, and wp again on a clustered catalog of the same
    hosts; the first three tables then predict through B1 and B3."""
    torch, np, pc = ctx["torch"], ctx["np"], ctx["paircount"]
    import tabcorr_tpu_torch as tp
    from tabcorr_tpu_torch.ops.multipole import tabcorr_s_mu_to_multipole
    from tabcorr_tpu_torch.utils.synthetic import (CLUMP_RADIUS,
                                                   synthetic_halocat,
                                                   synthetic_particles)
    t_phase = time.perf_counter()
    halocat = synthetic_halocat(TAB_HALOS, TAB_LBOX)
    clustered = synthetic_halocat(TAB_HALOS, TAB_LBOX, clumps=TAB_CLUMPS)
    particles = synthetic_particles(TAB_PARTICLES, halocat)
    default = tp.database.configuration("default")
    efficient = tp.database.configuration("efficient")
    records = []

    def spy(sweep):
        """The tabulation's sweep, as ``paircount`` runs it on the card,
        timed by stage on the host clock (synchronized): the layout, then
        the launch; recorded with its inputs, layout and histogram."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        layout = pc.bucket_layout(sweep)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hist = pc.paircount_launch(sweep, layout)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        records.append(dict(sweep=sweep, hist=hist, layout=layout,
                            t_call=t0, layout_s=t1 - t0, sweep_s=t2 - t1,
                            t_return=t2))
        return hist

    common = dict(mode="auto", prim_haloprop_bins=30,
                  sec_haloprop_percentile_bins=0.5,
                  sats_per_prim_haloprop=default["sats_per_prim_haloprop"],
                  redshift_space_distortions=True, project_xyz=False,
                  cosmology_obs=default["cosmo_obs"], seed=SEED,
                  device="cuda")
    print(f"tabulation: {TAB_HALOS} host halos in a {TAB_LBOX} Mpc/h box "
          f"(z = {halocat.redshift}), project_xyz=False (one projection "
          f"a sweep), RSD on, AP stretch to Planck15; the clustered "
          f"catalog: the same hosts around {TAB_CLUMPS} centres, "
          f"{CLUMP_RADIUS} Mpc/h Gaussian offsets")
    runs = [
        ("wp", lambda: tp.TabCorr.tabulate(
            halocat, tp.corrfunc.wp, default["rp_wp_bins"],
            default["pi_max"], **common)),
        ("s_mu", lambda: tp.TabCorr.tabulate(
            halocat, tp.corrfunc.s_mu_tpcf, default["s_bins"],
            default["mu_bins"], **common)),
        ("ds", lambda: tp.TabCorr.tabulate(
            halocat, tp.corrfunc.mean_delta_sigma, particles.positions,
            particles.effective_particle_mass, efficient["rp_ds_bins"],
            **{**common, "mode": "cross", "prim_haloprop_bins": 300,
               "sec_haloprop_percentile_bins": None,
               "cosmology_obs": None,
               "sats_per_prim_haloprop":
                   efficient["sats_per_prim_haloprop"],
               "downsample": efficient["downsample"]})),
        ("wp clustered", lambda: tp.TabCorr.tabulate(
            clustered, tp.corrfunc.wp, default["rp_wp_bins"],
            default["pi_max"], **common)),
    ]
    tables, reports = {}, {}
    launches = 0
    dispatch = pc.paircount
    pc.paircount = spy
    try:
        for label, run in runs:
            ctx["reset"]()
            t0 = time.perf_counter()
            tables[label] = run()
            t_end = time.perf_counter()
            launched = ctx["expect"](f"tabulation {label}",
                                     paircount=1)["paircount"]
            launches += launched
            rec = records[-1]
            rec["mock_s"] = rec["t_call"] - t0
            rec["estimator_s"] = t_end - rec["t_return"]
            sweep = rec["sweep"]
            kept = int((sweep.labels1 >= 0).sum())
            print(f"tabulation {label}: {t_end - t0:.2f} s wall, "
                  f"{launched} paircount launch; {len(sweep.pos1)} tracers "
                  f"({kept} labeled), table {tables[label].tpcf_matrix.shape}")
            if sweep.auto:
                h = rec["hist"].reshape(sweep.n_labels_1, sweep.n_labels_1,
                                        -1)
                check(bool(torch.equal(h, h.transpose(0, 1))),
                      f"{label}: auto counts not symmetric")
                print(f"tabulation {label}: counts[a, b, r] == counts[b, "
                      f"a, r] for all {h.numel()} cells")
            reports[label] = tabulation_sweep_report(ctx, label, rec)
            label_slices(ctx, label, sweep, rec["hist"])
            if sweep.auto:
                brute_force_check(ctx, label, sweep)
    finally:
        pc.paircount = dispatch

    # ---- from tabulation to prediction ---------------------------------
    mu_bins = default["mu_bins"]
    parts = [tabcorr_s_mu_to_multipole(tables["s_mu"], mu_bins, order)
             for order in (0, 2, 4)]
    xi_ell = parts[0]
    xi_ell.tpcf_matrix = np.concatenate([q.tpcf_matrix for q in parts])
    xi_ell.tpcf_shape = (3, len(default["s_bins"]) - 1)
    xi_ell.clear_caches()
    wp_tab, ds_tab = tables["wp"], tables["ds"]
    model = tp.Zheng07Model(threshold=-20, redshift=halocat.redshift)
    params = bench_params(model, np.random.default_rng(SEED + 92), BATCH,
                          "cuda")
    accuracy = ("scaled", "scaled")
    predict = tp.make_multi_predictor([wp_tab, xi_ell], model,
                                      device="cuda", accuracy=accuracy)
    ctx["reset"]()
    outs = predict(params)
    torch.cuda.synchronize()
    ctx["expect"]("tabulated tables through B1", bundle=1)
    record(kernels, "bundle", 1)
    plain = tp.make_multi_predictor([wp_tab, xi_ell], model, device="cuda",
                                    engine="plain", accuracy=accuracy)(
                                        params)
    (ngal, wp), (_, xi) = outs
    check(bool(torch.isfinite(wp).all() and torch.isfinite(xi).all()),
          "tabulated B1: non-finite")
    ng_err = max(rel(outs[0][0], plain[0][0]), rel(outs[1][0], plain[1][0]))
    wp_err, xi_err = scaled(wp, plain[0][1]), scaled(xi, plain[1][1])
    print(f"tabulated wp ({wp_tab.n_bins} bins) + xi_ell ({xi_ell.n_bins} "
          f"bins) through B1 ({BATCH} rows, zheng07 -20): kernel vs plain "
          f"ngal {ng_err:.3e} (<= 1e-6), wp scaled {wp_err:.3e} (<= 2e-6), "
          f"xi_ell scaled {xi_err:.3e} (<= 1e-6)")
    check(ng_err <= 1e-6 and wp_err <= 2e-6 and xi_err <= 1e-6,
          "tabulated B1 vs plain")
    e_ng = e_wp = e_xi = e_wp_rel = 0.0
    for i in range(N_PROBE):
        m = host_model(model, params, i)
        for tab, out, which in ((wp_tab, outs[0], "wp"),
                                (xi_ell, outs[1], "xi")):
            ng64, xi64 = tab.predict(m, check_consistency=False)
            got = out[1][i].double().cpu().numpy().ravel()
            want = np.ravel(xi64)
            e_ng = max(e_ng, abs(float(out[0][i]) / ng64 - 1))
            err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
            if which == "wp":
                e_wp = max(e_wp, err)
                e_wp_rel = max(e_wp_rel,
                               float(np.max(np.abs(got / want - 1))))
            else:
                e_xi = max(e_xi, err)
    print(f"tabulated B1 vs float64 host at {N_PROBE} probes: ngal rel "
          f"{e_ng:.3e} (<= 1e-6), wp scaled {e_wp:.3e} (<= 1e-6; per "
          f"element {e_wp_rel:.3e}, not held: an unclustered catalog's wp "
          f"crosses zero at large rp), xi_ell scaled {e_xi:.3e} (<= 1e-6)")
    check(e_ng <= 1e-6 and e_wp <= 1e-6 and e_xi <= 1e-6,
          "tabulated B1 vs float64")

    predict_ds = tp.make_predictor(ds_tab, model, engine="fused",
                                   device="cuda")
    ctx["reset"]()
    ng_ds, ds = predict_ds(params)
    torch.cuda.synchronize()
    got = ctx["expect"]("tabulated Delta Sigma, engine='fused'",
                        contraction=1)
    ran = [k for k, v in got.items() if v]
    record(kernels, "contraction", 1)
    e_ng = e_ds = 0.0
    for i in range(N_PROBE):
        ng64, ds64 = ds_tab.predict(host_model(model, params, i),
                                    check_consistency=False)
        e_ng = max(e_ng, abs(float(ng_ds[i]) / ng64 - 1))
        e_ds = max(e_ds, float(np.max(np.abs(
            ds[i].double().cpu().numpy().ravel() - np.ravel(ds64))) /
            np.max(np.abs(ds64))))
    print(f"tabulated Delta Sigma ({ds_tab.n_bins} bins, cross) through "
          f"make_predictor(engine='fused'): kernel {ran}, vs float64 host "
          f"at {N_PROBE} probes: ngal rel {e_ng:.3e} (<= 1e-6), Delta Sigma "
          f"scaled {e_ds:.3e} (<= 1e-6)")
    check(e_ng <= 1e-6 and e_ds <= 1e-6, "tabulated Delta Sigma vs float64")

    wp_report = reports["wp"]
    record(kernels, "paircount", launches, library_ms=None,
           **{k: wp_report[k] for k in ("ms", "plain_ms", "max_abs_err",
                                        "bound_ms", "bound_by")},
           main_path_ms=sum(r["main_path_ms"] for r in reports.values()),
           main_path_bound_ms=sum(r["main_path_bound_ms"]
                                  for r in reports.values()))
    print(f"tabulation phase: {time.perf_counter() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
