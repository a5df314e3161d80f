"""Drive the PyTorch port's paths once on one CUDA card and check them.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels (tabcorr_tpu_torch/csrc: the
bundle and contraction kernels in bundle.cu, the grid kernel in grid.cu,
one nvcc each, in parallel) and drives ``tabcorr_tpu_torch`` through the
entry points a user calls, at real shapes, 262,144 parameter vectors each:

1. Bundle: ``make_multi_predictor`` on the bolplanck wp table (60 halo
   bins, 19 rp rows) and the synthetic xi_ell table (120 bins, 3 x 14
   rows), zheng07 at threshold -18; then ``make_gaussian_logpost_batched``
   over it and five ``ensemble_step``s with 262,144 walkers.
2. Grid: ``make_predictor(interp, engine="fused")`` on the 64-node
   'default'-geometry Interpolator (4 x 4 x 4 nodes over alpha_c, alpha_s,
   log_eta; 60 bins; 42 rows), zheng07 at threshold -20, with a few rows
   pushed outside the grid.
3. Grid: the same entry point on the 'efficient' Delta Sigma Interpolator
   (cross mode, 1104 bins, 4 log_eta nodes), zheng07 at threshold -21,
   z = 0.5.
4. Grid sampler: the Gaussian log posterior over the 64-node grid
   predictor on all 8 parameters, three ensemble steps, 262,144 walkers.
5. Contraction: ``make_predictor(tab, engine="fused")`` on both bundle
   tables.

Every launch counter is set to 0 right before each path and read right
after it.  Then each kernel's results are held against its plain PyTorch
version on the same inputs and against the float64 host path at 16
probes, and both versions are timed with CUDA events.  Any failed check
raises (non-zero exit).  On success the line before the last lists the
kernels as JSON, and the last line is one JSON object naming the device.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

BATCH = 262144
N_PROBE = 16
N_STEPS = 5
N_GRID_STEPS = 3
SEED = 7
# Rows pushed outside the grid (none among the probes).
OUT_ROWS = (17, 4099, BATCH - 1)
CSRC = "tabcorr_tpu_torch/csrc/"
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "bundle": (CSRC + "bundle.cu", "tabcorr_tpu/ops/fused.py:600"),
    "grid": (CSRC + "grid.cu", "tabcorr_tpu/ops/fused.py:1485"),
    "contraction": (CSRC + "bundle.cu", "tabcorr_tpu/ops/fused.py:125"),
}
COUNTERS = {"bundle": "BUNDLE_LAUNCHES", "grid": "GRID_LAUNCHES",
            "contraction": "CONTRACTION_LAUNCHES"}


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
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np

    import tabcorr_tpu_torch  # noqa: F401  (fails outside a checkout)
    from tabcorr_tpu_torch.ops import fused
    from tabcorr_tpu_torch.utils.build import library_path

    card = card_name_and_power()
    print(f"card (name, power limit): {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    fused.load_kernels()
    print(f"kernel builds (parallel) + load: {time.perf_counter() - t0:.2f} s")
    for name in fused.KERNEL_SOURCES:
        log = library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else ():
            if "registers" in line or "spill" in line:
                print(f"ptxas ({name}): {line.strip()}")

    def reset():
        for attr in COUNTERS.values():
            setattr(fused, attr, 0)

    def counts():
        return {k: getattr(fused, attr) for k, attr in COUNTERS.items()}

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

    ctx = dict(torch=torch, np=np, fused=fused, card=card, reset=reset,
               counts=counts, window_ms=window_ms, alternate=alternate)
    kernels = {}
    bundle_phase(ctx, kernels)
    grid_phases(ctx, kernels)
    contraction_phase(ctx, kernels)

    for name, k in kernels.items():
        check(k["launches"] > 0, f"{name} never launched on its path")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], **kernels[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def rel(a, b):
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def scaled(a, b):
    """Max over rows of max |a - b| / max |b|."""
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    return float(((a - b).abs().amax(1) / b.abs().amax(1)).max())


def max_abs(*pairs):
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def bench_params(model, rng, batch, device):
    """bench.py's zheng07 parameter distribution around the model's
    values; row 0 at the values themselves."""
    from tabcorr_tpu_torch import params_batch
    p = model.param_dict
    overrides = {
        "logMmin": p["logMmin"] + 0.1 * rng.normal(size=batch),
        "sigma_logM": p["sigma_logM"] + 0.01 * rng.normal(size=batch),
        "logM0": p["logM0"] + 0.1 * rng.normal(size=batch),
        "logM1": p["logM1"] + 0.1 * rng.normal(size=batch),
        "alpha": p["alpha"] + 0.02 * rng.normal(size=batch),
    }
    for key in overrides:
        overrides[key][0] = p[key]
    return params_batch(model, overrides, (batch,), device=device)


def host_model(model, params, i):
    """A copy of ``model`` at row ``i`` of the float32 batch."""
    from tabcorr_tpu_torch import Zheng07Model
    m = Zheng07Model(threshold=model.threshold, redshift=model.redshift,
                     prim_haloprop_key=model.prim_haloprop_key)
    for k, v in params.items():
        m.param_dict[k] = float(v[i])
    return m


# ----------------------------------------------------------------------
def bundle_phase(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import TabCorr, Zheng07Model, make_multi_predictor
    from tabcorr_tpu_torch.mcmc import (ensemble_step,
                                        make_gaussian_logpost_batched)

    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    wp_tab = TabCorr.read(data / "bolplanck_wp.npz")
    xi_tab = TabCorr.read(data / "synthetic_xi_ell.npz")
    model = Zheng07Model(threshold=-18, redshift=wp_tab.attrs["redshift"])
    names = Zheng07Model.param_names
    rng = np.random.default_rng(SEED)
    params = bench_params(model, rng, BATCH, "cuda")
    predict = make_multi_predictor([wp_tab, xi_tab], model, device="cuda",
                                   accuracy=("elementwise", "scaled"))
    predict_plain = make_multi_predictor(
        [wp_tab, xi_tab], model, device="cuda", engine="plain",
        accuracy=("elementwise", "scaled"))

    # ---- path: predict, then the MCMC ensemble ------------------------
    ctx["reset"]()
    (ngal, wp), (ngal_x, xi) = predict(params)
    torch.cuda.synchronize()
    check(fused.BUNDLE_LAUNCHES == 1, "predict did not launch the kernel")
    for name, out in (("ngal", ngal), ("wp", wp), ("xi", xi)):
        check(bool(torch.isfinite(out).all()), f"non-finite {name}")
    shapes = (tuple(wp.shape), tuple(xi.shape))
    check(shapes == ((BATCH, 19), (BATCH, 3, 14)), f"shapes {shapes}")

    data_wp = wp[0].double().cpu().numpy().ravel()
    data_xi = xi[0].double().cpu().numpy().ravel()
    log_prob = make_gaussian_logpost_batched(
        predict, names, model.param_dict, [data_wp, data_xi],
        [np.diag(1.0 / (0.05 * np.abs(data_wp) + 1e-3) ** 2),
         np.diag(1.0 / (0.05 * np.abs(data_xi) + 1e-3) ** 2)],
        device="cuda")
    walkers = torch.tensor(
        np.array([model.param_dict[k] for k in names])[None, :] +
        0.02 * rng.normal(size=(BATCH, len(names))),
        dtype=torch.float32, device="cuda")
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    lp = log_prob(walkers)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lp).all()), "non-finite initial log-prob")
    accepts, grew, step_s = [], [], []
    for _ in range(N_STEPS):
        before = fused.BUNDLE_LAUNCHES
        t0 = time.perf_counter()
        walkers, lp, accept = ensemble_step(generator, walkers, lp, log_prob,
                                            vectorized=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        grew.append(fused.BUNDLE_LAUNCHES - before)
        accepts.append(accept)
    launched = ctx["counts"]()
    accepts = [float(a) for a in accepts]
    check(grew == [2] * N_STEPS, f"launches per step {grew}")
    check(launched == {"bundle": 2 + 2 * N_STEPS, "grid": 0,
                       "contraction": 0}, f"launches {launched}")
    check(bool(torch.isfinite(lp).all()), "non-finite log-prob after steps")
    check(all(0.0 < a < 1.0 for a in accepts), f"accept fractions {accepts}")
    print(f"bundle path: {launched['bundle']} bundle kernel launches (1 "
          f"predict, 1 initial log-prob, 2 per ensemble step x {N_STEPS})")
    print(f"mcmc: {N_STEPS} ensemble steps x {BATCH} walkers, accept "
          f"fractions {accepts}, log-prob range "
          f"[{float(lp.min()):.6g}, {float(lp.max()):.6g}]")
    # Median over the steps: the first one also pays one-time set-up.
    print(f"mcmc: {BATCH / float(np.median(step_s)):.6g} walker-steps/s "
          f"(median of per-step host-clock times {step_s} s) on "
          f"{ctx['card']}")

    # ---- kernel against its plain version, same inputs ----------------
    (ngal_p, wp_p), (ngal_xp, xi_p) = predict_plain(params)
    torch.cuda.synchronize()
    ngal_err = max(rel(ngal, ngal_p), rel(ngal_x, ngal_xp))
    wp_err = rel(wp, wp_p)
    xi_err = scaled(xi, xi_p)
    err = max_abs((ngal, ngal_p), (ngal_x, ngal_xp), (wp, wp_p), (xi, xi_p))
    print(f"bundle kernel vs plain (B={BATCH}): ngal max rel {ngal_err:.3e} "
          f"(<= 1e-6), wp max rel {wp_err:.3e} (<= 2e-6), xi max scaled "
          f"{xi_err:.3e} (<= 1e-6), max abs {err:.3e}")
    check(ngal_err <= 1e-6, f"ngal kernel vs plain {ngal_err}")
    check(wp_err <= 2e-6, f"wp kernel vs plain {wp_err}")
    check(xi_err <= 1e-6, f"xi kernel vs plain {xi_err}")

    # ---- against the float64 host path at the float32 parameters -------
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
    print(f"bundle kernel vs float64 host at {N_PROBE} probes: wp max rel "
          f"{err_wp:.3e} (<= 1e-6), xi_ell max scaled {err_xi:.3e} (<= 1e-6)")
    check(err_wp <= 1e-6, f"wp vs float64 {err_wp}")
    check(err_xi <= 1e-6, f"xi_ell vs float64 {err_xi}")

    # ---- timing: plain, kernel, kernel, plain --------------------------
    k_ms, p_ms, k_w, p_w = ctx["alternate"](
        lambda: predict(params), lambda: predict_plain(params), 10, 2)
    print(f"timing: bundle kernel {k_ms:.4f} ms per {BATCH}-vector batch "
          f"({BATCH / k_ms * 1e3:.6g} predictions/s; windows {k_w}) on "
          f"{ctx['card']}")
    print(f"timing: bundle plain PyTorch {p_ms:.4f} ms per {BATCH}-vector "
          f"batch ({BATCH / p_ms * 1e3:.6g} predictions/s; windows {p_w}) on "
          f"{ctx['card']}")
    kernels["bundle"] = {"launches": launched["bundle"], "max_abs_err": err,
                         "ms": k_ms, "plain_ms": p_ms}


# ----------------------------------------------------------------------
def grid_phases(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (Interpolator, Zheng07Model,
                                   make_predictor, occupation_functions)
    from tabcorr_tpu_torch.mcmc import (ensemble_step,
                                        make_gaussian_logpost_batched)
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
    # ds_efficient: the test fixture's model, log_eta inside its grid.
    interp_ds = Interpolator.read(data / "ds_efficient.npz")
    model_ds = Zheng07Model(threshold=-21, redshift=0.5,
                            prim_haloprop_key="halo_m258m")
    model_ds.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
    params_ds = bench_params(model_ds, rng, BATCH, "cuda")
    v = rng.uniform(-0.45, 0.45, BATCH)
    v[0] = 0.0
    v[list(OUT_ROWS)] = 0.6
    params_ds["log_eta"] = torch.tensor(v, dtype=torch.float32,
                                        device="cuda")
    cases.append(("ds_efficient", interp_ds, model_ds, params_ds))

    launches = 0
    measured = {}
    for name, interp, model, params in cases:
        predict = make_predictor(interp, model, engine="fused",
                                 accuracy="scaled", device="cuda")
        # ---- path ------------------------------------------------------
        ctx["reset"]()
        t0 = time.perf_counter()
        ngal, xi = predict(params)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launched = ctx["counts"]()
        check(launched == {"bundle": 0, "grid": 1, "contraction": 0},
              f"{name}: launches {launched}")
        launches += launched["grid"]
        xi = xi.reshape(BATCH, -1)
        out = torch.zeros(BATCH, dtype=torch.bool, device="cuda")
        out[list(OUT_ROWS)] = True
        check(bool(torch.isnan(ngal[out]).all() and
                   torch.isnan(xi[out]).all()),
              f"{name}: out-of-grid rows are not all NaN")
        check(bool(torch.isfinite(ngal[~out]).all() and
                   torch.isfinite(xi[~out]).all()),
              f"{name}: NaN or inf in rows inside the grid")
        print(f"{name}: {launched['grid']} grid kernel launch, xi "
              f"{tuple(xi.shape)}, rows {OUT_ROWS} outside the grid all "
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
        print(f"{name}: grid kernel vs plain (B={BATCH}): ngal max rel "
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
        print(f"{name}: grid kernel vs float64 Interpolator.predict at "
              f"{N_PROBE} probes: xi max scaled {err_host:.3e} (<= 1e-6), "
              f"ngal max rel {err_ngal:.3e} (<= 1e-6)")
        check(err_host <= 1e-6, f"{name}: xi vs float64 {err_host}")
        check(err_ngal <= 1e-6, f"{name}: ngal vs float64 {err_ngal}")

        # ---- timing: the kernel's wrapper against its plain version ----
        pmat = torch.stack([params[k] for k in Zheng07Model.param_names],
                           dim=1)
        k_ms, p_ms, k_w, p_w = ctx["alternate"](
            lambda: fused.grid_launch(g, pmat, nw),
            lambda: fused.grid_predict_plain(g, params, nw, *occ), 3, 2)
        e2e_ms = ctx["window_ms"](lambda: predict(params), 3)
        measured[name] = (err, k_ms, p_ms)
        print(f"timing ({name}): grid kernel {k_ms:.4f} ms per "
              f"{BATCH}-vector batch (windows {k_w}), plain PyTorch "
              f"{p_ms:.4f} ms (windows {p_w}); whole predictor "
              f"{e2e_ms:.4f} ms ({BATCH / e2e_ms * 1e3:.6g} predictions/s) "
              f"on {ctx['card']}")
        if name == "grid64":
            flop = 2.0 * g.npair * g.n_nodes * g.n_xi * BATCH
            print(f"grid64: {flop:.4g} FLOP of packed contraction per batch "
                  f"(2 x {g.npair} x {g.n_nodes * g.n_xi} per sample): "
                  f"{flop / k_ms / 1e9:.4g} TFLOP/s in the kernel")

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
    rng = np.random.default_rng(SEED + 1)
    walkers = torch.tensor(
        np.array([model.param_dict[k] for k in names])[None, :] +
        0.02 * rng.normal(size=(BATCH, len(names))),
        dtype=torch.float32, device="cuda")
    generator = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ctx["reset"]()
    lp = log_prob(walkers)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lp).all()), "grid: non-finite initial log-prob")
    accepts, grew, step_s = [], [], []
    for _ in range(N_GRID_STEPS):
        before = fused.GRID_LAUNCHES
        t0 = time.perf_counter()
        walkers, lp, accept = ensemble_step(generator, walkers, lp, log_prob,
                                            vectorized=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        grew.append(fused.GRID_LAUNCHES - before)
        accepts.append(float(accept))
    launched = ctx["counts"]()
    check(grew == [2] * N_GRID_STEPS, f"grid launches per step {grew}")
    check(launched == {"bundle": 0, "grid": 1 + 2 * N_GRID_STEPS,
                       "contraction": 0}, f"grid sampler launches {launched}")
    check(bool(torch.isfinite(lp).all()), "grid: non-finite log-prob")
    check(all(0.0 < a < 1.0 for a in accepts),
          f"grid accept fractions {accepts}")
    launches += launched["grid"]
    print(f"grid sampler: {launched['grid']} grid kernel launches (1 "
          f"initial log-prob, 2 per step x {N_GRID_STEPS}), accept fractions "
          f"{accepts}, {BATCH / float(np.median(step_s)):.6g} walker-steps/s "
          f"(median of per-step host-clock times {step_s} s) on "
          f"{ctx['card']}")

    # The kernels line carries the 64-node grid's numbers (ds_efficient's
    # are printed above; its Delta Sigma values are ~1e13, so its absolute
    # errors are not comparable).
    err, k_ms, p_ms = measured["grid64"]
    kernels["grid"] = {"launches": launches, "max_abs_err": err,
                       "ms": k_ms, "plain_ms": p_ms}


# ----------------------------------------------------------------------
def contraction_phase(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import TabCorr, Zheng07Model, make_predictor

    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    tabs = [("wp", TabCorr.read(data / "bolplanck_wp.npz")),
            ("xi_ell", TabCorr.read(data / "synthetic_xi_ell.npz"))]
    model = Zheng07Model(threshold=-18, redshift=tabs[0][1].attrs["redshift"])
    params = bench_params(model, np.random.default_rng(SEED + 2), BATCH,
                          "cuda")
    predictors = [make_predictor(tab, model, engine="fused", device="cuda")
                  for _, tab in tabs]

    # ---- path -----------------------------------------------------------
    ctx["reset"]()
    outs = [predict(params) for predict in predictors]
    torch.cuda.synchronize()
    launched = ctx["counts"]()
    check(launched == {"bundle": 0, "grid": 0, "contraction": 2},
          f"contraction launches {launched}")
    print(f"contraction path: {launched['contraction']} contraction kernel "
          "launches (make_predictor(engine='fused') on wp and xi_ell)")

    max_err = 0.0
    k_total = p_total = 0.0
    for (name, tab), (ngal, xi) in zip(tabs, outs):
        check(bool(torch.isfinite(xi).all()), f"{name}: non-finite xi")
        table = tab.table_data(device="cuda")
        c = fused.bundle_table_constants(table)
        dens = fused.occupation_density(table, model, params)
        ngal_p, xi_p = fused.contraction_plain(c, dens)
        xi_p = xi_p.reshape(xi.shape)
        ngal_err = rel(ngal, ngal_p)
        xi_err = rel(xi, xi_p) if name == "wp" else scaled(xi, xi_p)
        limit = 2e-6 if name == "wp" else 1e-6
        err = max_abs((ngal, ngal_p), (xi, xi_p))
        max_err = max(max_err, err)
        print(f"{name}: contraction kernel vs plain (B={BATCH}): ngal max "
              f"rel {ngal_err:.3e} (<= 1e-6), xi max "
              f"{'rel' if name == 'wp' else 'scaled'} {xi_err:.3e} "
              f"(<= {limit:g}), max abs {err:.3e}")
        check(ngal_err <= 1e-6, f"{name}: ngal kernel vs plain {ngal_err}")
        check(xi_err <= limit, f"{name}: xi kernel vs plain {xi_err}")

        err_host = 0.0
        for i in range(N_PROBE):
            want = tab.predict(host_model(model, params, i),
                               check_consistency=False)[1].ravel()
            got = xi[i].double().cpu().numpy().ravel()
            err_host = max(err_host, float(
                np.max(np.abs(got / want - 1)) if name == "wp" else
                np.max(np.abs(got - want)) / np.max(np.abs(want))))
        print(f"{name}: contraction kernel vs float64 host at {N_PROBE} "
              f"probes: max {'rel' if name == 'wp' else 'scaled'} "
              f"{err_host:.3e} (<= 1e-6)")
        check(err_host <= 1e-6, f"{name}: xi vs float64 {err_host}")

        k_ms, p_ms, k_w, p_w = ctx["alternate"](
            lambda: fused.contraction_launch(c, dens),
            lambda: fused.contraction_plain(c, dens), 10, 2)
        k_total += k_ms
        p_total += p_ms
        print(f"timing ({name}): contraction kernel {k_ms:.4f} ms per "
              f"{BATCH}-vector batch (windows {k_w}), plain PyTorch "
              f"{p_ms:.4f} ms (windows {p_w}) on {ctx['card']}")
    kernels["contraction"] = {"launches": launched["contraction"],
                              "max_abs_err": max_err, "ms": k_total,
                              "plain_ms": p_total}


if __name__ == "__main__":
    sys.exit(main())
