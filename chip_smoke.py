"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA bundle kernel (tabcorr_tpu_torch/csrc)
and drives ``tabcorr_tpu_torch`` through the entry points a user calls,
at the benchmark's real shapes: the bolplanck wp table (60 halo bins, 19
rp rows) and the synthetic xi_ell table (120 bins, 3 x 14 rows), zheng07
at threshold -18, 262,144 parameter vectors.

1. Predict: ``make_multi_predictor(..., device="cuda")`` on the batch.
2. MCMC: ``make_gaussian_logpost_batched`` over that predictor, then five
   ``ensemble_step``s with 262,144 walkers.

The kernel's launch counter is reset right before those two phases and
read right after them.  Then the kernel's results are held against its
plain PyTorch version on the same inputs and against the float64 host
path at 16 probes, and both versions are timed with CUDA events.  Any
failed check raises (non-zero exit).  On success the last line of output
is one JSON object naming the device.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

BATCH = 262144
N_PROBE = 16
N_STEPS = 5
SEED = 7
REPLACES = "tabcorr_tpu/ops/fused.py:600"   # make_fused_bundle_predictor
SOURCE = "tabcorr_tpu_torch/csrc/bundle.cu"


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

    from tabcorr_tpu_torch import (TabCorr, Zheng07Model,
                                   make_multi_predictor, params_batch)
    from tabcorr_tpu_torch.mcmc import (ensemble_step,
                                        make_gaussian_logpost_batched)
    from tabcorr_tpu_torch.ops import fused
    from tabcorr_tpu_torch.utils.build import library_path

    card = card_name_and_power()
    print(f"card (name, power limit): {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    fused.load_bundle_kernel()
    print(f"bundle kernel build + load: {time.perf_counter() - t0:.2f} s")
    log = library_path("bundle").with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}")

    data = root / "tabcorr_tpu_torch" / "data"
    wp_tab = TabCorr.read(data / "bolplanck_wp.npz")
    xi_tab = TabCorr.read(data / "synthetic_xi_ell.npz")
    model = Zheng07Model(threshold=-18, redshift=wp_tab.attrs["redshift"])
    names = Zheng07Model.param_names

    # bench.py's parameter distribution; element 0 at the defaults.
    rng = np.random.default_rng(SEED)
    overrides = {
        "logMmin": 11.35 + 0.1 * rng.normal(size=BATCH),
        "sigma_logM": 0.25 + 0.01 * rng.normal(size=BATCH),
        "logM0": 11.2 + 0.1 * rng.normal(size=BATCH),
        "logM1": 12.4 + 0.1 * rng.normal(size=BATCH),
        "alpha": 0.83 + 0.02 * rng.normal(size=BATCH),
    }
    for key in overrides:
        overrides[key][0] = model.param_dict[key]
    params = params_batch(model, overrides, (BATCH,), device="cuda")
    predict = make_multi_predictor([wp_tab, xi_tab], model, device="cuda",
                                   accuracy=("elementwise", "scaled"))
    predict_plain = make_multi_predictor(
        [wp_tab, xi_tab], model, device="cuda", engine="plain",
        accuracy=("elementwise", "scaled"))

    # ---- main path: predict, then the MCMC ensemble -------------------
    fused.BUNDLE_LAUNCHES = 0
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
    launches = fused.BUNDLE_LAUNCHES
    accepts = [float(a) for a in accepts]
    check(grew == [2] * N_STEPS, f"launches per step {grew}")
    check(launches == 2 + 2 * N_STEPS, f"{launches} launches")
    check(bool(torch.isfinite(lp).all()), "non-finite log-prob after steps")
    check(all(0.0 < a < 1.0 for a in accepts), f"accept fractions {accepts}")
    print(f"main path: {launches} bundle kernel launches (1 predict, 1 "
          f"initial log-prob, 2 per ensemble step x {N_STEPS})")
    print(f"mcmc: {N_STEPS} ensemble steps x {BATCH} walkers, accept "
          f"fractions {accepts}, log-prob range "
          f"[{float(lp.min()):.6g}, {float(lp.max()):.6g}]")
    # Median over the steps: the first one also pays one-time set-up
    # (cuBLAS handles, generator state).
    print(f"mcmc: {BATCH / float(np.median(step_s)):.6g} walker-steps/s "
          f"(median of per-step host-clock times {step_s} s) on {card}")

    # ---- kernel against its plain version, same inputs ----------------
    (ngal_p, wp_p), (ngal_xp, xi_p) = predict_plain(params)
    torch.cuda.synchronize()

    def rel(a, b):
        return float(((a.double() - b.double()).abs() /
                      b.double().abs()).max())

    ngal_err = max(rel(ngal, ngal_p), rel(ngal_x, ngal_xp))
    wp_err = rel(wp, wp_p)
    xi_d, xi_pd = xi.double().reshape(BATCH, -1), xi_p.double().reshape(
        BATCH, -1)
    xi_err = float(((xi_d - xi_pd).abs().amax(1) /
                    xi_pd.abs().amax(1)).max())
    max_abs = max(float((a.double() - b.double()).abs().max())
                  for a, b in ((ngal, ngal_p), (ngal_x, ngal_xp),
                               (wp, wp_p), (xi, xi_p)))
    print(f"kernel vs plain (B={BATCH}): ngal max rel {ngal_err:.3e} "
          f"(<= 1e-6), wp max rel {wp_err:.3e} (<= 2e-6), xi max scaled "
          f"{xi_err:.3e} (<= 1e-6), max abs {max_abs:.3e}")
    check(ngal_err <= 1e-6, f"ngal kernel vs plain {ngal_err}")
    check(wp_err <= 2e-6, f"wp kernel vs plain {wp_err}")
    check(xi_err <= 1e-6, f"xi kernel vs plain {xi_err}")

    # ---- against the float64 host path at the float32 parameters -------
    p_host = {k: params[k][:N_PROBE].cpu().numpy() for k in names}
    wp_host = wp[:N_PROBE].double().cpu().numpy()
    xi_host = xi[:N_PROBE].double().cpu().numpy().reshape(N_PROBE, -1)
    err_wp = err_xi = 0.0
    for i in range(N_PROBE):
        m = Zheng07Model(threshold=-18, redshift=wp_tab.attrs["redshift"])
        for k in names:
            m.param_dict[k] = float(p_host[k][i])
        want_wp = wp_tab.predict(m, check_consistency=False)[1].ravel()
        want_xi = xi_tab.predict(m, check_consistency=False)[1].ravel()
        err_wp = max(err_wp, float(np.max(np.abs(wp_host[i] / want_wp - 1))))
        err_xi = max(err_xi, float(np.max(np.abs(xi_host[i] - want_xi)) /
                                   np.max(np.abs(want_xi))))
    print(f"kernel vs float64 host at {N_PROBE} probes: wp max rel "
          f"{err_wp:.3e} (<= 1e-6), xi_ell max scaled {err_xi:.3e} (<= 1e-6)")
    check(err_wp <= 1e-6, f"wp vs float64 {err_wp}")
    check(err_xi <= 1e-6, f"xi_ell vs float64 {err_xi}")

    # ---- timing: plain, kernel, kernel, plain --------------------------
    def window_ms(fn, n_iter):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            fn(params)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n_iter

    kernel_ms, plain_ms = [], []
    for _ in range(3):
        plain_ms.append(window_ms(predict_plain, 2))
        kernel_ms.append(window_ms(predict, 10))
        kernel_ms.append(window_ms(predict, 10))
        plain_ms.append(window_ms(predict_plain, 2))
    k_ms, p_ms = float(np.median(kernel_ms)), float(np.median(plain_ms))
    print(f"timing: bundle kernel {k_ms:.4f} ms per {BATCH}-vector batch "
          f"({BATCH / k_ms * 1e3:.6g} predictions/s; windows {kernel_ms}) "
          f"on {card}")
    print(f"timing: plain PyTorch {p_ms:.4f} ms per {BATCH}-vector batch "
          f"({BATCH / p_ms * 1e3:.6g} predictions/s; windows {plain_ms}) "
          f"on {card}")

    print(json.dumps({"kernels": [{
        "name": "bundle", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_abs,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
