"""Drive the PyTorch port's paths once on one CUDA card and check them.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels (tabcorr_tpu_torch/csrc: the
bundle and contraction kernels in bundle.cu, the grid kernel in grid.cu,
the slab kernels in slab.cu, the occupation kernel of the HOD families in
occupation.cu, the labeled pair counter in paircount.cu, the bfloat16
contraction in bf16.cu, one nvcc each, in parallel) and drives
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
   z = 0.5; then again with the decorated model.
5. Grid sampler: the Gaussian log posterior over the 64-node grid
   predictor on all 8 parameters, three ensemble steps, 262,144 walkers.
6. Contraction: ``make_predictor(tab, engine="fused")`` on both bundle
   tables, and on xi_ell with the decorated model.
7. Wide grid (slab_tc kernel, 3xTF32 on wgmma): ``make_predictor(interp,
   engine="fused", accuracy="scaled")`` on the 64-node grid of 160 bins
   (40 mass x 2 secondary-percentile bins x 2 galaxy types), too wide for
   the grid kernel's packed layout; the decorated model at threshold -20,
   32,768 rows, a few outside the grid; then two ensemble steps over its
   10 parameters; then slab_tc against its plain version off those
   shapes (156 bins at 32,691 rows; 400 bins, whose block has one
   consumer warpgroup); then the 'elementwise' route (the FP32 slab
   kernel, from the block-triangular half that slab_tc's split constants
   are cut from).  slab_tc's block (warpgroups, ring slots, cluster size)
   is printed, ptxas' registers and spills of every slab.cu kernel, and
   the register budgets slab_tc's warpgroups set (setmaxnreg) as its SASS
   shows them.

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
   layout (cells, neighbour cells, label groups, tiles); three pair
   counts -- within the z cut (no layout read), the kernel's candidates
   (its own count, held equal to its layout's runs) and the kept pairs;
   the kernel's ms by CUDA events around its launch and the wall time
   with the wrapper's checks; for (a) the host C++ counter
   (``strategy="native"``) on the 65,536-tracer subsample on this
   machine's CPU, its ms beside the kernel's and its unit counts against
   the plain version's (differing by at most 1e-6 of the pairs: float64
   against float32 geometry at the edges); the kept-pair bound (every kept pair's
   geometry and bin, ``bound_ops``, at 33.5 T lane-ops/s) and the
   z-slab bound (``bound_ops`` over every pair within the z cut, the
   enumeration of a layout without xy cells), each with its share; the plain
   version's ms on the subsample, the stages' wall time.  Then the tables of
   (a)-(c) predict: wp + xi_ell through ``make_multi_predictor`` (B1,
   262,144 rows, 'scaled'), Delta Sigma through
   ``make_predictor(engine="fused")`` (B3), each against the float64
   host path at 16 probes (ngal 1e-6 relative, the statistics 1e-6
   scaled) and the bundle against its plain engine.

10. Joint statistics and the gradient samplers: (a)
   ``make_multi_predictor([bolplanck wp, bolplanck Delta Sigma], zheng07
   -18, engine="auto")``, which must resolve to the bundle kernel, one
   launch a call, held against the bundle's plain engine over the whole
   batch and, wp per element and Delta Sigma scaled, to 1e-6 of float64
   at 16 probes, then three ensemble steps over its log posterior; (b)
   ``engine="auto"`` over the wp TabCorr and the 'efficient' Delta Sigma
   Interpolator (a check of the route, not a physical fit): one
   contraction and one grid launch a call, NaN only in the grid member's
   out-of-grid rows, each kernel against its plain version over the
   whole batch (the same NaN elements) and each member against its own
   float64 host path; (c) ``run_nuts`` on 4,096 chains over the zheng07
   posterior of wp + Delta Sigma on the plain float64 engine on the card
   (no kernel launched; the kernels give no gradient, and the bundle's
   refusal is printed), a 10-step warmup with the mass matrix, then
   timed ``nuts_step``s: ms per step, batched gradients, chain gradient
   evaluations per second, the share of a step outside the batched
   gradients (each step and each gradient in it timed on CUDA events); the log probability and its gradient on 16 chains held to
   the host's float64 at 1e-10, no NaN, accept statistics in [0, 1],
   mean depth >= 1; (d) ``run_hmc_adaptive`` on the same posterior.

11. The table-making pipeline: ``scripts/torch_parse_snapshot.py``
   writes an AbacusSummit-style snapshot.npz of path 9's catalog and
   particles (the base simulations' particle mass, so the CLI's
   299-particle cut keeps the hosts above 6.3e11 Msun/h) into a temporary
   database; ``scripts/torch_tabulate_snapshot.py``'s ``main`` makes the
   'efficient' Delta Sigma grid (4 log_eta nodes, cross mode, 300 mass
   bins, one sweep a node) and wp grid (4 alpha_s x 4 log_eta nodes,
   three projections a node) with ``--format npz --seed 1`` on the
   default ``--device cuda``; printed per node: the host's mock,
   the layout, the kernel (CUDA events) and the write, and per run the
   Interpolator's assembly, the bytes written and the whole run.  Node 0
   is held against a direct ``TabCorr.tabulate`` with its arguments
   (sweeps: unit counts equal, weighted cells within 1e-7), then both
   Interpolators, read back through ``database.read(format="npz")``,
   predict through ``make_predictor(engine="fused")`` (the grid kernel)
   at 262,144 rows: zheng07 on wp, zheng07 and AssembiasLeauthaud11 on
   Delta Sigma, each within 1e-6 of the float64 ``Interpolator.predict``
   at 16 probes.

12. bfloat16: ``make_predictor(..., engine="fused",
   dtype=torch.bfloat16)``, tabcorr_tpu's bf16 route (parameters rounded
   to bfloat16, the occupation in tensor ops, densities rounded to
   bfloat16) into the BF16 tensor-core contraction kernel
   (``csrc/bf16.cu``, ``wgmma`` fed by TMA; each instantiation's HGMMA
   count read from its SASS at the build): (a) zheng07 -18 on the
   bolplanck wp, synthetic xi_ell and bolplanck Delta Sigma tables; (b)
   the 64-node grid (zheng07 -20, rows outside the grid NaN with their
   ngal); (c) the 'efficient' Delta Sigma grid (zheng07 -21, z = 0.5);
   (d) the wide grid at 32,768 rows with path 7's decorated model; (e)
   ``engine="auto"`` in bfloat16 on the card, which must take the same
   route (one launch, the same results bit for bit).  Each case: one
   launch; the kernel against its plain version over the whole batch
   (each element within one bfloat16 ulp, or on rows that cross zero
   within 2^-8 of the row's largest |element|); the route and the port's plain
   bf16 engine against float64 at 16 probes (the bfloat16 parameters the
   kernel received), the route within max(2 x the plain engine's error,
   2^-8) plus 2^-8 for each rounding of its results to bfloat16 (one for
   ngal and a table's xi, two for a grid's xi: the nodes' and the
   spline's); the kernel's ms (CUDA events, in turns with the plain
   version) beside its bound (``contraction_flop`` at 989 TFLOP/s BF16
   against the bytes) and one bf16 ``torch.einsum`` (their ratio).  Then
   ``examples/torch_example_mcmc.py``'s ``run(device="cuda",
   n_steps=20)``: the bundle route, 41 launches, no plot; and
   ``examples/torch_example_multichip.py``'s as a one-rank NCCL world.

13. Multi-GPU (``tabcorr_tpu_torch.parallel``, one process a rank,
   spawned by ``run_world``): (a) a one-rank NCCL world, the production
   backend: ``make_multi_predictor([wp, xi_ell], mesh=)`` through B1 at
   262,144 rows, the grid64 Interpolator through B2 and the wide grid
   through slab_tc with ``mesh=``, and ``labeled_pair_count(mesh=)`` on
   path 9's 65,536-tracer wp and Delta Sigma subsamples; (b) two gloo
   ranks sharing the card (NCCL refuses two ranks on one device):
   ``make_sharded_predict`` with the wp table over tp = 2, then B1 on
   each rank's half of the batch and both sweeps in two shards, the
   collectives through the host.  Each rank holds every result against
   the unsharded call on the same rows (bit for bit; unit counts equal,
   weighted cells within 1e-12; the table-parallel predict within
   tabcorr_tpu's dry-run tolerances), times both, and returns its launch
   counts, which must be above 0.

Paths 3-5 and 7 run the 'scaled' contract: the grid kernel and slab_tc;
the 'elementwise' passes run the grid kernel and the FP32 slab kernel,
held against the same plain versions.

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
import re
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
    "slab": (CSRC + "slab.cu", "tabcorr_tpu/ops/fused.py:1162"),
    "slab_tc": (CSRC + "slab.cu", "tabcorr_tpu/ops/fused.py:1162"),
    # The occupation phase the Pallas kernels B1, B4 and B2 trace in their
    # bodies for the SHMR, CLF and quiescent/active families.
    "occupation": (CSRC + "occupation.cu",
                   "tabcorr_tpu/ops/fused.py:985, 1373, 1941"),
    # The z-windowed XLA sweep of the tabulation (not a Pallas kernel).
    "paircount": (CSRC + "paircount.cu",
                  "tabcorr_tpu/ops/paircount.py:130, 276"),
    "contraction_bf16": (CSRC + "bf16.cu",
                         "tabcorr_tpu/ops/fused.py:125 (bf16)"),
    # The pair counter on each rank of a sharded sweep, one all-reduce
    # after it (labeled_pair_count(mesh=)).
    "paircount_sharded": (CSRC + "paircount.cu",
                          "tabcorr_tpu/ops/paircount.py:324"),
}
# name -> (module of ctx, launch counter)
COUNTERS = {"bundle": ("fused", "BUNDLE_LAUNCHES"),
            "contraction": ("fused", "CONTRACTION_LAUNCHES"),
            "grid": ("fused", "GRID_LAUNCHES"),
            "slab": ("fused", "SLAB_LAUNCHES"),
            "slab_tc": ("fused", "SLAB_TC_LAUNCHES"),
            "occupation": ("fused", "OCCUPATION_LAUNCHES"),
            "paircount": ("paircount", "PAIRCOUNT_LAUNCHES"),
            "contraction_bf16": ("fused", "CONTRACTION_BF16_LAUNCHES")}


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
    sampler_phases(ctx, kernels)
    tabulation_phase(ctx, kernels)
    pipeline_phase(ctx, kernels)
    bf16_phase(ctx, kernels)
    examples_phase(ctx, kernels)
    multi_gpu_phase(ctx, kernels)

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
                    name in ("occupation", "paircount", "slab") and
                    "entry function" in line):
                print(f"ptxas ({name}): {line.strip()}")
    slab_tc_register_budgets(library_path("slab"))
    bf16_wgmma = bf16_wgmma_counts(library_path("bf16"))
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
                card=card, reset=reset, bf16_wgmma=bf16_wgmma,
                expect=expect, window_ms=window_ms, alternate=alternate,
                library_ms=library_ms)


def slab_tc_register_budgets(lib):
    """Print the setmaxnreg budgets of each slab_tc instantiation from its
    SASS (USETMAXREG).  ptxas -v reports a kernel that reallocates
    registers at its launch bound (65,536 / 384 threads: 168); its
    producer warpgroup then runs at the first budget, its consumers at the
    second.  A kernel with none uses what ptxas reports."""
    from tabcorr_tpu_torch.utils.build import nvcc_path
    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if "slab_tc_kernel" not in name:
            continue
        instr = list(dict.fromkeys(
            " ".join(i.split()) for i in re.findall(r"USETMAXREG[^;]*", func)))

        def budget(kind):
            return [int(re.findall(r"0x[0-9a-f]+|\b\d+\b", i)[-1], 0)
                    for i in instr if ("DEALLOC" in i) == (kind == "dec")]
        print(f"setmaxnreg (slab, SASS): {name}: " + (
            f"registers a thread: producer {budget('dec')}, consumers "
            f"{budget('inc')} (ptxas' count above is the launch bound; "
            f"{instr})" if instr else
            "none (ptxas' count above is what it uses)"))


def bf16_wgmma_counts(lib):
    """{instantiation: HGMMA instructions} of the bfloat16 contraction's
    kernels, from their SASS; prints them and ptxas' reports of wgmmas it
    serialized (C7510-C7520, "Potential Performance Loss"), and fails if a
    kernel has no HGMMA."""
    from tabcorr_tpu_torch.utils.build import nvcc_path
    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if "contraction_bf16" in name:
            counts[name] = len(re.findall(r"\bHGMMA\.", func))
    for name, n in counts.items():
        print(f"wgmma (bf16, SASS): {name}: {n} HGMMA")
    log = Path(lib).with_suffix(".log")
    serialized = [line.strip() for line in (
        log.read_text().splitlines() if log.exists() else ())
        if "wgmma.mma_async instructions are serialized" in line]
    print(f"wgmma (bf16, ptxas): {len(serialized)} reports of serialized "
          f"wgmmas {serialized}")
    check(counts and all(counts.values()),
          f"bf16 kernels without HGMMA: {counts}")
    return counts


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
    fused.BUNDLE_TC_TABLES = 0
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
          f"{n_steps}), {len(names)} sampled parameters; BUNDLE_TC_TABLES "
          f"{fused.BUNDLE_TC_TABLES} (xi_ell 'scaled' on the tensor cores, "
          f"1 a launch)")
    check(fused.BUNDLE_TC_TABLES == launched,
          f"{label}: {fused.BUNDLE_TC_TABLES} tensor-core tables in "
          f"{launched} launches")
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
    # The two routes of xi_ell 'scaled' on the same rows, in turns (FP32,
    # tensor cores, tensor cores, FP32): the mixed bundle, and xi_ell
    # alone.  The tensor-core route stays only while it beats the FP32 one.
    split = fused.slab_split_table_constants(datas[1], 1)
    for what, fp32, tc in (("wp + xi_ell", tables, [tables[0], split]),
                           ("xi_ell alone", tables[1:], [split])):
        tc_ms, fp32_ms, tc_w, fp32_w = ctx["alternate"](
            lambda: fused.bundle_launch(tc, pmat, hod),
            lambda: fused.bundle_launch(fp32, pmat, hod), 10, 10)
        print(f"routes ({label}): {what}: xi_ell on the tensor cores "
              f"{tc_ms:.4f} ms, on the FP32 route {fp32_ms:.4f} ms "
              f"({fp32_ms / tc_ms:.3f}x; windows {tc_w}, {fp32_w}) on "
              f"{ctx['card']}")
        check(tc_ms < fp32_ms, f"{label}: the tensor-core route of {what} "
              f"({tc_ms} ms) does not beat the FP32 route ({fp32_ms} ms)")
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
            lambda: fused.grid_launch(g, pmat, nw, hod),
            lambda: fused.grid_predict_plain(g, params, nw, *occ), 3, 2)
        e2e_ms = ctx["window_ms"](lambda: predict(params), 3)
        print(f"timing ({name}): {kname} kernel {k_ms:.4f} ms per "
              f"{BATCH}-vector batch (windows {k_w}), plain PyTorch "
              f"{p_ms:.4f} ms (windows {p_w}); whole predictor "
              f"{e2e_ms:.4f} ms ({BATCH / e2e_ms * 1e3:.6g} predictions/s) "
              f"on {ctx['card']}")
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
            grid64 = (interp, model, params, stacked, g, nw, occ, hod, pmat,
                      out, flop, n_bytes)

    grid_elementwise_pass(ctx, kernels, *grid64, grid_launches)

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
    record(kernels, kname, launches)


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
    s_half = fused.slab_tc_table_constants(stacked, n_nodes)
    s_tc = fused.slab_split_table_constants(stacked, n_nodes)
    wgs, stages = fused.slab_tc_config(s.n_bins, s.n_xi)
    print(f"wide grid: slab_tc block {64 * wgs} rows ({wgs} consumer "
          f"warpgroups + 1 producer), {stages} ring slots of 8 KB, a "
          f"cluster of 1 block, {nbytes(s_tc.b) / 1e6:.1f} MB of split node "
          f"matrices (FP32 half layout {nbytes(s_half.b) / 1e6:.1f} MB)")
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
          f"({s_tc.n_ct} column tiles, {s_tc.node_steps} stages a node)")
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
    slab_tc_ragged_pass(ctx)

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
    total_k, nodes_k = fused.slab_launch(s_half, pmat, hod)
    ngal_err = rel(total_k, total_p)
    node_err = scaled(nodes_k.reshape(-1, s.n_xi), nodes_p.reshape(-1, s.n_xi))
    err = max_abs((total_k, total_p), (nodes_k, nodes_p))
    print(f"wide grid elementwise: {launched['slab']} slab kernel launch; "
          f"slab kernel vs plain (B={SLAB_BATCH}): ngal max rel "
          f"{ngal_err:.3e} (<= 1e-6), per-node xi max scaled {node_err:.3e} "
          f"(<= 1e-6), max abs {err:.3e}")
    check(ngal_err <= 1e-6, f"wide grid elementwise: ngal {ngal_err}")
    check(node_err <= 1e-6, f"wide grid elementwise: xi {node_err}")
    k_w = [ctx["window_ms"](lambda: fused.slab_launch(s_half, pmat, hod), 2)
           for _ in range(3)]
    k_ms = float(np.median(k_w))
    print(f"timing (wide grid elementwise): slab kernel {k_ms:.4f} ms per "
          f"{SLAB_BATCH}-vector batch (windows {k_w}) on {ctx['card']}")
    record(kernels, "slab", launched["slab"], max_abs_err=err, ms=k_ms,
           plain_ms=p_ms, **bound(flop, quad + nbytes(s_half.b) + out_bytes),
           library_ms=lib_ms)


def slab_tc_ragged_pass(ctx):
    """slab_tc against its plain version off the wide grid's shapes: 156
    bins (not a multiple of 8) over 64 nodes at a batch that is no multiple
    of the block rows, then 400 bins over 8 nodes, whose densities leave
    room for one consumer warpgroup (64-row blocks).  Limits: ngal 1e-6
    relative, per-node xi 1e-6 scaled."""
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import AssembiasZheng07Model, occupation_functions

    def synthetic_stack(n_nodes, n_prim):
        """The wide grid's tables (utils.synthetic's draws) for n_nodes
        nodes of 4 n_prim bins, stacked as stacked_grid stacks them."""
        from tabcorr_tpu_torch.utils.synthetic import synthetic_tabcorr
        tables = []
        for j in range(n_nodes):
            t = synthetic_tabcorr(np.random.default_rng(42), n_prim, 2, 42,
                                  "auto")
            t.tpcf_matrix = t.tpcf_matrix * (1.0 + 0.1 * np.random.default_rng(
                1000 + j).normal(size=t.tpcf_matrix.shape))
            tables.append(t.table_data(device="cuda"))
        return dataclasses.replace(
            tables[0], tpcf_dense=torch.cat([t.tpcf_dense for t in tables]),
            tpcf_shape=(n_nodes * tables[0].tpcf_dense.shape[0],))

    model = AssembiasZheng07Model(threshold=-20, redshift=0.0)
    hod = fused.KernelModel.of(model)
    occ = occupation_functions(model)
    for n_nodes, n_prim, batch in ((64, 39, SLAB_BATCH - 77),
                                   (8, 100, 4096 + 37)):
        stacked = synthetic_stack(n_nodes, n_prim)
        s = fused.slab_table_constants(stacked, n_nodes)
        s_tc = fused.slab_split_table_constants(stacked, n_nodes)
        params = bench_params(model, np.random.default_rng(SEED + 5), batch,
                              "cuda")
        pmat = torch.stack([params[k] for k in hod.param_names], dim=1)
        want = fused.slab_predict_plain(s, params, *occ)
        wgs, stages = fused.slab_tc_config(s.n_bins, s.n_xi)
        got = fused.slab_tc_launch(s_tc, pmat, hod)
        torch.cuda.synchronize()
        ngal_err = rel(got[0], want[0])
        node_err = scaled(got[1].reshape(-1, s.n_xi),
                          want[1].reshape(-1, s.n_xi))
        label = (f"slab_tc ragged: {s.n_bins} bins, {n_nodes} nodes, "
                 f"B={batch}, block {64 * wgs} rows, {stages} slots")
        print(f"{label}: kernel vs plain ngal max rel {ngal_err:.3e} "
              f"(<= 1e-6), per-node xi max scaled {node_err:.3e} (<= 1e-6)")
        check(ngal_err <= 1e-6, f"{label}: ngal {ngal_err}")
        check(node_err <= 1e-6, f"{label}: xi {node_err}")
        del got, s, s_tc, want


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
    output bin and node the quadrature FMA and per unit, population and
    node the decoration; a bisection per row, population and block of
    units), each piece at its SASS count
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
    per_row += ng * plan.n_out * c["quadrature_fma"]
    if fam.decorated:
        # Each population of a unit decorated once a node: its shift
        # serves the outputs above and below the split, the second of
        # which costs a multiply-add more.
        above = plan.out_sec.cpu().numpy() >= np.float32(fam.split - 1e-6)
        sides = [np.bincount(unit, pop & side, plan.n_units) > 0
                 for pop in (central, ~central) for side in (above, ~above)]
        both = int((sides[0] & sides[1]).sum() + (sides[2] & sides[3]).sum())
        per_row += n_cen * c["decorate_bounded"] + n_sat * c[
            "decorate_unbounded"] + ng * both * c["multiply"]
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
    s_tc = fused.slab_split_table_constants(stacked, n_nodes)
    s_half = fused.slab_tc_table_constants(stacked, n_nodes)
    s = fused.slab_table_constants(stacked, n_nodes)
    table64 = interp.tabcorr_list[0].table_data(device="cuda",
                                                dtype=torch.float64)
    (dens,), _ = occupation_check(ctx, label, s_tc.occupation_plan, [s_tc],
                                  [stacked], [table64], model, params)
    want = fused.slab_contract_plain(s, dens.t())
    for tier, launch, consts in (("slab_tc", fused.slab_tc_launch, s_tc),
                                 ("slab", fused.slab_launch, s_half)):
        total, nodes = launch(consts, dens, code2)
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
    fp32_ms = median_ms(ctx, lambda: fused.slab_launch(s_half, dens, code2))
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
    dens = fused.occupation_density(stacked, model, params).t().contiguous()
    for tier, launch, consts in (
            ("slab_tc", fused.slab_tc_launch,
             fused.slab_split_table_constants(stacked, n_nodes)),
            ("slab", fused.slab_launch,
             fused.slab_tc_table_constants(stacked, n_nodes))):
        a = launch(consts, dens, code2)
        b = launch(consts, pmat, hod)
        kernel_vs_plain(f"cross-check wide grid {tier}: code 2 against "
                        f"code 1", [(a[0], a[1].reshape(-1, consts.n_xi))],
                        [(b[0], b[1].reshape(-1, consts.n_xi))], (False,))
        del consts


# ----------------------------------------------------------------------
# Joint statistics through engine='auto', and the gradient samplers
# ----------------------------------------------------------------------
N_JOINT_STEPS = 3
N_CHAINS = 4096
NUTS_WARMUP = 10           # Stan's windows: 1, 8 and 1 step
NUTS_STEPS = 2
NUTS_TIMED = 3
MAX_DEPTH = 6
HMC_WARMUP = 6
HMC_STEPS = 4
HMC_LEAPFROG = 8
ZHENG07_NAMES = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")
ZHENG07_BOUNDS = {"logMmin": (10.0, 13.5), "sigma_logM": (0.01, 1.5),
                  "logM0": (9.0, 14.0), "logM1": (11.0, 15.0),
                  "alpha": (0.3, 2.0)}


def bolplanck_tables():
    from tabcorr_tpu_torch import TabCorr
    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    return [TabCorr.read(data / f"bolplanck_{s}.npz") for s in ("wp", "ds")]


def diagonal_data(outs):
    """Each statistic's row 0 as data, 5% errors (a floor of 1e-3)."""
    import numpy as np
    data = [xi[0].double().cpu().numpy().ravel() for _, xi in outs]
    return data, [np.diag(1.0 / (0.05 * np.abs(d) + 1e-3) ** 2)
                  for d in data]


def sampler_phases(ctx, kernels):
    t_phase = time.perf_counter()
    bundle_log_prob = joint_phase(ctx, kernels)
    mixed_members_phase(ctx, kernels)
    log_prob, host_log_prob, positions0 = gradient_posterior(ctx)
    nuts_phase(ctx, log_prob, host_log_prob, positions0, bundle_log_prob)
    hmc_phase(ctx, log_prob, host_log_prob, positions0)
    print(f"joint + sampler phases: {time.perf_counter() - t_phase:.1f} s")


def joint_phase(ctx, kernels):
    """(a) wp + Delta Sigma through make_multi_predictor(engine='auto'):
    the bundle kernel, then ensemble steps over its log posterior."""
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import Zheng07Model, make_multi_predictor
    from tabcorr_tpu_torch.mcmc import make_gaussian_logpost_batched
    from tabcorr_tpu_torch.predictor import multi_engine_for

    tabs = bolplanck_tables()
    model = Zheng07Model(threshold=-18, redshift=tabs[0].attrs["redshift"])
    route = multi_engine_for(tabs, model, torch.float32, "cuda")
    check(route == "bundle", f"joint: engine='auto' picked {route!r}")
    predict = make_multi_predictor(tabs, model, device="cuda",
                                   engine="auto")
    predict_plain = make_multi_predictor(tabs, model, device="cuda",
                                         engine="plain")
    params = bench_params(model, np.random.default_rng(SEED + 40), BATCH,
                          "cuda")
    names = ZHENG07_NAMES

    # ---- path: two predictions, then the ensemble --------------------
    ctx["reset"]()
    predict(params)
    torch.cuda.synchronize()
    check(fused.BUNDLE_LAUNCHES == 1, "joint: a call is not one launch")
    outs = predict(params)
    torch.cuda.synchronize()
    check(fused.BUNDLE_LAUNCHES == 2, "joint: a call is not one launch")
    data, inv_cov = diagonal_data(outs)
    log_prob = make_gaussian_logpost_batched(
        predict, names, model.param_dict, data, inv_cov, device="cuda")
    walkers = walkers_around(ctx, model, names, BATCH, SEED + 41)
    accepts, step_s, lp = run_sampler(ctx, log_prob, walkers, N_JOINT_STEPS,
                                      "BUNDLE_LAUNCHES", SEED + 41)
    launched = ctx["expect"]("joint", bundle=3 + 2 * N_JOINT_STEPS)["bundle"]
    record(kernels, "bundle", launched)
    (ngal, wp), (ngal_ds, ds) = outs
    shapes = (tuple(wp.shape), tuple(ds.shape))
    check(shapes == ((BATCH, 19), (BATCH, 19)), f"joint: shapes {shapes}")
    for name, out in (("ngal", ngal), ("wp", wp), ("ds", ds)):
        check(bool(torch.isfinite(out).all()), f"joint: non-finite {name}")
    print(f"joint (a): make_multi_predictor([bolplanck wp (auto, "
          f"{tabs[0].n_bins} bins), bolplanck Delta Sigma (cross, "
          f"{tabs[1].n_bins} bins)], zheng07 -18, engine='auto') -> "
          f"{route!r}: {launched} bundle launches (one a call: 2 "
          f"predictions, 1 initial log-prob, 2 per ensemble step x "
          f"{N_JOINT_STEPS}); accept fractions {accepts}; "
          f"{BATCH / float(np.median(step_s)):.6g} walker-steps/s "
          f"(per-step host-clock s {step_s}) on {ctx['card']}")

    # ---- the kernel against its plain version (same inputs) -----------
    plain = predict_plain(params)
    torch.cuda.synchronize()
    ngal_err = max(rel(ngal, plain[0][0]), rel(ngal_ds, plain[1][0]))
    wp_err, ds_err = rel(wp, plain[0][1]), scaled(ds, plain[1][1])
    err = max_abs((ngal, plain[0][0]), (ngal_ds, plain[1][0]),
                  (wp, plain[0][1]), (ds, plain[1][1]))
    print(f"joint (a): bundle kernel vs plain (B={BATCH}, wp + cross-mode "
          f"Delta Sigma): ngal max rel {ngal_err:.3e} (<= 1e-6), wp max "
          f"rel {wp_err:.3e} (<= 2e-6), Delta Sigma max scaled "
          f"{ds_err:.3e} (<= 1e-6), max abs {err:.3e}")
    check(ngal_err <= 1e-6, f"joint: ngal kernel vs plain {ngal_err}")
    check(wp_err <= 2e-6, f"joint: wp kernel vs plain {wp_err}")
    check(ds_err <= 1e-6, f"joint: Delta Sigma kernel vs plain {ds_err}")

    # ---- against the float64 host path --------------------------------
    e_ng = e_wp = e_ds = 0.0
    for i in range(N_PROBE):
        m = host_model(model, params, i)
        for tab, (ng, xi), per_element in ((tabs[0], outs[0], True),
                                          (tabs[1], outs[1], False)):
            ng64, xi64 = tab.predict(m, check_consistency=False)
            x, want = xi[i].double().cpu().numpy(), np.ravel(xi64)
            e_ng = max(e_ng, abs(float(ng[i]) / ng64 - 1))
            if per_element:
                e_wp = max(e_wp, float(np.max(np.abs(x / want - 1))))
            else:
                e_ds = max(e_ds, float(np.max(np.abs(x - want)) /
                                       np.max(np.abs(want))))
    print(f"joint (a): bundle vs float64 host at {N_PROBE} probes: ngal "
          f"rel {e_ng:.3e} (<= 1e-6), wp rel per element {e_wp:.3e} "
          f"(<= 1e-6), Delta Sigma scaled {e_ds:.3e} (<= 1e-6)")
    check(e_ng <= 1e-6 and e_wp <= 1e-6 and e_ds <= 1e-6,
          "joint: bundle vs float64")
    ms = ctx["window_ms"](lambda: predict(params), 10)
    print(f"timing (joint): one engine='auto' call (the bundle, wp + "
          f"Delta Sigma) {ms:.4f} ms per {BATCH}-row batch "
          f"({BATCH / ms * 1e3:.6g} predictions/s) on {ctx['card']}")
    return log_prob


def mixed_members_phase(ctx, kernels):
    """(b) A TabCorr and an Interpolator in one make_multi_predictor
    (engine='auto'): one contraction launch and one grid launch a call."""
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import (Interpolator, Zheng07Model,
                                   make_multi_predictor,
                                   occupation_functions)
    from tabcorr_tpu_torch.predictor import (grid_node_weights,
                                             multi_engine_for, stacked_grid)

    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    wp_tab = bolplanck_tables()[0]
    interp = Interpolator.read(data / "ds_efficient.npz")
    model = Zheng07Model(threshold=-21, redshift=0.5,
                         prim_haloprop_key="halo_m258m")
    model.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
    members = [wp_tab, interp]
    route = multi_engine_for(members, model, torch.float32, "cuda")
    check(route == "members", f"mixed: engine='auto' picked {route!r}")
    predict = make_multi_predictor(members, model, device="cuda",
                                   engine="auto")
    rng = np.random.default_rng(SEED + 50)
    params = bench_params(model, rng, BATCH, "cuda")
    v = rng.uniform(-0.45, 0.45, BATCH)
    v[0] = 0.0
    v[list(OUT_ROWS)] = 0.6
    params["log_eta"] = torch.tensor(v, dtype=torch.float32, device="cuda")

    # ---- path ----------------------------------------------------------
    ctx["reset"]()
    (ng_wp, wp), (ng_ds, ds) = predict(params)
    torch.cuda.synchronize()
    launched = ctx["expect"]("mixed members", contraction=1, grid=1)
    record(kernels, "contraction", 1)
    record(kernels, "grid", 1)
    out = torch.zeros(BATCH, dtype=torch.bool, device="cuda")
    out[list(OUT_ROWS)] = True
    ds = ds.reshape(BATCH, -1)
    check(bool(torch.isnan(ng_ds[out]).all() and torch.isnan(ds[out]).all()),
          "mixed: out-of-grid rows are not all NaN")
    check(bool(torch.isfinite(ng_ds[~out]).all() and
               torch.isfinite(ds[~out]).all()),
          "mixed: NaN or inf inside the grid")
    check(bool(torch.isfinite(ng_wp).all() and torch.isfinite(wp).all()),
          "mixed: NaN or inf in the TabCorr member")
    print(f"mixed (b): make_multi_predictor([bolplanck wp TabCorr, "
          f"ds_efficient Interpolator ({interp.tabcorr_list[0].n_bins} "
          f"bins, {len(interp.tabcorr_list)} log_eta nodes)], "
          f"engine='auto') -> {route!r}: launches "
          f"{ {k: v for k, v in launched.items() if v} } in one call; rows "
          f"{OUT_ROWS} outside the grid NaN in the grid member only.  A "
          "check of the route, not a physical fit: one zheng07 model "
          "(threshold -21, M258m) drives the z = 0 wp table and the "
          "z = 0.5 grid")

    # ---- each kernel against its plain version (same inputs) ----------
    table = wp_tab.table_data(device="cuda")
    ngal_p, wp_p = fused.contraction_plain(
        fused.bundle_table_constants(table),
        fused.occupation_density(table, model, params))
    stacked, n_nodes, _ = stacked_grid(interp, device="cuda")
    ngal_g, ds_p = fused.grid_predict_plain(
        fused.grid_table_constants(stacked, n_nodes), params,
        grid_node_weights(interp, params), *occupation_functions(model))
    torch.cuda.synchronize()
    check(torch.equal(torch.isnan(ds_p), torch.isnan(ds)),
          "mixed: the grid kernel's NaN elements differ from the plain "
          "version's")
    c_ngal, c_wp = rel(ng_wp, ngal_p), rel(wp, wp_p.reshape(wp.shape))
    g_ngal = rel(ng_ds[~out], ngal_g[~out])
    g_ds = scaled(ds[~out], ds_p[~out])
    err = max_abs((ng_wp, ngal_p), (wp, wp_p.reshape(wp.shape)),
                  (ng_ds[~out], ngal_g[~out]), (ds[~out], ds_p[~out]))
    print(f"mixed (b): kernels vs plain (B={BATCH}): contraction ngal max "
          f"rel {c_ngal:.3e} (<= 1e-6), wp max rel {c_wp:.3e} (<= 2e-6); "
          f"grid ngal max rel {g_ngal:.3e} (<= 1e-6), Delta Sigma max "
          f"scaled {g_ds:.3e} (<= 1e-6) over the rows inside the grid, "
          f"NaN elements identical; max abs {err:.3e}")
    check(c_ngal <= 1e-6, f"mixed: contraction ngal vs plain {c_ngal}")
    check(c_wp <= 2e-6, f"mixed: contraction wp vs plain {c_wp}")
    check(g_ngal <= 1e-6, f"mixed: grid ngal vs plain {g_ngal}")
    check(g_ds <= 1e-6, f"mixed: grid Delta Sigma vs plain {g_ds}")

    # ---- each member against its own float64 host path ----------------
    e_ng = e_wp = e_ds = 0.0
    for i in range(N_PROBE):
        m = host_model(model, params, i)
        ng64, wp64 = wp_tab.predict(m, check_consistency=False)
        e_ng = max(e_ng, abs(float(ng_wp[i]) / ng64 - 1))
        e_wp = max(e_wp, float(np.max(np.abs(
            wp[i].double().cpu().numpy() / np.ravel(wp64) - 1))))
        ng64, ds64 = interp.predict(m, check_consistency=False)
        e_ng = max(e_ng, abs(float(ng_ds[i]) / ng64 - 1))
        e_ds = max(e_ds, float(np.max(np.abs(
            ds[i].double().cpu().numpy() - np.ravel(ds64))) /
            np.max(np.abs(ds64))))
    print(f"mixed (b): vs float64 host at {N_PROBE} probes: ngal rel "
          f"{e_ng:.3e} (<= 1e-6), wp (contraction) rel per element "
          f"{e_wp:.3e} (<= 1e-6), Delta Sigma (grid) scaled {e_ds:.3e} "
          "(<= 1e-6)")
    check(e_ng <= 1e-6 and e_wp <= 1e-6 and e_ds <= 1e-6,
          "mixed: members vs float64")
    ms = ctx["window_ms"](lambda: predict(params), 5)
    print(f"timing (mixed): one engine='auto' call (contraction + grid "
          f"spline weights + grid kernel) {ms:.4f} ms per {BATCH}-row "
          f"batch on {ctx['card']}")


def gradient_posterior(ctx):
    """The zheng07 log posterior over wp + Delta Sigma on the plain
    float64 engine, on the card and on the host, and the chains' start:
    N_CHAINS around the fiducial values."""
    torch, np = ctx["torch"], ctx["np"]
    from tabcorr_tpu_torch import Zheng07Model, make_multi_predictor
    from tabcorr_tpu_torch.mcmc import make_gaussian_logpost_batched
    from tabcorr_tpu_torch.predictor import multi_engine_for

    tabs = bolplanck_tables()
    model = Zheng07Model(threshold=-18, redshift=tabs[0].attrs["redshift"])
    route = multi_engine_for(tabs, model, torch.float64, "cuda")
    check(route == "members", f"float64: engine='auto' picked {route!r}")
    data = [np.ravel(tab.predict(model)[1]) for tab in tabs]
    inv_cov = [np.diag(1.0 / (0.05 * np.abs(d) + 1e-3) ** 2) for d in data]

    def log_posterior(device):
        predict = make_multi_predictor(tabs, model, dtype=torch.float64,
                                       device=device, engine="auto")
        return make_gaussian_logpost_batched(
            predict, ZHENG07_NAMES, model.param_dict, data, inv_cov,
            bounds=ZHENG07_BOUNDS, device=device)

    rng = np.random.default_rng(SEED + 60)
    truth = np.array([model.param_dict[k] for k in ZHENG07_NAMES])
    positions0 = torch.tensor(
        truth + 0.01 * rng.normal(size=(N_CHAINS, len(truth))),
        dtype=torch.float64, device="cuda")
    return log_posterior("cuda"), log_posterior("cpu"), positions0


def gradient_check(ctx, label, log_prob, host_log_prob, q):
    """The log probability and its gradient on 16 chains against the
    same float64 computation on the host: 1e-10 relative (the gradient
    relative to each row's largest component)."""
    torch = ctx["torch"]
    from tabcorr_tpu_torch.mcmc import _value_and_grad
    lp, grad = _value_and_grad(log_prob, q[:N_PROBE])
    lp_h, grad_h = _value_and_grad(host_log_prob, q[:N_PROBE].cpu())
    check(bool(torch.isfinite(lp).all() and torch.isfinite(grad).all()),
          f"{label}: non-finite log-prob or gradient")
    e_lp, e_g = rel(lp.cpu(), lp_h), scaled(grad.cpu(), grad_h)
    print(f"{label}: log-prob and gradient on the card vs the host, "
          f"{N_PROBE} chains: log-prob rel {e_lp:.3e}, gradient scaled "
          f"{e_g:.3e} (<= 1e-10)")
    check(e_lp <= 1e-10 and e_g <= 1e-10, f"{label}: card vs host")


def counted(log_prob):
    """``log_prob`` counting its calls (each a batched gradient).  While
    ``fn.spans`` is a list, each call that autograd differentiates adds
    its span on the stream to it: a CUDA event recorded where the forward
    starts and one recorded where the backward reaches ``theta`` (an
    identity node, the last one the backward runs)."""
    import torch

    class Span(torch.autograd.Function):
        @staticmethod
        def forward(ctx, theta, span):
            ctx.span = span
            return theta.view_as(theta)

        @staticmethod
        def backward(ctx, grad):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            ctx.span.append(end)
            return grad, None

    def fn(theta):
        fn.calls += 1
        if fn.spans is not None and theta.requires_grad:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            span = [start]
            fn.spans.append(span)
            theta = Span.apply(theta, span)
        return log_prob(theta)
    fn.calls, fn.spans = 0, None
    return fn


def chains_check(ctx, label, q, lp):
    torch = ctx["torch"]
    check(not bool(torch.isnan(q).any()), f"{label}: NaN in the chains")
    check(bool(torch.isfinite(lp).all()), f"{label}: non-finite log-prob")


def nuts_phase(ctx, log_prob, host_log_prob, positions0, bundle_log_prob):
    """(c) run_nuts on the plain float64 engine on the card, N_CHAINS
    chains, mass-matrix warmup, then timed nuts_steps."""
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch.mcmc import _value_and_grad, nuts_step, run_nuts

    gradient_check(ctx, "nuts (c) start", log_prob, host_log_prob,
                   positions0)
    generator = torch.Generator(device="cuda").manual_seed(SEED + 61)
    fn = counted(log_prob)
    # ---- path ----------------------------------------------------------
    ctx["reset"]()
    t0 = time.perf_counter()
    chain, lp, mean_depth, step_size = run_nuts(
        generator, fn, positions0, NUTS_WARMUP, NUTS_STEPS,
        max_depth=MAX_DEPTH, initial_step_size=0.01, adapt_mass_matrix=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ctx["expect"]("nuts (plain float64 engine)")
    chains_check(ctx, "nuts", chain, lp)
    check(float(mean_depth) >= 1.0, f"nuts: mean depth {mean_depth}")
    print(f"nuts (c): run_nuts, {N_CHAINS} chains x 5 zheng07 parameters, "
          f"wp + Delta Sigma on the plain float64 engine (no kernel "
          f"launched), max_depth {MAX_DEPTH}, {NUTS_WARMUP} warmup steps "
          f"with the mass matrix + {NUTS_STEPS}: {run_s:.2f} s, "
          f"{fn.calls} batched gradients, mean depth "
          f"{float(mean_depth):.4g}, step size {step_size:.6g}")

    # ---- timed steps at the adapted step size: each step and each -----
    # ---- batched gradient inside it on the stream's CUDA events --------
    q = chain[-1]
    inv_mass = q.var(dim=0, correction=0)
    step_ms, grad_ms, outside, n_grads = [], [], [], []
    for _ in range(NUTS_TIMED):
        fn.spans = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        q, lp, depth, accept, n_grad = nuts_step(
            generator, q, fn, step_size, MAX_DEPTH, inv_mass)
        end.record()
        end.synchronize()
        check(all(len(span) == 2 for span in fn.spans),
              "nuts: a batched gradient without its backward")
        spans = [a.elapsed_time(b) for a, b in fn.spans]
        step_ms.append(start.elapsed_time(end))
        grad_ms.append(spans)
        outside.append(1 - sum(spans) / step_ms[-1])
        n_grads.append(int(n_grad.sum()))
        chains_check(ctx, "nuts step", q, lp)
        check(bool(((accept >= 0) & (accept <= 1)).all()),
              "nuts: accept statistic outside [0, 1]")
    fn.spans = None
    gradient_check(ctx, "nuts (c) end", log_prob, host_log_prob, q)
    ms = float(np.median(step_ms))
    all_spans = [t for spans in grad_ms for t in spans]
    print(f"nuts (c): {ms:.4f} ms per NUTS step (median of {step_ms}, "
          f"CUDA events), {[len(t) for t in grad_ms]} batched gradients a "
          f"step (each {float(np.median(all_spans)):.4f} ms median, "
          f"{min(all_spans):.4f}-{max(all_spans):.4f} ms, on the stream "
          f"from the forward's start to the backward's end), "
          f"{sum(n_grads) / (sum(step_ms) / 1e3):.6g} chain gradient "
          f"evaluations/s ({n_grads} a step over {N_CHAINS} chains), one "
          f"host read a leapfrog; share of each step outside the batched "
          f"gradients (host reads, masking, draws) {outside}; depths "
          f"{torch.bincount(depth).tolist()} on {ctx['card']}")

    # ---- the kernels give no gradient ---------------------------------
    refused = None
    try:
        _value_and_grad(bundle_log_prob, positions0[:4].float())
    except RuntimeError as err:
        refused = str(err)
    check(refused == fused.NO_GRADIENT,
          f"the bundle gave a gradient or another error: {refused}")
    print(f"nuts (c): autograd through the bundle kernel refuses: {refused}")


def hmc_phase(ctx, log_prob, host_log_prob, positions0):
    """(d) run_hmc_adaptive on the same log posterior."""
    torch, np = ctx["torch"], ctx["np"]
    from tabcorr_tpu_torch.mcmc import run_hmc_adaptive

    generator = torch.Generator(device="cuda").manual_seed(SEED + 70)
    fn = counted(log_prob)
    ctx["reset"]()
    t0 = time.perf_counter()
    chain, lp, accept, step_size = run_hmc_adaptive(
        generator, fn, positions0, HMC_WARMUP, HMC_STEPS,
        n_leapfrog=HMC_LEAPFROG, initial_step_size=0.005)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ctx["expect"]("hmc (plain float64 engine)")
    chains_check(ctx, "hmc", chain, lp)
    check(0.0 <= float(accept) <= 1.0, f"hmc: accept fraction {accept}")
    check(bool((chain[-1] != positions0).any()), "hmc: no chain moved")
    gradient_check(ctx, "hmc (d) end", log_prob, host_log_prob, chain[-1])
    steps = HMC_WARMUP + HMC_STEPS
    print(f"hmc (d): run_hmc_adaptive, {N_CHAINS} chains, {HMC_WARMUP} "
          f"warmup + {HMC_STEPS} steps of {HMC_LEAPFROG} leapfrogs: "
          f"{run_s / steps * 1e3:.4g} ms per HMC step ({fn.calls} batched "
          f"gradients), accept fraction {float(accept):.4g}, step size "
          f"{step_size:.6g} on {ctx['card']}")


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
    for the function, not as tabcorr_tpu's ``_tile_geometry`` writes it
    (a compare and an add for every edge on every pair).  Returns (a, b,
    c): a for every pair a layout evaluates, b more for a pair within
    pi_max (rppi), c more for a kept pair.  A kept pair needs all three,
    whatever enumerates it.

    An axis costs 3: the difference and the minimum image as a compare
    and a conditional subtract.  Every pair: the self test (auto, 1) and
    its rejection path -- rppi: the z axis and |dz| < pi_max (4), then,
    within pi_max, x, y, rp^2 (two products, a sum) and its two range
    tests (11); smu: three axes, rp^2, s^2 (a product, a sum) and its two
    range tests (16); proj: x, y, rp^2 and its range tests (11).  A kept
    pair: its radial bin by a branch-free binary search over the edges (a
    compare and a select a halving); for smu also the root, the guarded
    division (2), the mu search, its clip (2) and the flat sub-bin; then
    the cell's address and one add a channel, and ln(rp) for a log_rp
    channel (the clamp, the log, two products)."""
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


def z_slab_pairs(sweep, cut):
    """The ordered pairs of labeled tracers (distinct, in auto mode) whose
    periodic |dz| lies below ``cut`` (every pair where cut is None or
    spans half the period), counted in float64 on the sweep's own
    tracers: no layout is read, so the count does not move with the
    enumeration."""
    import torch
    pos2, labels2, _ = sweep.j_side()
    z1 = sweep.pos1[sweep.labels1 >= 0, 2].double()
    z2 = pos2[labels2 >= 0, 2].double()
    n_self = len(z1) if sweep.auto else 0
    pz = sweep.period[2]
    if cut is None or 2 * cut >= pz:
        return len(z1) * len(z2) - n_self
    z2 = torch.sort(z2).values
    zz = torch.cat([z2 - pz, z2, z2 + pz])
    n = (torch.searchsorted(zz, z1 + cut) -
         torch.searchsorted(zz, z1 - cut, right=True)).sum()
    return int(n) - n_self


def valid_pairs(sweep, hist):
    """The kept pairs of a sweep: its unit counts, or its weight channel
    where every weight is 1 (float64 sums of ones are exact)."""
    check(sweep.unit_counts or (sweep.pair_weight != "log_rp" and
                                bool((sweep.j_side()[2] == 1).all())),
          "kept pairs of a sweep with unequal weights")
    return int(hist[:sweep.n_hist].sum())


def paircount_bounds(sweep, kept):
    """The least time for a sweep, two ways, each the larger of its
    operations at PEAK_LANE_OPS and its bytes (each tracer's 16-byte
    record and label read once, the histogram written once) at
    PEAK_HBM_BYTES:

    * the kept-pair bound: every kept pair's whole geometry and bin, (a +
      b + c) of :func:`bound_ops`, whatever layout enumerates it;
    * the z-slab bound, over the z-slab's pairs: a for each pair within
      the z cut (:func:`z_slab_pairs`; every pair for 'proj'), b more
      within pi_max, c more a kept pair -- what the function needs over
      the z-window enumeration of a layout without xy cells (tiles of one
      label sorted in z).

    Returns (kept-pair bound dict, z-slab bound ms, counts dict)."""
    a, b, c = bound_ops(sweep)
    slab = z_slab_pairs(sweep, sweep.z_cut)
    within = z_slab_pairs(sweep, sweep.pi_max) if sweep.kind == "rppi" \
        else 0
    n2 = 0 if sweep.auto else len(sweep.pos2)
    n_bytes = (20 * (len(sweep.pos1) + n2) +
               8 * sweep.n_channels * sweep.n_hist)
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    kept_ops = kept * (a + b + c)
    ops_ms = kept_ops / PEAK_LANE_OPS * 1e3
    slab_ops = a * slab + b * within + c * kept
    return ({"bound_ms": max(ops_ms, bytes_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"},
            max(slab_ops / PEAK_LANE_OPS * 1e3, bytes_ms),
            dict(slab=slab, within=within, kept_ops=kept_ops,
                 slab_ops=slab_ops, n_bytes=n_bytes, a=a, b=b, c=c))


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
    and plain ms, its kept-pair bound and its error, and the main path's
    kernel ms and kept-pair bound."""
    torch, pc = ctx["torch"], ctx["paircount"]
    sweep, layout = rec["sweep"], rec["layout"]
    kernel_ms = rec["kernel_ms"]
    kept = valid_pairs(sweep, rec["hist"])
    candidates = rec["visited"]
    counted = pc.candidate_count(sweep, layout)
    check(candidates == counted, f"{label}: the kernel evaluated "
          f"{candidates} pairs, its layout's runs hold {counted}")
    b, slab_ms, n = paircount_bounds(sweep, kept)
    within = f" + {n['within']} x {n['b']}" if n["b"] else ""
    print(f"tabulation {label}: {len(sweep.pos1)} i-tracers x "
          f"{len(sweep.pos1 if sweep.auto else sweep.pos2)} j-tracers, "
          f"{sweep.n_labels_1} x {sweep.n_labels_2} labels, kind "
          f"{sweep.kind}, {sweep.pair_weight}"
          f"{'' if sweep.unit_counts else ' (weighted)'}, z window "
          f"{sweep.z_cut}; {layout.cells[0]} x {layout.cells[1]} cells, "
          f"{len(layout.neighbours)} neighbour cells a tile, "
          f"{len(layout.group_start) - 1} label groups of <= "
          f"{layout.group_rows}, {layout.n_tiles} tiles "
          f"({len(layout.pos1) / layout.n_tiles:.1f} tracers a tile)")
    print(f"tabulation {label}: pairs within the z cut {n['slab']} "
          f"(independent of the enumeration), kernel candidates "
          f"{candidates} ({n['slab'] / max(candidates, 1):.3f}x fewer; "
          f"the layout's runs hold as many), kept {kept} "
          f"({kept / max(candidates, 1):.3f} of the candidates)")
    print(f"tabulation {label}: paircount kernel {kernel_ms:.2f} ms (CUDA "
          f"events around the launch; {rec['sweep_s'] * 1e3:.2f} ms wall "
          f"with the wrapper's input checks, layout "
          f"{rec['layout_s'] * 1e3:.2f} ms), 1 launch, "
          f"{candidates / kernel_ms * 1e3:.4g} candidates/s; kept-pair "
          f"bound {b['bound_ms']:.2f} ms ({b['bound_by']}: {kept} x "
          f"{n['a'] + n['b'] + n['c']} ops at 33.5 T lane-ops/s; "
          f"{n['n_bytes'] / 1e6:.1f} MB), share "
          f"{b['bound_ms'] / kernel_ms:.4f}; the z-slab bound (over the "
          f"z-slab's pairs) {slab_ms:.2f} ms ({n['slab']} x {n['a']}{within} + "
          f"{kept} x {n['c']} ops), share {slab_ms / kernel_ms:.4f} on "
          f"{ctx['card']}")
    print(f"tabulation {label}: stages (s) " + ", ".join(
        f"{k} {rec[k + '_s']:.3f}"
        for k in ("mock", "layout", "sweep", "estimator")) +
        " (mock: everything before the sweep's call -- binning, the dense "
        "mock, RSD, the AP stretch, tensors to the card; estimator: "
        "everything after it)")
    sub = subsample(ctx, sweep, TAB_SUBSAMPLE, SEED + 91)
    ctx.setdefault("subsamples", {})[label] = sub
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
    sb, _, _ = paircount_bounds(sub, valid_pairs(sub, want))
    print(f"tabulation {label}: subsample kernel {k_ms:.3f} ms, plain "
          f"PyTorch {p_ms:.1f} ms, kept-pair bound {sb['bound_ms']:.3f} ms "
          f"({pc.candidate_count(sub, sub_layout)} candidates) on "
          f"{ctx['card']}")
    max_abs_err = float((got.double() - want.double()).abs().max())
    out = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=max_abs_err, **sb,
               main_path_ms=kernel_ms, main_path_bound_ms=b["bound_ms"])
    if label == "wp":
        out.update(native_comparison(ctx, label, sub, want, k_ms))
    return out


def native_comparison(ctx, label, sub, want, kernel_ms):
    """The host C++ counter (``strategy="native"``, float64 geometry; the
    JAX package's CPU production path) on the subsample, on this machine's
    CPU: its ms (median of 3 calls after the build) beside the kernel's,
    and its unit counts against the plain version's, which may differ only
    by pairs whose float32 and float64 geometries bin differently (the
    edges given as the sweep's own float32 squares): at most 1e-6 of the
    kept pairs."""
    import os
    np, pc = ctx["np"], ctx["paircount"]
    from tabcorr_tpu_torch import native
    check(sub.kind == "rppi" and sub.unit_counts,
          f"{label}: the native comparison takes a unit rppi sweep")
    t0 = time.perf_counter()
    native.load_library()
    build_s = time.perf_counter() - t0
    args = (sub.pos1.cpu().numpy(), sub.labels1.cpu().numpy(),
            sub.n_labels_1)
    kw = dict(period=sub.period, kind="rppi",
              r_edges=np.sqrt(sub.edges_sq.astype(np.float64)),
              pi_max=sub.pi_max, strategy="native", device="cpu")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        counts = pc.labeled_pair_count(*args, **kw)
        times.append((time.perf_counter() - t0) * 1e3)
    plain = want.cpu().numpy().reshape(counts.shape)
    kept = int(plain.sum())
    moved = int(np.abs(counts - plain).sum())
    native_ms = float(np.median(times))
    cores = os.cpu_count()
    print(f"tabulation {label}: host C++ counter (strategy='native', float64 "
          f"geometry) on the {len(sub.pos1)}-tracer subsample: "
          f"{native_ms:.1f} ms (median of {[round(t, 1) for t in times]}; "
          f"g++ build {build_s:.1f} s) on {cores} CPU cores of the card's "
          f"host, against the kernel's {kernel_ms:.3f} ms on {ctx['card']}; "
          f"its unit counts differ from the plain version's by {moved} of "
          f"{kept} pairs, in {int((counts != plain).sum())} cells (<= 1e-6 "
          f"of the pairs: float32 against float64 geometry at the edges)")
    check(moved <= 1e-6 * kept, f"{label}: native vs plain {moved} pairs")
    return dict(native_ms=native_ms, native_cores=cores)


def sweep_spy(ctx, records):
    """A stand-in for ``ops.paircount.paircount`` that runs each sweep as
    it does on the card (one launch, one progress step) and appends to
    ``records`` its inputs, layout, histogram and the pairs the kernel
    evaluated, timed by stage on the host clock (synchronized): the
    layout, then the launch with its input checks; the kernel alone by
    CUDA events."""
    torch, pc = ctx["torch"], ctx["paircount"]
    from tabcorr_tpu_torch.utils.progress import progress as progress_bar

    def spy(sweep, progress=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        layout = pc.bucket_layout(sweep)
        visited = torch.zeros(1, dtype=torch.int64, device=sweep.device)
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in progress_bar(range(1), desc="pair counting",
                              disable=not progress):
            hist = pc.paircount_launch(sweep, layout, visited, events)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        records.append(dict(sweep=sweep, hist=hist, layout=layout,
                            visited=int(visited),
                            kernel_ms=events[0].elapsed_time(events[1]),
                            t_call=t0, layout_s=t1 - t0, sweep_s=t2 - t1,
                            t_return=t2))
        return hist
    return spy


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
    spy = sweep_spy(ctx, records)

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
                                        "bound_ms", "bound_by", "native_ms",
                                        "native_cores")},
           main_path_ms=sum(r["main_path_ms"] for r in reports.values()),
           main_path_bound_ms=sum(r["main_path_bound_ms"]
                                  for r in reports.values()))
    print(f"tabulation phase: {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# The table-making pipeline: snapshot -> CLI -> Interpolator -> B2
# ----------------------------------------------------------------------
# An AbacusSummit-style snapshot of the tabulation phase's catalog: the
# base simulations' particle mass (6912^3 particles in 2 Gpc/h) and the
# same resolution's particles per dimension in the 250 Mpc/h box, at z =
# 0.5 (the published lensing grid's redshift).
PIPE_REDSHIFT = 0.5
PIPE_PARTICLE_MASS = 2.109e9
PIPE_PPD = 864
PIPE_SO_DENSITY = 200.0
PIPE_PTCL_REQUIREMENT = 299     # the CLI's AbacusSummit cut
# (statistic, nodes, sweeps a node) of the 'efficient' grids: Delta Sigma
# over log_eta; wp over alpha_s x log_eta (alpha_c pruned at pi_max 80),
# three projections a node.
PIPE_GRIDS = (("ds", 4, 1), ("wp", 16, 3))


def pipeline_phase(ctx, kernels):
    """The production CLI on the card: ``scripts/torch_parse_snapshot.py``'s
    ``write_snapshot`` writes snapshot.npz into a temporary database, then
    ``scripts/torch_tabulate_snapshot.py``'s ``main`` makes the
    'efficient' Delta Sigma grid (4 nodes, one sweep a node) and wp grid
    (16 nodes, three projections a node), and each assembled Interpolator
    predicts through ``make_predictor(engine="fused")`` (the grid kernel)."""
    import os
    import tempfile
    torch, np = ctx["torch"], ctx["np"]
    import tabcorr_tpu_torch as tp
    from tabcorr_tpu_torch.utils.synthetic import (synthetic_halocat,
                                                   synthetic_particles)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import torch_parse_snapshot
    import torch_tabulate_snapshot

    t_phase = time.perf_counter()
    halocat = synthetic_halocat(TAB_HALOS, TAB_LBOX)
    particles = synthetic_particles(TAB_PARTICLES, halocat)
    h = halocat.halo_table
    halos = {k: h[k] for k in ("halo_x", "halo_y", "halo_z", "halo_vx",
                               "halo_vy", "halo_vz")}
    halos.update(halo_m200m=h["halo_mvir"], halo_r200m=h["halo_rvir"],
                 halo_rs=h["halo_rvir"] / h["halo_nfw_conc"])
    meta = {"BoxSize": TAB_LBOX, "SODensityL1": PIPE_SO_DENSITY,
            "ParticleMassHMsun": PIPE_PARTICLE_MASS, "ppd": PIPE_PPD}
    pos = particles.positions
    kept = int(np.sum(h["halo_mvir"] >
                      PIPE_PTCL_REQUIREMENT * PIPE_PARTICLE_MASS))
    saved = os.environ.get("TABCORR_DATABASE")
    with tempfile.TemporaryDirectory() as root:
        os.environ["TABCORR_DATABASE"] = root
        try:
            base = tp.database.directory("AbacusSummit", PIPE_REDSHIFT)
            t0 = time.perf_counter()
            torch_parse_snapshot.write_snapshot(
                base / "snapshot.npz", halos, meta,
                particles={"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]})
            print(f"pipeline: snapshot.npz ({TAB_HALOS} hosts, {len(pos)} "
                  f"particles, {TAB_LBOX} Mpc/h, z = {PIPE_REDSHIFT}) "
                  f"{(base / 'snapshot.npz').stat().st_size / 1e6:.1f} MB "
                  f"in {time.perf_counter() - t0:.2f} s; particle mass "
                  f"{PIPE_PARTICLE_MASS:.4g} Msun/h: the "
                  f"{PIPE_PTCL_REQUIREMENT}-particle cut keeps {kept} of "
                  f"{TAB_HALOS} hosts (M > "
                  f"{PIPE_PTCL_REQUIREMENT * PIPE_PARTICLE_MASS:.3g})")
            interps = {}
            for tpcf, n_nodes, sweeps in PIPE_GRIDS:
                interps[tpcf] = pipeline_run(
                    ctx, kernels, torch_tabulate_snapshot, base, tpcf,
                    n_nodes, sweeps)
        finally:
            if saved is None:
                os.environ.pop("TABCORR_DATABASE")
            else:
                os.environ["TABCORR_DATABASE"] = saved
    pipeline_predictions(ctx, kernels, interps)
    print(f"pipeline phase: {time.perf_counter() - t_phase:.1f} s")


def pipeline_run(ctx, kernels, cli, base, tpcf, n_nodes, sweeps):
    """One ``main()`` of the tabulation CLI ('efficient', --format npz,
    --seed 1, the default --device cuda) with its sweeps, tabulations and
    writes timed; node 0 held against a direct ``TabCorr.tabulate`` with
    the same arguments.  Returns the Interpolator read back."""
    torch, np, pc = ctx["torch"], ctx["np"], ctx["paircount"]
    import tabcorr_tpu_torch as tp
    records, calls, writes = [], [], []
    spy = sweep_spy(ctx, records)
    tabulate = tp.TabCorr.__dict__["tabulate"]
    write_npz = tp.TabCorr.write_npz
    write_interp = tp.Interpolator.write_npz

    def timed_tabulate(cls, *args, **kwargs):
        t0 = time.perf_counter()
        tab = tabulate.__func__(cls, *args, **kwargs)
        calls.append(dict(args=args, kwargs=kwargs, t0=t0,
                          s=time.perf_counter() - t0,
                          sweeps=len(records)))
        return tab

    def timed(write):
        """``write`` appending (seconds, bytes, end time) to writes."""
        def run(self, fname, *args, **kwargs):
            t0 = time.perf_counter()
            write(self, fname, *args, **kwargs)
            t1 = time.perf_counter()
            writes.append((t1 - t0, Path(fname).stat().st_size, t1))
        return run

    argv = ["AbacusSummit", str(PIPE_REDSHIFT), "--tpcf", tpcf,
            "--tab_config", "efficient", "--format", "npz", "--seed", "1"]
    dispatch = pc.paircount
    pc.paircount = spy
    tp.TabCorr.tabulate = classmethod(timed_tabulate)
    tp.TabCorr.write_npz = timed(write_npz)
    tp.Interpolator.write_npz = timed(write_interp)
    try:
        ctx["reset"]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(argv)
        whole_s = time.perf_counter() - t0
        launched = ctx["expect"](f"pipeline {tpcf}",
                                 paircount=n_nodes * sweeps)["paircount"]
    finally:
        pc.paircount = dispatch
        tp.TabCorr.tabulate = tabulate
        tp.TabCorr.write_npz = write_npz
        tp.Interpolator.write_npz = write_interp
    record(kernels, "paircount", launched)
    check(len(calls) == n_nodes and len(writes) == n_nodes + 1,
          f"pipeline {tpcf}: {len(calls)} tabulations, {len(writes)} writes")
    print(f"pipeline {tpcf}: torch_tabulate_snapshot.main({' '.join(argv)}): "
          f"{n_nodes} nodes, {launched} paircount launches ({sweeps} a node) "
          f"in {whole_s:.2f} s on {ctx['card']}")
    node_s = []
    for i, call in enumerate(calls):
        recs = records[call["sweeps"] - sweeps:call["sweeps"]]
        sweep_s = sum(r["layout_s"] + r["sweep_s"] for r in recs)
        layout_s = sum(r["layout_s"] for r in recs)
        kernel_s = sum(r["kernel_ms"] for r in recs) / 1e3
        write_s = writes[i][0]
        node_s.append((call["s"] - sweep_s, layout_s, kernel_s, write_s,
                       call["s"] + write_s))
        print(f"pipeline {tpcf} node {i}: {len(recs[0]['sweep'].pos1)} "
              f"tracers; mock {call['s'] - sweep_s:.3f} s (binning, the "
              f"dense mock, RSD, estimators), layout {layout_s:.3f} s, "
              f"kernel {kernel_s:.4f} s (CUDA events, {sweeps} launch"
              f"{'es' if sweeps > 1 else ''}), launch wall "
              f"{sweep_s - layout_s:.3f} s, write {write_s:.3f} s "
              f"({writes[i][1] / 1e3:.1f} kB)")
    t = np.array(node_s)
    assembly_s = t0 + whole_s - writes[n_nodes - 1][2]
    written = sum(w[1] for w in writes)
    print(f"pipeline {tpcf}: per node (median [min, max]) mock "
          f"{np.median(t[:, 0]):.3f} [{t[:, 0].min():.3f}, "
          f"{t[:, 0].max():.3f}] s, layout {np.median(t[:, 1]):.3f} s, "
          f"kernel {np.median(t[:, 2]):.4f} s, write {np.median(t[:, 3]):.3f}"
          f" s, node {np.median(t[:, 4]):.3f} [{t[:, 4].min():.3f}, "
          f"{t[:, 4].max():.3f}] s; the Interpolator's assembly (read "
          f"{n_nodes} tables, build, write) {assembly_s:.3f} s, its file "
          f"{writes[-1][1] / 1e6:.3f} MB; bytes written {written} "
          f"({written / 1e6:.3f} MB: {n_nodes} node files and the "
          f"Interpolator); whole run {whole_s:.2f} s on {ctx['card']}")

    # ---- node 0 against a direct TabCorr.tabulate ------------------------
    node0 = records[:sweeps]
    direct_records = []
    pc.paircount = sweep_spy(ctx, direct_records)
    try:
        direct = tp.TabCorr.tabulate(*calls[0]["args"], **calls[0]["kwargs"])
    finally:
        pc.paircount = dispatch
    errs = [hist_errors(b["hist"], a["hist"], a["sweep"].unit_counts)
            for a, b in zip(node0, direct_records)]
    unit = node0[0]["sweep"].unit_counts
    path = base / "efficient"
    written0 = tp.TabCorr.read(path / f"{tpcf}_0.npz")
    table_err = float(np.max(np.abs(
        written0.tpcf_matrix - direct.tpcf_matrix.astype(np.float32))) /
        np.max(np.abs(direct.tpcf_matrix)))
    same_bins = all(np.array_equal(written0.gal_type[c], direct.gal_type[c])
                    for c in direct.gal_type.colnames)
    print(f"pipeline {tpcf}: node 0 against a direct TabCorr.tabulate with "
          f"its arguments (seed {calls[0]['kwargs']['seed']}): sweeps "
          f"{errs} {'cells unequal' if unit else 'max rel per cell'} "
          f"({'0' if unit else '<= 1e-7'}); the written table against the "
          f"direct one in float32 {table_err:.3e} scaled (unit counts: 0; "
          f"weighted: <= 1e-6), gal_type equal {same_bins}")
    check(len(direct_records) == sweeps and same_bins and
          all(e == 0 if unit else e <= 1e-7 for e in errs),
          f"pipeline {tpcf}: node 0 vs direct tabulate {errs}")
    check(table_err == 0 if unit else table_err <= 1e-6,
          f"pipeline {tpcf}: node 0 table vs direct {table_err}")
    interp = tp.database.read("AbacusSummit", PIPE_REDSHIFT, tpcf,
                              tab_config="efficient", format="npz")
    check(len(interp.tabcorr_list) == n_nodes,
          f"pipeline {tpcf}: {len(interp.tabcorr_list)} nodes read back")
    return interp


def pipeline_predictions(ctx, kernels, interps):
    """Both assembled Interpolators through ``make_predictor(engine=
    "fused")`` at BATCH rows: zheng07 on the wp grid, zheng07 and
    AssembiasLeauthaud11 on the Delta Sigma grid (the grid kernel; the
    occupation kernel for the family), each held at 16 probes to the host
    float64 ``Interpolator.predict`` at 1e-6 (ngal relative, the
    statistic scaled: an unclustered catalog's wp crosses zero)."""
    torch, np = ctx["torch"], ctx["np"]
    from tabcorr_tpu_torch import (AssembiasLeauthaud11Model, Zheng07Model,
                                   make_predictor)
    rng = np.random.default_rng(SEED + 100)
    kw = dict(redshift=PIPE_REDSHIFT, prim_haloprop_key="halo_m200m")
    cases = [("wp", Zheng07Model(threshold=-20, **kw)),
             ("ds", Zheng07Model(threshold=-21, **kw)),
             ("ds", AssembiasLeauthaud11Model(threshold=10.5, **kw))]
    launches = occ_launches = 0
    for tpcf, model in cases:
        interp = interps[tpcf]
        name = f"pipeline {tpcf} grid, {type(model).__name__}"
        if isinstance(model, Zheng07Model):
            params = bench_params(model, rng, BATCH, "cuda")
        else:
            params = family_params(model, rng, BATCH)
        for key, lo, hi in (("alpha_s", 0.85, 1.15), ("log_eta", -0.4, 0.4)):
            if key in interp.keys:
                model.param_dict[key] = 0.5 * (lo + hi)
                v = rng.uniform(lo, hi, BATCH)
                v[0] = model.param_dict[key]
                params[key] = torch.tensor(v, dtype=torch.float32,
                                           device="cuda")
        predict = make_predictor(interp, model, engine="fused",
                                 accuracy="scaled", device="cuda")
        occupation = 0 if isinstance(model, Zheng07Model) else 1
        ctx["reset"]()
        ngal, xi = predict(params)
        torch.cuda.synchronize()
        got = ctx["expect"](name, grid=1, occupation=occupation)
        launches += got["grid"]
        occ_launches += got["occupation"]
        xi = xi.reshape(BATCH, -1)
        check(bool(torch.isfinite(ngal).all() and torch.isfinite(xi).all()),
              f"{name}: non-finite predictions")
        e_ng = e_xi = 0.0
        for i in range(N_PROBE):
            ng64, xi64 = interp.predict(host_model(model, params, i),
                                        check_consistency=False)
            got = xi[i].double().cpu().numpy()
            e_xi = max(e_xi, float(np.max(np.abs(got - np.ravel(xi64))) /
                                   np.max(np.abs(xi64))))
            e_ng = max(e_ng, abs(float(ngal[i]) / ng64 - 1))
        ms = median_ms(ctx, lambda: predict(params))
        print(f"{name} ({interp.tabcorr_list[0].n_bins} bins, "
              f"{len(interp.tabcorr_list)} nodes over {interp.keys}, "
              f"{interp.tabcorr_list[0].mode}): {BATCH} rows, 1 grid "
              f"launch{', 1 occupation launch' if occupation else ''}; vs "
              f"float64 Interpolator.predict at {N_PROBE} probes: ngal rel "
              f"{e_ng:.3e}, statistic scaled {e_xi:.3e} (<= 1e-6); "
              f"predictor {ms:.3f} ms ({BATCH / ms * 1e3:.6g} predictions/s)"
              f" on {ctx['card']}")
        check(e_ng <= 1e-6 and e_xi <= 1e-6, f"{name} vs float64")
    record(kernels, "grid", launches)
    record(kernels, "occupation", occ_launches)


# ----------------------------------------------------------------------
# Path 12: the bfloat16 route (B3 on bfloat16 tables) and the examples
# ----------------------------------------------------------------------
PEAK_BF16_FLOPS = 989e12        # dense BF16 on the tensor cores
BF16_U = 2.0 ** -8              # bfloat16's unit roundoff (half an ulp)
BF16_ROWS = 16384               # rows per chunk of a whole-batch comparison


def bf16_kernel_vs_plain(label, got, want):
    """The bfloat16 kernel's results against its plain version's, (B, n)
    bfloat16, in chunks of rows: each element within one bfloat16 ulp (of
    the larger of the two), or, on a row whose statistics cross zero,
    within 2^-8 of the row's largest |element|.  Returns max
    |difference|."""
    import torch
    ulps = crossing = worst = 0.0
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    for lo in range(0, got.shape[0], BF16_ROWS):
        g = got[lo:lo + BF16_ROWS].double()
        w = want[lo:lo + BF16_ROWS].double()
        d = (g - w).abs()
        worst = max(worst, float(d.max()))
        cross = (w > 0).any(1) & (w < 0).any(1)
        _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
        ulp = torch.ldexp(torch.ones_like(g), e - 8)
        if bool((~cross).any()):
            ulps = max(ulps, float((d[~cross] / ulp[~cross]).max()))
        if bool(cross.any()):
            allowed = torch.maximum(
                ulp[cross], BF16_U * w[cross].abs().amax(1, keepdim=True))
            crossing = max(crossing, float((d[cross] / allowed).max()))
    print(f"{label}: bf16 kernel vs plain over the whole batch: max "
          f"{ulps:.3g} ulp (<= 1) on rows that do not cross zero; on rows "
          f"that do, max {crossing:.3g} (<= 1) of max(1 ulp, 2^-8 of the "
          f"row's largest |element|); max abs {worst:.3e}")
    check(ulps <= 1.0, f"{label}: bf16 kernel vs plain {ulps} ulp")
    check(crossing <= 1.0, f"{label}: bf16 kernel vs plain {crossing}")
    return worst


def bf16_probe_errors(ngal, xi, host):
    """Max ngal relative and xi scaled errors of rows 0..N_PROBE-1 against
    ``host(i) -> (ngal, xi)`` in float64."""
    import numpy as np
    e_ng = e_xi = 0.0
    for i in range(N_PROBE):
        ng64, xi64 = host(i)
        x = xi[i].double().cpu().numpy().ravel()
        want = np.ravel(xi64)
        e_ng = max(e_ng, abs(float(ngal[i]) / float(ng64) - 1))
        e_xi = max(e_xi, float(np.max(np.abs(x - want)) /
                               np.max(np.abs(want))))
    return e_ng, e_xi


def bf16_cases(ctx):
    """(name, object, model, float32 parameters, rows outside the grid,
    batch) of path 12: (a) the three tables, (b) the 64-node grid, (c) the
    'efficient' Delta Sigma grid, (d) the wide grid."""
    torch, np = ctx["torch"], ctx["np"]
    from tabcorr_tpu_torch import (AssembiasZheng07Model, Interpolator,
                                   TabCorr, Zheng07Model)
    from tabcorr_tpu_torch.utils.synthetic import (grid64_interpolator,
                                                   wide_grid_interpolator)

    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    rng = np.random.default_rng(SEED + 40)
    cases = []
    for name, file in (("wp", "bolplanck_wp.npz"),
                       ("xi_ell", "synthetic_xi_ell.npz"),
                       ("ds", "bolplanck_ds.npz")):
        tab = TabCorr.read(data / file)
        model = Zheng07Model(threshold=-18, redshift=tab.attrs["redshift"])
        cases.append((name, tab, model, bench_params(model, rng, BATCH,
                                                     "cuda"), (), BATCH))

    def on_grid(model, batch, out_rows, keys):
        params = bench_params(model, rng, batch, "cuda")
        for key, lo, hi, outside in keys:
            v = rng.uniform(lo, hi, batch)
            v[0] = model.param_dict[key]
            if outside is not None:
                v[list(out_rows)] = outside
            params[key] = torch.tensor(v, dtype=torch.float32, device="cuda")
        return params

    grid_keys = (("alpha_c", 0.05, 0.35, 0.5), ("alpha_s", 0.85, 1.15, None),
                 ("log_eta", -0.3, 0.3, None))
    model = Zheng07Model(threshold=-20, redshift=0.0)
    model.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    cases.append(("grid64", grid64_interpolator(), model,
                  on_grid(model, BATCH, OUT_ROWS, grid_keys),
                  OUT_ROWS, BATCH))
    model = Zheng07Model(threshold=-21, redshift=0.5,
                         prim_haloprop_key="halo_m258m")
    model.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
    cases.append(("ds_efficient", Interpolator.read(data / "ds_efficient.npz"),
                  model, on_grid(model, BATCH, OUT_ROWS,
                                 (("log_eta", -0.45, 0.45, 0.6),)),
                  OUT_ROWS, BATCH))
    model = AssembiasZheng07Model(threshold=-20, redshift=0.0)
    model.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    cases.append(("wide grid", wide_grid_interpolator(), model,
                  on_grid(model, SLAB_BATCH, SLAB_OUT_ROWS, grid_keys),
                  SLAB_OUT_ROWS, SLAB_BATCH))
    return cases


def bf16_phase(ctx, kernels):
    torch, np, fused = ctx["torch"], ctx["np"], ctx["fused"]
    from tabcorr_tpu_torch import TabCorr, make_predictor
    from tabcorr_tpu_torch.predictor import stacked_grid

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    launches = 0
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flop=0.0,
                  n_bytes=0.0, err=0.0)
    wp_route = None
    for name, obj, model, params, out_rows, batch in bf16_cases(ctx):
        is_tab = isinstance(obj, TabCorr)
        predict = make_predictor(obj, model, engine="fused", dtype=bf16,
                                 device="cuda")
        # ---- path ------------------------------------------------------
        ctx["reset"]()
        t0 = time.perf_counter()
        ngal, xi = predict(params)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launched = ctx["expect"](f"bf16 {name}", contraction_bf16=1)
        launches += launched["contraction_bf16"]
        check(ngal.dtype == xi.dtype == bf16, f"bf16 {name}: output types")
        xi = xi.reshape(batch, -1)
        out = torch.zeros(batch, dtype=torch.bool, device="cuda")
        out[list(out_rows)] = True
        check(bool(torch.isnan(ngal[out]).all() and
                   torch.isnan(xi[out]).all()),
              f"bf16 {name}: out-of-grid rows are not all NaN")
        check(bool(torch.isfinite(ngal[~out]).all() and
                   torch.isfinite(xi[~out]).all()),
              f"bf16 {name}: NaN or inf in rows inside the grid")
        if name == "wp":
            wp_route = (obj, model, params, ngal, xi)
        print(f"bf16 {name}: make_predictor(engine='fused', "
              f"dtype=torch.bfloat16), {launched['contraction_bf16']} bf16 "
              f"contraction launch, xi {tuple(xi.shape)} bfloat16"
              + (f", rows {out_rows} outside the grid NaN (ngal too)"
                 if out_rows else "") + f"; first call {first_s:.3f} s")

        # ---- the kernel against its plain version, the same inputs -----
        table = (obj.table_data(dtype=bf16, device="cuda") if is_tab else
                 stacked_grid(obj, device="cuda", dtype=bf16)[0])
        c = fused.bf16_table_constants(table)
        dens = fused.bf16_densities(table, model, params)
        total_k, xi_k = fused.contraction_bf16_launch(c, dens)
        total_p, xi_p = fused.contraction_bf16_plain(c, dens)
        torch.cuda.synchronize()
        check(bool(torch.equal(total_k[~out], ngal[~out])),
              f"bf16 {name}: the route's ngal is not the kernel's total")
        err = max(bf16_kernel_vs_plain(f"bf16 {name} total", total_k[:, None],
                                       total_p[:, None]),
                  bf16_kernel_vs_plain(f"bf16 {name} xi", xi_k, xi_p))
        del xi_p, total_p

        # ---- the route and the plain bf16 engine against float64 -------
        p16 = {k: v.to(bf16) for k, v in params.items()}
        probe = {k: v[:N_PROBE] for k, v in p16.items()}
        plain = make_predictor(obj, model, engine="plain", dtype=bf16,
                               device="cuda")(probe)

        def host(i):
            return obj.predict(host_model(model, p16, i),
                               check_consistency=False)

        r_ng, r_xi = bf16_probe_errors(ngal, xi, host)
        p_ng, p_xi = bf16_probe_errors(plain[0], plain[1].reshape(
            N_PROBE, -1), host)
        roundings = 1 if is_tab else 2
        bar_ng = max(2 * p_ng, BF16_U) + BF16_U
        bar_xi = max(2 * p_xi, BF16_U) + roundings * BF16_U
        print(f"bf16 {name} vs float64 host at {N_PROBE} probes (the "
              f"bfloat16 parameters the kernel received): route ngal rel "
              f"{r_ng:.3e} (<= {bar_ng:.3e}), xi scaled {r_xi:.3e} (<= "
              f"{bar_xi:.3e}); plain bf16 engine ngal {p_ng:.3e}, xi "
              f"{p_xi:.3e} (bar: max(2 x plain, 2^-8) + 2^-8 for each "
              f"rounding of the results to bfloat16, {roundings} for xi)")
        check(r_ng <= bar_ng, f"bf16 {name}: ngal vs float64 {r_ng}")
        check(r_xi <= bar_xi, f"bf16 {name}: xi vs float64 {r_xi}")

        # ---- timing ----------------------------------------------------
        k_ms, p_ms, k_w, p_w = ctx["alternate"](
            lambda: fused.contraction_bf16_launch(c, dens),
            lambda: fused.contraction_bf16_plain(c, dens), 5, 1)
        dense = table.tpcf_dense
        lib_ms = ctx["library_ms"](
            (lambda: torch.einsum("bi,bj,kij->bk", dens, dens, dense))
            if c.auto else (lambda: torch.einsum("ki,bi->bk", dense, dens)))
        flop = batch * contraction_flop(c.n_bins, c.n_xi, c.auto)
        n_bytes = nbytes(dens, c.bt, total_k, xi_k)
        ops_ms = flop / PEAK_BF16_FLOPS * 1e3
        bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        kernel = ("contraction_bf16_stream_kernel" if c.streamed else
                  "contraction_bf16_kernel")
        hgmma = {k: v for k, v in ctx["bf16_wgmma"].items() if kernel in k
                 and f"ILi{c.cols if c.streamed else c.kp}ELb"
                 f"{int(c.auto)}E" in k}
        print(f"timing (bf16 {name}): bf16 contraction kernel {k_ms:.4f} ms "
              f"per {batch}-row batch (windows {k_w}); bound {bound_ms:.4f} "
              f"ms ({'operations' if ops_ms >= bytes_ms else 'bytes'}: "
              f"{flop:.4g} FLOP at 989 TFLOP/s BF16, {n_bytes:.4g} bytes at "
              f"3.35 TB/s), {bound_ms / k_ms:.1%} of it; plain PyTorch "
              f"{p_ms:.4f} ms (windows {p_w}); one bf16 torch.einsum("
              f"{'bi,bj,kij->bk' if c.auto else 'ki,bi->bk'}) {lib_ms:.4f} "
              f"ms, kernel / einsum {k_ms / lib_ms:.3f}; kp {c.kp}, "
              f"{c.cols}-column tiles, SASS {hgmma} on {ctx['card']}")
        check(len(hgmma) == 1 and all(hgmma.values()),
              f"bf16 {name}: its kernel's HGMMA count {hgmma}")
        totals["ms"] += k_ms
        totals["plain_ms"] += p_ms
        totals["library_ms"] += lib_ms
        totals["flop"] += flop
        totals["n_bytes"] += n_bytes
        totals["err"] = max(totals["err"], err)
        del dens, total_k, xi_k, ngal, xi
        torch.cuda.empty_cache()

    # ---- (e) engine='auto' in bfloat16 on the card: the same route ------
    tab, model, params, ngal, xi = wp_route
    ctx["reset"]()
    ngal_a, xi_a = make_predictor(tab, model, dtype=bf16,
                                  device="cuda")(params)
    torch.cuda.synchronize()
    launched = ctx["expect"]("bf16 auto", contraction_bf16=1)
    launches += launched["contraction_bf16"]
    check(bool(torch.equal(ngal_a, ngal) and
               torch.equal(xi_a.reshape(xi.shape), xi)),
          "bf16 auto: not the fused route's results")
    print("bf16 wp, engine='auto': 1 bf16 contraction launch, the fused "
          "route's results bit for bit")
    ops_ms = totals["flop"] / PEAK_BF16_FLOPS * 1e3
    bytes_ms = totals["n_bytes"] / PEAK_HBM_BYTES * 1e3
    record(kernels, "contraction_bf16", launches, max_abs_err=totals["err"],
           ms=totals["ms"], plain_ms=totals["plain_ms"],
           bound_ms=max(ops_ms, bytes_ms),
           bound_by="operations" if ops_ms >= bytes_ms else "bytes",
           library_ms=totals["library_ms"])
    print(f"path 12 (bfloat16): {time.perf_counter() - t_phase:.1f} s")


def examples_phase(ctx, kernels):
    """examples/torch_example_mcmc.py's ``run`` on the card (no plot): the
    bundle route, 256 walkers, 20 steps; then
    examples/torch_example_multichip.py's as a one-rank NCCL world."""
    torch = ctx["torch"]
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import torch_example_mcmc

    t0 = time.perf_counter()
    ctx["reset"]()
    results = torch_example_mcmc.run(device="cuda", n_steps=20, burn=10)
    torch.cuda.synchronize()
    launched = ctx["expect"]("mcmc example", bundle=1 + 2 * 20)
    record(kernels, "bundle", launched["bundle"])
    samples = results["samples"]
    check(results["route"] == "bundle", "mcmc example: not the bundle route")
    check(bool(ctx["np"].isfinite(samples).all()) and
          0.0 < results["accept"] <= 1.0,
          f"mcmc example: accept {results['accept']}")
    print(f"examples/torch_example_mcmc.py run(device='cuda', n_steps=20): "
          f"{launched['bundle']} bundle launches, acceptance "
          f"{results['accept']:.3f}, posterior means "
          f"{samples.mean(0).round(3).tolist()} (truth "
          f"{list(results['truth'].values())}), "
          f"{time.perf_counter() - t0:.2f} s")

    # The multi-GPU example as a one-rank NCCL world (a spawned process;
    # its launches are its own and come back in its results).
    import torch_example_multichip
    t0 = time.perf_counter()
    [rank] = torch_example_multichip.run(device="cuda", n_ranks=1,
                                         n_steps=20)
    check(rank["launches"] == 1 and rank["rows"] == len(rank["ngal"]) and
          ctx["np"].isfinite(rank["log_prob"]).all() and
          0.0 < rank["accept"] <= 1.0,
          f"multichip example: launches {rank['launches']}, accept "
          f"{rank['accept']}")
    record(kernels, "bundle", rank["launches"])
    print(f"examples/torch_example_multichip.py run(device='cuda', "
          f"n_ranks=1, n_steps=20): one NCCL rank, {rank['rows']} rows "
          f"through {rank['launches']} dp-sharded bundle launch, "
          f"{len(rank['walkers'])} walkers, acceptance "
          f"{rank['accept']:.3f}, {time.perf_counter() - t0:.2f} s with the "
          f"spawn")



# ----------------------------------------------------------------------
# Multi-GPU: one process a rank, the kernels under mesh=
# ----------------------------------------------------------------------
MG_TIMED = 3


def sweep_kwargs(sweep):
    """``labeled_pair_count``'s arguments (numpy, picklable) that make
    ``sweep`` again: its tracers, labels, float32 weights (already scaled
    to a largest magnitude of 1, so they pass unscaled), period, kind,
    radial edges (whose float32 squares are the sweep's), cut and
    channels."""
    import numpy as np

    def host(t):
        return None if t is None else t.cpu().numpy()

    return dict(pos1=host(sweep.pos1), labels1=host(sweep.labels1),
                n_labels_1=sweep.n_labels_1, pos2=host(sweep.pos2),
                labels2=host(sweep.labels2), n_labels_2=sweep.n_labels_2,
                weights2=host(sweep.weights2), period=sweep.period,
                kind=sweep.kind,
                r_edges=np.sqrt(sweep.edges_sq.astype(np.float64)),
                pi_max=sweep.pi_max if sweep.kind == "rppi" else None,
                mu_edges=(sweep.mu_edges.astype(np.float64)
                          if sweep.kind == "smu" else None),
                pair_weight=sweep.pair_weight)


def wall_ms(torch, fn, n=MG_TIMED):
    """Median host-clock ms of ``fn`` to a synchronized card (after one
    call not timed)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def leaves(x):
    """The tensors of nested tuples and lists, in order."""
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in leaves(y)]
    return [x]


def sweep_to(sweep, device):
    """``sweep`` with its tensors on ``device``."""
    return dataclasses.replace(sweep, **{
        f.name: getattr(sweep, f.name).to(device)
        for f in dataclasses.fields(sweep)
        if hasattr(getattr(sweep, f.name), "to")})


def multi_gpu_rank(world, sweeps, wp_sweep):
    """One rank of the multi-GPU phase (run by ``run_world`` in a spawned
    process).  World "a" (one NCCL rank, mesh (1, 1)): B1, B2 and B4
    (slab_tc) under ``mesh=`` at the main path's widths and the two
    tabulation sweeps through ``labeled_pair_count(mesh=)``.  World "b"
    (two gloo ranks on one card): ``make_sharded_predict`` with the wp
    table split over tp = 2, then mesh (2, 1): B1 on each rank's half of
    the batch and both sweeps in two shards.  Counters are zeroed just
    before the sharded calls and read just after; then each result is
    held against the unsharded call on the same rows and both are timed.
    ``wp_sweep``: the wp subsample's Sweep on the CPU, whose shard's
    kernel, plain version and bound rank 0 of world "b" measures.
    Returns the counts, the checks' numbers and the times."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import tabcorr_tpu_torch as tp
    from tabcorr_tpu_torch.ops import fused
    from tabcorr_tpu_torch.ops import paircount as pc
    from tabcorr_tpu_torch.parallel import make_mesh, make_sharded_predict
    from tabcorr_tpu_torch.parallel.mesh import batch_sharding
    from tabcorr_tpu_torch.utils.synthetic import (grid64_interpolator,
                                                   wide_grid_interpolator)

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, size = dist.get_rank(), dist.get_world_size()
    data = Path(__file__).resolve().parent / "tabcorr_tpu_torch" / "data"
    wp_tab = tp.TabCorr.read(data / "bolplanck_wp.npz")
    xi_tab = tp.TabCorr.read(data / "synthetic_xi_ell.npz")
    model = tp.Zheng07Model(threshold=-18,
                            redshift=wp_tab.attrs["redshift"])
    rng = np.random.default_rng(SEED + 300)
    params = bench_params(model, rng, BATCH, "cuda")
    accuracy = ("elementwise", "scaled")
    cases = {}     # name -> (sharded call, unsharded call, rows, kind)
    if world == "a":
        mesh = make_mesh(1)
        cases["bundle"] = [tp.make_multi_predictor(
            [wp_tab, xi_tab], model, device="cuda", accuracy=accuracy,
            mesh=mesh), tp.make_multi_predictor(
                [wp_tab, xi_tab], model, device="cuda", accuracy=accuracy),
            params, "exact"]
        for name, make_interp, kind, batch in (
                ("grid", grid64_interpolator, tp.Zheng07Model, BATCH),
                ("slab_tc", wide_grid_interpolator,
                 tp.AssembiasZheng07Model, SLAB_BATCH)):
            interp = make_interp()
            m = kind(threshold=-20, redshift=0.0)
            m.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
            p = bench_params(m, rng, batch, "cuda")
            for key, lo, hi in (("alpha_c", 0.05, 0.35),
                                ("alpha_s", 0.85, 1.15),
                                ("log_eta", -0.3, 0.3)):
                p[key] = torch.tensor(rng.uniform(lo, hi, batch),
                                      dtype=torch.float32, device="cuda")
            cases[name] = [tp.make_predictor(
                interp, m, engine="fused", accuracy="scaled", device="cuda",
                mesh=mesh), tp.make_predictor(
                    interp, m, engine="fused", accuracy="scaled",
                    device="cuda"), p, "exact"]
    else:
        mesh_tp = make_mesh(2, table_parallel=2)
        table = wp_tab.table_data(dtype=torch.float32, device="cuda")
        cases["tp predict"] = [
            make_sharded_predict(mesh_tp, table, model)[0],
            tp.make_predictor(wp_tab, model, engine="plain", device="cuda"),
            params, "dryrun"]
        mesh = make_mesh(2)
        cases["bundle"] = [tp.make_multi_predictor(
            [wp_tab, xi_tab], model, device="cuda", accuracy=accuracy,
            mesh=mesh), tp.make_multi_predictor(
                [wp_tab, xi_tab], model, device="cuda", accuracy=accuracy),
            params, "exact"]
    for name, kw in sweeps.items():
        cases[f"paircount {name}"] = [
            (lambda kw=kw: pc.labeled_pair_count(**kw, mesh=mesh,
                                                 device="cuda")),
            (lambda kw=kw: pc.labeled_pair_count(**kw, device="cuda")),
            None, "sweep"]

    # ---- the path: every sharded call once, counted -----------------------
    for attr in ("BUNDLE_LAUNCHES", "GRID_LAUNCHES", "SLAB_TC_LAUNCHES"):
        setattr(fused, attr, 0)
    pc.PAIRCOUNT_LAUNCHES = 0
    got = {name: (c[0](c[2]) if c[2] is not None else c[0]())
           for name, c in cases.items()}
    torch.cuda.synchronize()
    counts = {"bundle": fused.BUNDLE_LAUNCHES, "grid": fused.GRID_LAUNCHES,
              "slab_tc": fused.SLAB_TC_LAUNCHES,
              "paircount_sharded": pc.PAIRCOUNT_LAUNCHES}

    # ---- against the unsharded call on the same rows ----------------------
    out = {"rank": rank, "size": size, "counts": counts, "cases": {}}
    for name, (sharded, unsharded, p, kind) in cases.items():
        want = unsharded(p) if p is not None else unsharded()
        if p is not None:
            rows = batch_sharding(mesh if name != "tp predict" else mesh_tp,
                                  len(next(iter(p.values()))))
            pairs = list(zip(*[(g, w[rows]) for g, w in zip(
                leaves(got[name]), leaves(want))]))
        else:
            pairs = [(torch.as_tensor(got[name]),), (torch.as_tensor(want),)]
        errs = [float((a.double() - b.double()).abs().max())
                for a, b in zip(*pairs)]
        if kind == "exact":
            ok = all(torch.equal(a, b) for a, b in zip(*pairs))
            bar = "bit for bit (the same kernel on the same rows)"
        elif kind == "dryrun":
            ok = all(bool(torch.allclose(
                a.double(), b.double(), rtol=tol,
                atol=atol * float(b.double().abs().max())))
                for (a, b), (tol, atol) in zip(zip(*pairs),
                                               ((1e-5, 0.0), (1e-4, 1e-6))))
            bar = ("ngal 1e-5, xi 1e-4 + 1e-6 max|xi| (tabcorr_tpu's "
                   "dry run: float32 sums split over the shards)")
        else:
            a, b = pairs[0][0], pairs[1][0]
            unit = sweeps[name.split()[1]]["weights2"] is None and \
                sweeps[name.split()[1]]["pair_weight"] == "unit"
            ok = (torch.equal(a, b) if unit else bool(torch.allclose(
                a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))))
            bar = ("unit counts equal" if unit else
                   "1e-12 of the largest cell (float64 sums in another "
                   "order)")
        check(ok, f"multi-GPU world {world} rank {rank}: {name} differs "
                  f"from the unsharded call ({errs})")
        sharded_ms = wall_ms(torch, (lambda s=sharded, p=p: s(p)) if p
                             is not None else sharded)
        unsharded_ms = wall_ms(torch, (lambda u=unsharded, p=p: u(p)) if p
                               is not None else unsharded)
        out["cases"][name] = dict(max_abs_err=max(errs), bar=bar,
                                  sharded_ms=sharded_ms,
                                  unsharded_ms=unsharded_ms)

    # ---- the sharded pair counter on this rank's shard (world b) ----------
    if world == "b":
        sweep = pc.shard_sweep(sweep_to(wp_sweep, "cuda"), mesh)
        layout = pc.bucket_layout(sweep)
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        times = []
        for _ in range(MG_TIMED):
            hist = pc.paircount_launch(sweep, layout, events=events)
            torch.cuda.synchronize()
            times.append(events[0].elapsed_time(events[1]))
        t0 = time.perf_counter()
        plain = pc.paircount_plain(sweep)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(hist, plain), "sharded paircount vs plain")
        b, _, _ = paircount_bounds(sweep, valid_pairs(sweep, hist))
        out["shard"] = dict(
            ms=sorted(times)[len(times) // 2], plain_ms=plain_ms,
            max_abs_err=float((hist.double() - plain.double()).abs().max()),
            j_range=sweep.j_range, **b)
    return out


def multi_gpu_phase(ctx, kernels):
    """Multi-GPU through ``tabcorr_tpu_torch.parallel``: (a) a one-rank
    NCCL world, the production backend, runs B1 (wp + xi_ell, 262,144
    rows), B2 (grid64, 262,144 rows) and B4's slab_tc (the wide grid,
    32,768 rows) under ``mesh=`` and ``labeled_pair_count(mesh=)`` on the
    tabulation phase's 65,536-tracer wp and Delta Sigma subsamples; (b) a
    two-rank gloo world on the same card (NCCL refuses two ranks on one
    device): ``make_sharded_predict`` with the wp table over tp = 2, B1
    on each rank's half of the batch, and both sweeps in two shards, the
    collectives through the host.  Each rank holds every result against
    the unsharded call on the same rows (``multi_gpu_rank``) and returns
    its launch counts, which must be above 0."""
    torch = ctx["torch"]
    from tabcorr_tpu_torch.parallel.mesh import run_world

    t_phase = time.perf_counter()
    sweeps = {label: sweep_kwargs(ctx["subsamples"][label])
              for label in ("wp", "ds")}
    wp_sweep = sweep_to(ctx["subsamples"]["wp"], "cpu")
    torch.cuda.empty_cache()
    results = {}
    for world, size, backend in (("a", 1, "nccl"), ("b", 2, "gloo")):
        t0 = time.perf_counter()
        results[world] = run_world(multi_gpu_rank, size, backend, "cuda",
                                   args=(world, sweeps, wp_sweep))
        print(f"multi-GPU world {world}: {size} {backend} rank(s) on "
              f"{ctx['card']}, {time.perf_counter() - t0:.1f} s with the "
              f"spawn")
    expected = {"a": ("bundle", "grid", "slab_tc", "paircount_sharded"),
                "b": ("bundle", "paircount_sharded")}
    totals = {}
    for world, ranks in results.items():
        for r in ranks:
            for name in expected[world]:
                check(r["counts"][name] > 0, f"multi-GPU world {world} "
                      f"rank {r['rank']}: {name} never launched")
            for name, n in r["counts"].items():
                totals[name] = totals.get(name, 0) + n
            for name, c in r["cases"].items():
                print(f"multi-GPU world {world} rank {r['rank']}/{r['size']}"
                      f": {name}: sharded {c['sharded_ms']:.3f} ms, "
                      f"unsharded {c['unsharded_ms']:.3f} ms (host clock, "
                      f"synchronized, median of {MG_TIMED}); max |diff| "
                      f"{c['max_abs_err']:.3e}, held {c['bar']}")
        print(f"multi-GPU world {world}: launches " + ", ".join(
            f"rank {r['rank']} {r['counts']}" for r in ranks))
    for name in ("bundle", "grid", "slab_tc"):
        record(kernels, name, totals[name])
    shard = results["b"][0]["shard"]
    print(f"multi-GPU: paircount on rank 0's shard of the wp sweep (j "
          f"{shard['j_range']}): kernel {shard['ms']:.3f} ms (CUDA events), "
          f"plain {shard['plain_ms']:.1f} ms, kept-pair bound "
          f"{shard['bound_ms']:.3f} ms ({shard['bound_by']}), equal to the "
          f"plain version on {ctx['card']}")
    record(kernels, "paircount_sharded", totals["paircount_sharded"],
           ms=shard["ms"], plain_ms=shard["plain_ms"],
           max_abs_err=max(r["cases"][f"paircount {label}"]["max_abs_err"]
                           for ranks in results.values() for r in ranks
                           for label in ("wp", "ds")),
           bound_ms=shard["bound_ms"], bound_by=shard["bound_by"],
           library_ms=None)
    print(f"multi-GPU phase: {time.perf_counter() - t_phase:.1f} s")

if __name__ == "__main__":
    sys.exit(main())
