"""Time variants of the bfloat16 contraction (``csrc/bf16.cu``) in turns.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/torch_bf16_probe.py [--rounds 3]

Each variant is this tree's ``bf16.cu`` with source patches (anchor texts
that must match: keep them in step with bf16.cu), built side by side with
nvcc under ``build/bf16_probe/`` and launched through
``fused.contraction_bf16_launch`` with its library bound, on chip_smoke.py's
path 12 inputs (``bf16_cases``: the bf16 route's densities of wp, xi_ell,
Delta Sigma, the 64-node grid, ds 'efficient' and the wide grid).

* ``serial_fold``: the registers kernel waits for the job it is about to
  fold and for the next one (``wgmma.wait_group 0``), so the fold no longer
  overlaps the next job's MMAs.
* ``four_warpgroups``: auto tables of 64 bins or fewer run four consumer
  warpgroups of 64 rows (112 registers a thread: a 640-thread block starts
  at 96, and setmaxnreg can only share out those) in place of two of 128,
  with tiles of one statistic (N = 64): 16 warps an SM to hide the fold.

Each variant is checked against the plain version (1 bfloat16 ulp, as
chip_smoke), then timed against this tree's kernel in CUDA-event windows
of 5 launches (this tree, variant, variant, this tree, for ``--rounds``
rounds); medians are printed beside the card's name and power limit.
"""

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tabcorr_tpu_torch import TabCorr  # noqa: E402
from tabcorr_tpu_torch.ops import fused  # noqa: E402
from tabcorr_tpu_torch.predictor import stacked_grid  # noqa: E402
from tabcorr_tpu_torch.utils import build  # noqa: E402

CSRC = ROOT / "tabcorr_tpu_torch" / "csrc"
OUT = ROOT / "build" / "bf16_probe"
GEOMETRY = fused.bf16_geometry


def _tiles_of_one_statistic(auto, n_bins, n_xi):
    """bf16_geometry with tiles of 64 / kp statistics up to 64 bins."""
    if auto and n_bins <= 64:
        kp = -(-n_bins // 32) * 32
        per = 64 // kp
        return kp, per * kp, -(-n_xi // per)
    return GEOMETRY(auto, n_bins, n_xi)


# name -> (source patches (old, new), the geometry the wrapper checks)
VARIANTS = {
    "serial_fold": ([(
        """            hopper::wgmma_wait<1>();
          } else {
            hopper::wgmma_wait<0>();
          }""",
        """            hopper::wgmma_wait<0>();
          } else {
            hopper::wgmma_wait<0>();
          }""")], None),
    "four_warpgroups": ([
        ("""__device__ __forceinline__ void init_barriers(const Layout& l, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(l.full + 8 * s, 1);
      hopper::mbar_init(l.empty + 8 * s, kConsumers * 4);""",
         """__device__ __forceinline__ void init_barriers(const Layout& l, int stages,
                                              int consumers = kConsumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(l.full + 8 * s, 1);
      hopper::mbar_init(l.empty + 8 * s, consumers * 4);"""),
        ("""  static constexpr int S = !AUTO ? 64 : H == 2 ? 1 : (KP <= 64 ? 128 / KP
                                                                : 1);""",
         """  static constexpr int S = !AUTO ? 64 : H == 2 ? 1 : (KP <= 64 ? 64 / KP
                                                               : 1);"""),
        ("""  static constexpr int MT = 2;                             // m64 tiles""",
         """  static constexpr int WGS = AUTO && KP <= 64 ? 4 : 2;
  static constexpr int MT = 4 / WGS;
  static constexpr int REGS = WGS == 4 ? 112 : 240;"""),
        ("""  constexpr int U = H * MT;       // jobs of one unrolled round: 2 or 4""",
         """  constexpr int U = H * MT > 1 ? H * MT : 2;"""),
        ("""    const int row_base = rt * (kConsumers * C::ROWS) + wg * C::ROWS;""",
         """    const int row_base = rt * (C::WGS * C::ROWS) + wg * C::ROWS;"""),
        ("""      const int r = next * (kConsumers * C::ROWS) + wg * C::ROWS + tid;""",
         """      const int r = next * (C::WGS * C::ROWS) + wg * C::ROWS + tid;"""),
        ("""__global__ void __launch_bounds__(128 * (kConsumers + 1), 1)
    contraction_bf16_kernel(const Args args) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout l = layout(smem, args.stages, Cfg<KP, AUTO>::SLOT);
  init_barriers(l, args.stages);""",
         """__global__ void __launch_bounds__(128 * (Cfg<KP, AUTO>::WGS + 1), 1)
    contraction_bf16_kernel(const Args args) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout l = layout(smem, args.stages, Cfg<KP, AUTO>::SLOT);
  init_barriers(l, args.stages, Cfg<KP, AUTO>::WGS);"""),
        ("""    hopper::regs_inc<kConsumerRegs>();
    consume<KP, AUTO>(args, l, wg - 1);""",
         """    hopper::regs_inc<Cfg<KP, AUTO>::REGS>();
    consume<KP, AUTO>(args, l, wg - 1);"""),
        ("""  const size_t smem = smem_bytes(a.stages, C::SLOT, C::ROWS, a.win);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = reg::contraction_bf16_kernel<KP, AUTO>;
  const int threads = 128 * (kConsumers + 1);
  a.row_tiles = (a.batch + kConsumers * C::ROWS - 1) / (kConsumers * C::ROWS);""",
         """  const size_t smem = smem_bytes(a.stages, C::SLOT,
                                 C::ROWS * C::WGS / 2, a.win);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = reg::contraction_bf16_kernel<KP, AUTO>;
  const int threads = 128 * (C::WGS + 1);
  a.row_tiles = (a.batch + C::WGS * C::ROWS - 1) / (C::WGS * C::ROWS);""")],
        _tiles_of_one_statistic),
}


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build_variants():
    """{name: library path}: every variant patched and built at once."""
    procs = {}
    for name, (patches, _) in VARIANTS.items():
        src = (CSRC / "bf16.cu").read_text()
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: anchor not found once:\n{old}")
            src = src.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "bf16.cu").write_text(src)
        shutil.copy(CSRC / "hopper.cuh", d / "hopper.cuh")
        lib = d / "libbf16.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(d / "bf16.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        serial = [line for line in log.splitlines()
                  if "wgmma.mma_async instructions are serialized" in line]
        print(f"{name}: built; ptxas reports {len(serial)} serialized "
              f"wgmma kernels", flush=True)
        libs[name] = lib
    return libs


def bind(path):
    load = fused.load_library
    fused.load_library = lambda *_: ctypes.CDLL(str(path))
    try:
        return fused._bf16_lib.__wrapped__()
    finally:
        fused.load_library = load


def launcher(c, dens, lib, geometry):
    """A call of the wrapper on ``c`` with library ``lib`` bound and the
    layout check against ``geometry``."""
    def run():
        cached, geom = fused._bf16_lib, fused.bf16_geometry
        fused._bf16_lib, fused.bf16_geometry = (lambda: lib), geometry
        try:
            return fused.contraction_bf16_launch(c, dens)
        finally:
            fused._bf16_lib, fused.bf16_geometry = cached, geom
    return run


def window_ms(fn, n_iter):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch finds no CUDA device.", file=sys.stderr)
        return 1
    name = card()
    print(f"card (name, power limit): {name}", flush=True)
    fused.load_kernels()
    here = fused._bf16_lib()
    variants = {v: bind(p) for v, p in build_variants().items()}
    # A variant's layout check and constants use its own geometry.
    bf16 = torch.bfloat16
    for label, obj, model, params, _, _ in cs.bf16_cases(
            {"torch": torch, "np": np}):
        table = (obj.table_data(dtype=bf16, device="cuda")
                 if isinstance(obj, TabCorr) else
                 stacked_grid(obj, device="cuda", dtype=bf16)[0])
        dens = fused.bf16_densities(table, model, params)
        c = fused.bf16_table_constants(table)
        total_p, xi_p = fused.contraction_bf16_plain(c, dens)
        tree = launcher(c, dens, here, GEOMETRY)
        for v, lib in variants.items():
            geometry = VARIANTS[v][1] or GEOMETRY
            cv = c
            if geometry is not GEOMETRY:
                fused.bf16_geometry = geometry
                try:
                    cv = fused.bf16_table_constants(table)
                finally:
                    fused.bf16_geometry = GEOMETRY
            run = launcher(cv, dens, lib, geometry)
            total, xi = run()
            torch.cuda.synchronize()
            cs.bf16_kernel_vs_plain(f"{v} {label} total", total[:, None],
                                    total_p[:, None])
            cs.bf16_kernel_vs_plain(f"{v} {label} xi", xi, xi_p)
            del total, xi
            times = {"tree": [], "variant": []}
            for _ in range(args.rounds):
                for which in ("tree", "variant", "variant", "tree"):
                    times[which].append(window_ms(
                        tree if which == "tree" else run, 5))
            med = {k: float(np.median(t)) for k, t in times.items()}
            print(f"{label}: this tree {med['tree']:.4f} ms, {v} "
                  f"{med['variant']:.4f} ms (ratio "
                  f"{med['variant'] / med['tree']:.4f}; windows "
                  f"{[round(t, 4) for t in times['tree']]} / "
                  f"{[round(t, 4) for t in times['variant']]}) on {name}",
                  flush=True)
        del dens, total_p, xi_p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
