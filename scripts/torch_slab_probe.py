"""Read the 'scaled' slab kernel (slab_tc) on one card at the wide grid.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/torch_slab_probe.py [--parent DIR] [--rounds 3]

The workload is chip_smoke.py's wide grid: 64 nodes of 160 bins and 42
rows, 32,768 parameter vectors of the decorated zheng07 model (model code
1).  One call builds every variant below at once (one nvcc each, all
started together, into build/slab_probe/), then times each by CUDA events
(the median of ``--rounds`` windows of 3 launches), and prints the card's
name and power limit beside every number.

* ``--parent DIR``: a checkout of an earlier tree whose slab.cu runs
  slab_tc on mma.sync (contract.cuh's contract_tc; e.g. ``git archive
  <commit> | tar -x -C build/parent``).  Its kernel is built as it is and
  with three ablations patched into its source: no epilogue (no reduction
  of a column tile's sums and no node output), no split of B (each B
  fragment's float32 bits used as hi and lo), and B from a resident tile
  (the cp.async ring filled once, never refilled).  Each is timed against
  the wgmma kernel in turns (parent, change, change, parent).
* The wgmma kernel of this tree: its default block (slab_tc_config) and
  other ring depths and warpgroup counts (runtime arguments); patched
  into its source: clusters of 2 blocks along the batch, each block's
  producer copying half of every stage and multicasting it to both (TMA
  multicast; a slot refilled once the consumers of both blocks released
  it), 64 columns per wgmma (two instructions a product), chunks of 2 or
  8 k-steps, the second consumer warpgroup starting 2 stages behind the
  first (a start barrier), and four ablations: one product per k-step
  (hi*hi only), no epilogue (no fold of a chunk into the epilogue's sums,
  no reduction, no output), B from a resident ring (the producer fills
  each slot once), A constant (no density loads or splits); a wait for
  the k-step two back (up to three MMA groups of a warpgroup in flight)
  instead of one back; the two small products summed over the whole
  column tile in their accumulator, folded once at its end (the hi*hi one
  still chunked).
  Every variant that computes the function is held against the plain
  version (ngal relative, per-node xi scaled; the contract is 1e-6).

For the parent's and this tree's default library it prints ptxas'
registers and spills per slab_tc instantiation and the SASS instruction
mix of one (tensor-core instructions, shared-memory loads, FP32, integer,
barrier operations; the whole function and the span from its first to
its last HMMA / HGMMA), and writes that function's SASS to
build/slab_probe/<library>.sass.  A JSON summary goes to
build/slab_probe/slab_probe.json.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tabcorr_tpu_torch import (AssembiasZheng07Model,  # noqa: E402
                               occupation_functions, params_batch)
from tabcorr_tpu_torch.ops import fused  # noqa: E402
from tabcorr_tpu_torch.predictor import stacked_grid  # noqa: E402
from tabcorr_tpu_torch.utils import build  # noqa: E402
from tabcorr_tpu_torch.utils.synthetic import (  # noqa: E402
    wide_grid_interpolator)

OUT = ROOT / "build" / "slab_probe"
BATCH = 32768
SEED = 13

# Source patches: (file, text, replacement); each text must occur once.
HOPPER_END = "}  // namespace hopper\n"
# hopper.cuh primitives that only the patched variants use.
CLUSTER_PRIMITIVES = r'''
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return rank;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n\t"
      "barrier.cluster.wait.aligned;" ::
          : "memory");
}

// The copy into every block of the cluster in `mask`, at the same
// shared-memory offsets; the bytes complete on each block's `bar`.
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// Arrive on the barrier at this offset in block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}" ::"r"(bar),
      "r"(rank)
      : "memory");
}

'''
WGMMA_N64 = r'''
// d (+)= a b on one m64n64k8 tile (TF32, A from registers).
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

'''
PARENT_PATCHES = {
    "no epilogue": [(
        "contract.cuh",
        "    cons.advance(h.ct_steps, h.n_ct, kTcStageSteps);\n"
        "    if (!tile_done) continue;\n",
        "    cons.advance(h.ct_steps, h.n_ct, kTcStageSteps);\n"
        "    if (!tile_done || node >= 0) continue;\n")],
    "no B split": [(
        "tf32x3.cuh",
        "    split_tf32(b_row0[ni * 8], bh[0], bl[0]);\n"
        "    split_tf32(b_row1[ni * 8], bh[1], bl[1]);\n",
        "    bh[0] = bl[0] = __float_as_uint(b_row0[ni * 8]);\n"
        "    bh[1] = bl[1] = __float_as_uint(b_row1[ni * 8]);\n")],
    "resident B": [(
        "contract.cuh",
        "    if (issued < n_stages) {\n      const int n_rows =\n"
        "          8 * min(kTcStageSteps,",
        "    if (issued < min(n_stages, NST)) {\n      const int n_rows =\n"
        "          8 * min(kTcStageSteps,")],
}
CHANGE_PATCHES = {
    "one product": [(
        "slab.cu",
        "            mma(acc_lo, al, dh, ks > 0);\n"
        "            mma(acc_lo, ah, dl, 1);\n", "")],
    "no epilogue": [(
        "slab.cu",
        "        if constexpr (AUTO) {\n#pragma unroll\n"
        "          for (int j = 0; j < 16; ++j) {\n",
        "        if constexpr (AUTO) {\n"
        "          if (acc[0] + acc[63] + acc_lo[0] + acc_lo[63] == 1e-30f)\n"
        "            sXi[0] = 0.f;   // keeps the MMAs' results live\n"
        "#pragma unroll\n"
        "          for (int j = 0; j < 16 * (ct < 0); ++j) {\n"), (
        "slab.cu",
        "        for (int j = 0; j < 16; j += 2) {\n",
        "        for (int j = 0; j < 16 * (ct < 0); j += 2) {\n"), (
        "slab.cu", "    if constexpr (!AUTO) continue;\n",
        "    continue;\n")],
    "resident B": [(
        "slab.cu", "  for (int s = 0; s < n_stages; ++s) {\n"
        "    hopper::mbar_wait(empty + 8 * slot, phase ^ 1);\n",
        "  for (int s = 0; s < min(n_stages, a.stages); ++s) {\n"
        "    hopper::mbar_wait(empty + 8 * slot, phase ^ 1);\n"), (
        "slab.cu", "  for (int s = 0; s < min(a.stages, n_stages); ++s) {\n",
        "  for (int s = 0; s < 0; ++s) {\n"), (
        "slab.cu", "            hopper::mbar_wait(full + 8 * slot, phase);\n",
        "            hopper::mbar_wait(full + 8 * slot, 0);\n")],
    "two groups in flight": [(
        "slab.cu",
        "            if (ks > 0) {\n              hopper::wgmma_wait<1>();\n"
        "              release(prev);\n            }\n",
        "            if (ks > 1) {\n              hopper::wgmma_wait<2>();\n"
        "              release((slot + a.stages - 2) % a.stages);\n"
        "            }\n"), (
        "slab.cu", "        release(prev);\n",
        "        if (n > 1) release((prev + a.stages - 1) % a.stages);\n"
        "        release(prev);\n")],
    "small products over the tile": [(
        "slab.cu", "            mma(acc_lo, al, dh, ks > 0);\n",
        "            mma(acc_lo, al, dh, q0 > 0 || ks > 0);\n"), (
        "slab.cu",
        "              const float c0 = acc[4 * j + 2 * h] + acc_lo[4 * j + 2 * h];\n"
        "              const float c1 =\n"
        "                  acc[4 * j + 2 * h + 1] + acc_lo[4 * j + 2 * h + 1];\n",
        "              const float c0 = acc[4 * j + 2 * h];\n"
        "              const float c1 = acc[4 * j + 2 * h + 1];\n"), (
        "slab.cu",
        "      } else {\n"
        "        // The quad's shares of the n8 tiles j and j + 1, rows r0 and r1,\n",
        "      } else {\n"
        "#pragma unroll\n"
        "        for (int j = 0; j < 16; ++j) {\n"
        "          const int i0 = __shfl_sync(0xffffffffu, col, j);\n"
        "          if (i0 != n_i0) {\n"
        "            load_densities<TB>(sN, i0 + 2 * t, r0, r1, nc);\n"
        "            n_i0 = i0;\n"
        "          }\n"
        "#pragma unroll\n"
        "          for (int h = 0; h < 2; ++h)\n"
        "            vp[2 * j + h] = fmaf(nc[2 * h + 1], acc_lo[4 * j + 2 * h + 1],\n"
        "                fmaf(nc[2 * h], acc_lo[4 * j + 2 * h], vp[2 * j + h]));\n"
        "        }\n"
        "        // The quad's shares of the n8 tiles j and j + 1, rows r0 and r1,\n")],
    "A constant": [(
        "slab.cu",
        "            tc::split_tf32(a_k[a0], ah[0], al[0]);\n"
        "            tc::split_tf32(a_k[a1], ah[1], al[1]);\n"
        "            tc::split_tf32(a_k[a0 + 4 * TB], ah[2], al[2]);\n"
        "            tc::split_tf32(a_k[a1 + 4 * TB], ah[3], al[3]);\n",
        "            ah[0] = ah[1] = ah[2] = ah[3] = 0x3c000000u;\n"
        "            al[0] = al[1] = al[2] = al[3] = 0u;\n")],
}
# Design decisions of the wgmma kernel, patched the same way.
CHANGE_PATCHES.update({
    "cluster of 2": [
        ("hopper.cuh", HOPPER_END, CLUSTER_PRIMITIVES + HOPPER_END),
        ("slab.cu",
         "    hopper::bulk_load(ring + slot * kStageBytes,\n"
         "                      a.b + (size_t)s * kStageFloats, kStageBytes,\n"
         "                      full + 8 * slot);\n",
         "    const uint32_t rank = hopper::cluster_rank();\n"
         "    hopper::bulk_load_multicast(\n"
         "        ring + slot * kStageBytes + rank * (kStageBytes / 2),\n"
         "        a.b + (size_t)s * kStageFloats + rank * (kStageFloats / 2),\n"
         "        kStageBytes / 2, full + 8 * slot, 3);\n"),
        ("slab.cu",
         "    if (lane == 0) hopper::mbar_arrive(empty + 8 * slot);\n",
         "    if (lane == 0) {\n"
         "      hopper::mbar_arrive_cluster(empty + 8 * slot, 0);\n"
         "      hopper::mbar_arrive_cluster(empty + 8 * slot, 1);\n"
         "    }\n"),
        ("slab.cu", "hopper::mbar_init(empty + 8 * s, WGS * 4);",
         "hopper::mbar_init(empty + 8 * s, 2 * WGS * 4);"),
        ("slab.cu", "    hopper::fence_barrier_init();\n  }\n  __syncthreads();\n",
         "    hopper::fence_barrier_init();\n  }\n  hopper::cluster_sync();\n"),
        ("slab.cu", "  const int blocks = (args.batch + tb - 1) / tb;\n",
         "  const int blocks = ((args.batch + tb - 1) / tb + 1) / 2 * 2;\n"),
        ("slab.cu", "  attr[0].val.clusterDim.x = 1;\n",
         "  attr[0].val.clusterDim.x = 2;\n")],
    "second warpgroup 2 stages behind": [
        ("slab.cu", "  return (size_t)stages * (kStageBytes + 16) +\n",
         "  return (size_t)stages * (kStageBytes + 16) + 16 +\n"),
        ("slab.cu", "reinterpret_cast<float*>(bars + 2 * n_slots);",
         "reinterpret_cast<float*>(bars + 2 * n_slots + 2);"),
        ("slab.cu",
         "      hopper::mbar_init(empty + 8 * s, WGS * 4);\n    }\n",
         "      hopper::mbar_init(empty + 8 * s, WGS * 4);\n    }\n"
         "    hopper::mbar_init(empty + 8 * n_slots, 1);\n"),
        ("slab.cu",
         "  auto release = [&](int slot) {\n"
         "    if (lane == 0) hopper::mbar_arrive(empty + 8 * slot);\n"
         "  };\n",
         "  const uint32_t go = empty + 8 * a.stages;\n"
         "  const int lag = min(min(2, a.stages - 1),\n"
         "                      a.n_nodes * a.node_steps - 1);\n"
         "  if (TB > 64 && lag > 0 && wg == 1) hopper::mbar_wait(go, 0);\n"
         "  int consumed = 0;\n"
         "  auto release = [&](int slot) {\n"
         "    if (lane == 0) hopper::mbar_arrive(empty + 8 * slot);\n"
         "    if (TB > 64 && ++consumed == lag && wg == 0 &&\n"
         "        threadIdx.x == 128)\n"
         "      hopper::mbar_arrive(go);\n"
         "  };\n")],
    "64 columns per wgmma": [
        ("hopper.cuh", HOPPER_END, WGMMA_N64 + HOPPER_END), (
        "slab.cu", "  hopper::wgmma_tf32_n128(d, a, desc, scale_d);\n",
        "  hopper::wgmma_tf32_n64(*reinterpret_cast<float(*)[32]>(d), a, desc,\n"
        "                         scale_d);\n"
        "  hopper::wgmma_tf32_n64(*reinterpret_cast<float(*)[32]>(d + 32), a,\n"
        "                         desc + (2048 >> 4), scale_d);\n")],
    **{f"chunks of {n} k-steps": [(
        "slab.cu", "constexpr int kChunkSteps = 4;\n",
        f"constexpr int kChunkSteps = {n};\n")] for n in (2, 8)},
})
ABLATIONS = ("one product", "no epilogue", "resident B", "A constant")


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def patched_copy(src, name, patches):
    """csrc/ of ``src`` copied to build/slab_probe/<name>/ with
    ``patches`` applied."""
    dst = OUT / re.sub(r"\W+", "_", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for file, text, new in patches:
        path = dst / file
        body = path.read_text()
        if body.count(text) != 1:
            raise RuntimeError(f"{name}: patch anchor not found once in "
                               f"{file}: {text!r}")
        path.write_text(body.replace(text, new))
    return dst


def build_all(jobs):
    """Build every (name -> (csrc dir, extra flags)) slab.cu at once."""
    procs = {}
    for name, (csrc, flags) in jobs.items():
        lib = OUT / f"lib_{re.sub(r'\W+', '_', name)}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
               str(csrc / "slab.cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib.with_suffix(".log").write_text(log)
        libs[name] = lib
    return libs


def ptxas_report(lib):
    """(entry, registers, spill stores, spill loads) of each slab_tc
    instantiation in the library's ptxas log."""
    rows, entry, spill = [], None, (0, 0)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif entry and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            spill = (int(m[1]), int(m[2]))
        elif entry and "Used" in line and "registers" in line:
            if "slab_tc" in entry:
                regs = int(re.search(r"Used (\d+) registers", line)[1])
                rows.append((entry, regs, *spill))
            entry = None
    return rows


SASS_CLASSES = {
    "tensor (HMMA/HGMMA)": r"\b(HMMA|HGMMA)\.",
    "shared loads": r"\b(LDS|LDSM)\b",
    "FP32": r"\b(FADD|FFMA|FMUL|FMNMX|FSETP)\b",
    "integer": r"\b(IADD3|IMAD|LOP3|SHF|LEA|ISETP|IMNMX|VIADD|SEL)\b",
    "barriers": r"\b(BAR|SYNCS|WARPGROUP|DEPBAR)\b",
    "local memory": r"\b(LDL|STL)\b",
}


def sass_mix(lib, pattern):
    """Instruction counts by class of the first function of ``lib`` whose
    name matches ``pattern``: the whole function and the span between its
    first and last tensor-core instruction."""
    text = subprocess.run(
        [str(Path(build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s+Function : ", text)[1:]:
        name = func.split("\n", 1)[0].strip()
        if not re.search(pattern, name):
            continue
        instr = [ln for ln in func.splitlines()
                 if re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln)]
        tensor = [i for i, ln in enumerate(instr)
                  if re.search(SASS_CLASSES["tensor (HMMA/HGMMA)"], ln)]
        span = instr[tensor[0]:tensor[-1] + 1] if tensor else []
        lib.with_suffix(".sass").write_text(func)
        out = {"function": name, "instructions": len(instr),
               "loop span": len(span)}
        for cls, rx in SASS_CLASSES.items():
            out[cls] = sum(bool(re.search(rx, ln)) for ln in instr)
            out[f"{cls} in span"] = sum(bool(re.search(rx, ln))
                                        for ln in span)
        return out
    return None


def bind(lib_path, old_abi):
    lib = ctypes.CDLL(str(lib_path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    quad = [vp, i, i, i, ctypes.c_double, vp, vp, vp, vp, i, i, i, vp]
    if old_abi:
        lib.tabcorr_slab_tc.argtypes = (quad + [ctypes.c_longlong] +
                                        [vp] * 5 + [i] * 6 + [vp, vp, i, vp])
    else:
        lib.tabcorr_slab_tc.argtypes = (quad + [i] + [vp] * 4 + [i] * 6 +
                                        [vp, vp, i, vp])
    lib.tabcorr_slab_tc.restype = i
    lib.tabcorr_cuda_error_string.argtypes = [i]
    lib.tabcorr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launcher(lib, old_abi, consts, pmat, hod, config=None):
    """A function that launches the library's slab_tc once and returns
    (total, xi)."""
    def run():
        if old_abi:
            args, outs = fused._slab_entry_args(consts, pmat, hod, (64, 1),
                                                "slab_tc")
        else:
            outs = (torch.empty(pmat.shape[0], device="cuda"),
                    torch.empty((pmat.shape[0], consts.n_nodes,
                                 consts.n_xi), device="cuda"))
            s = consts
            args = (pmat.data_ptr(), pmat.shape[0], *hod.launch_args(),
                    s.logm.data_ptr(), s.logm_res.data_ptr(),
                    s.sec.data_ptr(), s.weight.data_ptr(), s.n_bins,
                    s.n_centrals, s.n_gauss, s.b.data_ptr(), s.node_steps,
                    *(a.data_ptr() for a in (s.ct_step0, s.ct_steps,
                                             s.col_k, s.col_i0)),
                    s.n_ct, s.n_nodes, s.n_xi, int(s.auto), *config,
                    outs[0].data_ptr(), outs[1].data_ptr(),
                    *fused._stream_args(pmat.device))
        code = lib.tabcorr_slab_tc(*args)
        if code:
            raise RuntimeError(lib.tabcorr_cuda_error_string(code).decode())
        return outs
    return run


def window_ms(fn, n_iter=3):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def errors(got, want, n_xi):
    total, xi = got
    ngal = float(((total.double() - want[0].double()).abs() /
                  want[0].double().abs()).max())
    a = xi.double().reshape(-1, n_xi)
    b = want[1].double().reshape(-1, n_xi)
    return ngal, float(((a - b).abs().amax(1) / b.abs().amax(1)).max())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch finds no CUDA device.", file=sys.stderr)
        return 1
    name = card()
    print(f"card (name, power limit): {name}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "tabcorr_tpu_torch" / "csrc"
    jobs = {"wgmma": (csrc, [])}
    for label, patches in CHANGE_PATCHES.items():
        jobs[label] = (patched_copy(csrc, label, patches), [])
    if args.parent is not None:
        parent_csrc = args.parent / "tabcorr_tpu_torch" / "csrc"
        jobs["parent"] = (parent_csrc, [])
        for label, patches in PARENT_PATCHES.items():
            jobs[f"parent {label}"] = (patched_copy(
                parent_csrc, f"parent {label}", patches), [])
    libs = build_all(jobs)
    print(f"built {len(libs)} variants of slab.cu", flush=True)

    summary = {"card": name, "ptxas": {}, "sass": {}, "ms": {},
               "errors": {}}
    for label in [k for k in ("wgmma", "parent") if k in libs]:
        for entry, regs, st, ld in ptxas_report(libs[label]):
            print(f"ptxas ({label}): {entry}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads")
            summary["ptxas"].setdefault(label, []).append(
                [entry, regs, st, ld])
        wgs, _ = fused.slab_tc_config(160, 42)
        mix = sass_mix(libs[label],
                       rf"slab_tc_kernelILi{wgs}ELi1ELb1E"
                       if label == "wgmma" else
                       r"slab_tc_kernelILi64ELb1ELi1E")
        print(f"SASS mix ({label}): {json.dumps(mix)}")
        summary["sass"][label] = mix

    interp = wide_grid_interpolator()
    stacked, n_nodes, _ = stacked_grid(interp, device="cuda")
    model = AssembiasZheng07Model(threshold=-20, redshift=0.0)
    hod = fused.KernelModel.of(model)
    rng = np.random.default_rng(SEED)
    p = model.param_dict
    params = params_batch(model, {
        "logMmin": p["logMmin"] + 0.1 * rng.normal(size=BATCH),
        "sigma_logM": p["sigma_logM"] + 0.01 * rng.normal(size=BATCH),
        "logM0": p["logM0"] + 0.1 * rng.normal(size=BATCH),
        "logM1": p["logM1"] + 0.1 * rng.normal(size=BATCH),
        "alpha": p["alpha"] + 0.02 * rng.normal(size=BATCH),
        **{k: rng.uniform(-1, 1, BATCH) for k in p if "assembias" in k}},
        (BATCH,), device="cuda")
    pmat = torch.stack([params[k] for k in hod.param_names], dim=1)
    plain = fused.slab_table_constants(stacked, n_nodes)
    want = fused.slab_predict_plain(plain, params,
                                    *occupation_functions(model))
    split = fused.slab_split_table_constants(stacked, n_nodes)
    default = fused.slab_tc_config(split.n_bins, split.n_xi)
    wgs, stages = default
    runs = {}
    for label in libs:
        if label.startswith("parent"):
            continue
        lib = bind(libs[label], old_abi=False)
        configs = {label: default}
        if label == "wgmma":
            configs = {f"wgmma {c}": c for c in (
                default, (wgs, 8), (wgs, 15), (1, stages))}
        for key, config in configs.items():
            runs[key] = launcher(lib, False, split, pmat, hod, config)
    if args.parent is not None:
        half = fused.slab_tc_table_constants(stacked, n_nodes)
        for label in libs:
            if label.startswith("parent"):
                runs[label] = launcher(bind(libs[label], old_abi=True), True,
                                       half, pmat, hod)
    for key, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        if not any(a in key for a in ABLATIONS):
            summary["errors"][key] = errors(got, want, split.n_xi)
            print(f"{key}: ngal max rel {summary['errors'][key][0]:.3e}, "
                  f"per-node xi max scaled {summary['errors'][key][1]:.3e}",
                  flush=True)
        del got
    del want

    # Times, in turns: parent, change, change, parent (the other variants
    # between).
    base = f"wgmma {default}"
    order = ([k for k in runs if k.startswith("parent")] +
             [k for k in runs if not k.startswith("parent")])
    times = {k: [] for k in runs}
    for _ in range(args.rounds):
        for key in order:
            times[key].append(window_ms(runs[key]))
        for key in reversed(order):
            times[key].append(window_ms(runs[key]))
    for key in order:
        ms = float(np.median(times[key]))
        summary["ms"][key] = [ms, times[key]]
        print(f"{key}: {ms:.4f} ms per {BATCH}-vector batch (windows "
              f"{[round(t, 4) for t in times[key]]}) on {name}", flush=True)
    if "parent" in times:
        print(f"wgmma {default} against parent: "
              f"{np.median(times[base]):.4f} / {np.median(times['parent']):.4f}"
              f" ms on {name}")
    (OUT / "slab_probe.json").write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
